"""Fused on-policy collect: policy step, env step and the rollout's records,
on the device, with no host round trip.

Counterpart of ``sheeprl_tpu/envs/jax/collect.py:FusedOnPolicyCollector``.
The JAX package compiles a rollout of ``algo.rollout_steps`` steps into one
``lax.scan``; here the same T steps are eager torch operations on the
runtime's device, launched back to back without a synchronisation:

- the policy samples from the current obs (the agent the update trains, in
  place, so there is no weight transfer);
- ``core.vector_step`` steps all N envs, auto-reset folded in;
- the truncation bootstrap adds ``gamma * V(final_obs)`` to the reward of
  every env that truncated.  The JAX package values the substituted batch
  only on steps where some env truncated (a ``lax.cond``); here the critic
  runs on every step and its value is multiplied by the 0/1 truncation
  mask, which gives the same rewards without a host-side test each step;
- rewards are clipped (``env.clip_rewards``), and the records stack into
  the (T, N, ...) layout the update reads.

The rollout's noise (each step's policy noise and each step's reset draws)
is drawn at its start from the run's generator, or supplied by the caller
(:meth:`FusedOnPolicyCollector.rollout`): that is how the tests feed the
JAX package's draws and how ``chip_smoke.py`` runs the same rollout on the
card and on the CPU.

Episode events (done, return, length) reach the host at the
``metric.fetch_every`` cadence, one copy a fetched rollout, with
``metric.log_level`` above 0.

:class:`FusedRecurrentCollector` is recurrent PPO's (counterpart of
``collect.py:FusedRecurrentCollector``): the carry also threads the LSTM's
``hx``, ``cx`` and the previous actions; each step records the state the
policy acted from (``prev_hx``, ``prev_cx``, ``prev_actions``); the
truncation bootstrap values the final obs with the state after the action
and the actions just taken (masked, as above); the state is zeroed where an
env is done (``algo.reset_recurrent_state_on_done``); and the rollout ends
with the bootstrap ``next_values`` of the last obs.  It draws its noise as
:class:`FusedOnPolicyCollector` does.

:func:`policy_env_step` is the one policy-and-env step that the rollout
and the greedy test episode (``algos/ppo/utils.py:test``) both take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.ppo.agent import draw_policy_noise, get_values, sample_actions
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs
from sheeprl_tpu_torch.algos.ppo_recurrent import agent as rnn_agent
from sheeprl_tpu_torch.envs.device.core import tree_select, vector_reset, vector_step
from sheeprl_tpu_torch.utils.utils import MetricFetchGate

__all__ = ["FusedOnPolicyCollector", "FusedRecurrentCollector", "RolloutNoise", "RolloutPayload", "policy_env_step"]

#: {"policy": [(T, N, width) per head], "reset": {leaf: (T, N, ...)}}
RolloutNoise = Dict[str, Any]


@dataclass
class RolloutPayload:
    """One collected iteration (counterpart of
    ``sheeprl_tpu/parallel/pipeline.py:RolloutPayload``): ``data``, the
    (T, N, ...) records, and ``next_obs`` on the device, and the
    iteration's last policy step; the recurrent collect also gives the
    bootstrap ``next_values`` (N, 1)."""

    iter_num: int
    data: Dict[str, torch.Tensor]
    next_obs: Dict[str, torch.Tensor]
    policy_step_end: int
    next_values: Optional[torch.Tensor] = None


def tree_to(tree: Any, device) -> Any:
    """Every leaf of a nested dict as a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def policy_env_step(
    agent,
    env,
    carry: Dict[str, Any],
    obs: Dict[str, torch.Tensor],
    max_episode_steps: Optional[int],
    *,
    policy_noise: Optional[List[torch.Tensor]] = None,
    reset_noise: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
):
    """The policy acts on ``obs`` (normalised) and every env of ``carry``
    takes its action (``core.vector_step``, auto-reset folded in).  Noise is
    supplied or drawn from ``generator``.  Returns ``(carry, out, actions,
    logprobs, values)``, ``out`` as ``vector_step`` gives it and
    ``actions`` the flat (N, width) actions the update reads."""
    flat, real, logprobs, values = sample_actions(agent, obs, policy_noise, generator=generator, greedy=greedy)
    act = flat if agent.is_continuous else real[..., 0]
    carry, out = vector_step(env, carry, act, max_episode_steps, reset_noise=reset_noise, generator=generator)
    return carry, out, flat, logprobs, values


class FusedOnPolicyCollector:
    """The fused collect of PPO and A2C: ``collect(iter_num)`` gives the
    :class:`RolloutPayload` the update reads."""

    def __init__(
        self,
        *,
        envs,
        agent,
        cfg: Any,
        runtime,
        obs_keys: Sequence[str],
        total_envs: int,
        aggregator: Any = None,
        policy_step: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        self.env = envs.env
        self.agent = agent
        self.cfg = cfg
        self.runtime = runtime
        self.device = runtime.device
        self.obs_keys = list(obs_keys)
        self.cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
        self.total_envs = int(total_envs)
        self.aggregator = aggregator
        self.policy_step = int(policy_step)
        self.max_episode_steps = envs.max_episode_steps
        self.rollout_steps = int(cfg.algo.rollout_steps)
        self.gamma = float(cfg.algo.gamma)
        self.clip_rewards = bool(cfg.env.clip_rewards)
        self.generator = runtime.generator if generator is None else generator
        self.carry = vector_reset(self.env, self.total_envs, generator=self.generator, device=self.device)
        self._event_gate = MetricFetchGate(cfg.metric.get("fetch_every", 1))
        self._log_events = int(cfg.metric.get("log_level", 1)) > 0

    def draw_noise(self, generator: Optional[torch.Generator] = None, device=None) -> RolloutNoise:
        """One rollout's noise: the policy's draws, then the envs' reset draws
        (every env draws a reset every step; the done ones take it)."""
        g = self.generator if generator is None else generator
        dev = self.device if device is None else device
        t, n = self.rollout_steps, self.total_envs
        policy = draw_policy_noise(self.agent, (t, n), g, dev)
        reset = {k: v.reshape(t, n, *v.shape[1:]) for k, v in self.env.reset_noise(t * n, g, dev).items()}
        return {"policy": policy, "reset": reset}

    def _norm(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return normalize_obs({k: obs[k].to(torch.float32) for k in self.obs_keys}, self.cnn_keys, self.obs_keys)

    @torch.no_grad()
    def rollout(self, carry: Dict[str, Any], noise: RolloutNoise):
        """T steps from ``carry``: ``(carry, data, events)``, ``data`` the
        (T, N, ...) records (the obs keys, ``dones``, ``values``,
        ``actions``, ``logprobs``, ``rewards``) and ``events`` the (T, N)
        ``done``, ``ep_return`` and ``ep_length``."""
        agent, env = self.agent, self.env
        max_steps = self.max_episode_steps
        records: Dict[str, List[torch.Tensor]] = {}
        events: Dict[str, List[torch.Tensor]] = {"done": [], "ep_return": [], "ep_length": []}
        for t in range(self.rollout_steps):
            obs = carry["obs"]
            carry, out, flat, logprobs, values = policy_env_step(
                agent, env, carry, self._norm(obs), max_steps,
                policy_noise=[p[t] for p in noise["policy"]],
                reset_noise={k: v[t] for k, v in noise["reset"].items()},
            )
            rewards = out["reward"][:, None]
            if max_steps:
                real_next = tree_select(out["truncated"], out["final_obs"], out["obs"])
                vals = get_values(agent, self._norm(real_next))
                rewards = rewards + self.gamma * vals * out["truncated"][:, None].to(torch.float32)
            if self.clip_rewards:
                rewards = torch.tanh(rewards)
            rec = {k: obs[k].to(torch.float32) for k in self.obs_keys}
            rec.update(
                dones=out["done"][:, None].to(torch.float32),
                values=values.to(torch.float32),
                actions=flat.to(torch.float32),
                logprobs=logprobs.to(torch.float32),
                rewards=rewards.to(torch.float32),
            )
            for k, v in rec.items():
                records.setdefault(k, []).append(v)
            for k in events:
                events[k].append(out[k])
        data = {k: torch.stack(v, 0) for k, v in records.items()}
        return carry, data, {k: torch.stack(v, 0) for k, v in events.items()}

    def _apply_events(self, events: Dict[str, torch.Tensor], step_start: int) -> None:
        """Episode events to the aggregator and the log, at the fetch cadence."""
        if not self._log_events or self.aggregator is None or not self._event_gate():
            return
        host = torch.stack([events["done"].to(torch.float32), events["ep_return"], events["ep_length"].to(torch.float32)]).cpu()
        done, ep_ret, ep_len = host[0].bool(), host[1], host[2]
        for t, i in done.nonzero().tolist():
            ep_rew = float(ep_ret[t, i])
            if "Rewards/rew_avg" in self.aggregator:
                self.aggregator.update("Rewards/rew_avg", ep_rew)
            if "Game/ep_len_avg" in self.aggregator:
                self.aggregator.update("Game/ep_len_avg", float(ep_len[t, i]))
            self.runtime.print(f"Rank-0: policy_step={step_start + (t + 1) * self.total_envs}, reward_env_{i}={ep_rew}")

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint keeps of the collect: the envs' state."""
        return {"env": self.carry}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Resume from a checkpoint's :meth:`state_dict` keys, where it has them."""
        if "env" in state:
            self.carry = tree_to(state["env"], self.device)

    @staticmethod
    def _interaction_timer():
        from sheeprl_tpu_torch.utils.metric import SumMetric
        from sheeprl_tpu_torch.utils.timer import timer

        return timer("Time/env_interaction_time", SumMetric, sync_on_compute=False)

    def _payload(self, iter_num: int, data, events, obs, next_values=None) -> RolloutPayload:
        """Count the rollout's policy steps, report its episodes and wrap it
        with the last ``obs``."""
        step_start = self.policy_step
        self.policy_step += self.rollout_steps * self.total_envs
        self._apply_events(events, step_start)
        return RolloutPayload(iter_num, data, {k: obs[k] for k in self.obs_keys}, self.policy_step, next_values)

    def collect(self, iter_num: int) -> RolloutPayload:
        with self._interaction_timer():
            self.carry, data, events = self.rollout(self.carry, self.draw_noise())
        return self._payload(iter_num, data, events, self.carry["obs"])


_RECURRENT = ("hx", "cx", "prev_actions")


class FusedRecurrentCollector(FusedOnPolicyCollector):
    """The fused collect of recurrent PPO (module docstring): its carry is
    ``{"vstate": the envs' state, "hx", "cx": (N, H), "prev_actions": (N,
    sum(actions_dim))}``, and :meth:`rollout` also returns the bootstrap
    ``next_values``."""

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self.reset_on_done = bool(self.cfg.algo.reset_recurrent_state_on_done)
        widths = {"hx": self.agent.rnn_hidden_size, "cx": self.agent.rnn_hidden_size,
                  "prev_actions": sum(self.agent.actions_dim)}
        self.carry = {"vstate": self.carry, **{k: torch.zeros((self.total_envs, w), device=self.device)
                                               for k, w in widths.items()}}

    def _norm(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The (T = 1, N, ...) layout the recurrent agent reads."""
        return {k: v[None] for k, v in super()._norm(obs).items()}

    def state_dict(self) -> Dict[str, Any]:
        """The envs' state, and beside it the recurrent carry (the JAX
        package restarts the carry from zeros on resume)."""
        return {"env": self.carry["vstate"], "recurrent": {k: self.carry[k] for k in _RECURRENT}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if "env" in state:
            self.carry = {**self.carry, "vstate": tree_to(state["env"], self.device)}
        if "recurrent" in state:
            self.carry = {**self.carry, **tree_to(state["recurrent"], self.device)}

    @torch.no_grad()
    def rollout(self, carry: Dict[str, Any], noise: RolloutNoise):
        """T steps from ``carry``: ``(carry, data, events, next_values)``,
        ``data`` the (T, N, ...) records of :class:`FusedOnPolicyCollector`
        plus ``prev_hx``, ``prev_cx`` and ``prev_actions``."""
        agent, env = self.agent, self.env
        max_steps = self.max_episode_steps
        records: Dict[str, List[torch.Tensor]] = {}
        events: Dict[str, List[torch.Tensor]] = {"done": [], "ep_return": [], "ep_length": []}
        vstate, hx, cx, prev_actions = carry["vstate"], carry["hx"], carry["cx"], carry["prev_actions"]
        for t in range(self.rollout_steps):
            obs = vstate["obs"]
            prev_hx, prev_cx, prev_act = hx, cx, prev_actions
            flat, real, logprobs, values, (hx, cx) = rnn_agent.sample_actions(
                agent, self._norm(obs), prev_act[None], prev_hx, prev_cx, [p[t] for p in noise["policy"]]
            )
            flat = flat[0]
            act = flat if agent.is_continuous else real[0, :, 0]
            vstate, out = vector_step(env, vstate, act, max_steps, reset_noise={k: v[t] for k, v in noise["reset"].items()})
            rewards = out["reward"][:, None]
            if max_steps:
                real_next = tree_select(out["truncated"], out["final_obs"], out["obs"])
                vals = rnn_agent.get_values(agent, self._norm(real_next), flat[None], hx, cx)[0]
                rewards = rewards + self.gamma * vals * out["truncated"][:, None].to(torch.float32)
            if self.clip_rewards:
                rewards = torch.tanh(rewards)
            prev_actions = flat
            if self.reset_on_done:
                keep = 1.0 - out["done"][:, None].to(torch.float32)
                hx, cx, prev_actions = hx * keep, cx * keep, prev_actions * keep
            rec = {k: obs[k].to(torch.float32) for k in self.obs_keys}
            rec.update(
                dones=out["done"][:, None].to(torch.float32),
                values=values[0].to(torch.float32),
                actions=flat.to(torch.float32),
                logprobs=logprobs[0].to(torch.float32),
                rewards=rewards.to(torch.float32),
                prev_hx=prev_hx,
                prev_cx=prev_cx,
                prev_actions=prev_act,
            )
            for k, v in rec.items():
                records.setdefault(k, []).append(v)
            for k in events:
                events[k].append(out[k])
        next_values = rnn_agent.get_values(agent, self._norm(vstate["obs"]), prev_actions[None], hx, cx)[0]
        data = {k: torch.stack(v, 0) for k, v in records.items()}
        carry = {"vstate": vstate, "hx": hx, "cx": cx, "prev_actions": prev_actions}
        return carry, data, {k: torch.stack(v, 0) for k, v in events.items()}, next_values

    def collect(self, iter_num: int) -> RolloutPayload:
        with self._interaction_timer():
            self.carry, data, events, next_values = self.rollout(self.carry, self.draw_noise())
        return self._payload(iter_num, data, events, self.carry["vstate"]["obs"], next_values)

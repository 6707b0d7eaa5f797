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
``metric.log_level`` above 0.  ``FusedRecurrentCollector`` waits for
PPO-recurrent (ROADMAP A1's remainder).

:func:`policy_env_step` is the one policy-and-env step that the rollout
and the greedy test episode (``algos/ppo/utils.py:test``) both take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.ppo.agent import draw_policy_noise, get_values, sample_actions
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs
from sheeprl_tpu_torch.envs.device.core import tree_select, vector_reset, vector_step
from sheeprl_tpu_torch.utils.utils import MetricFetchGate

__all__ = ["FusedOnPolicyCollector", "RolloutNoise", "RolloutPayload", "policy_env_step"]

#: {"policy": [(T, N, width) per head], "reset": {leaf: (T, N, ...)}}
RolloutNoise = Dict[str, Any]


@dataclass
class RolloutPayload:
    """One collected iteration (counterpart of
    ``sheeprl_tpu/parallel/pipeline.py:RolloutPayload``): ``data``, the
    (T, N, ...) records, and ``next_obs`` on the device, and the
    iteration's last policy step."""

    iter_num: int
    data: Dict[str, torch.Tensor]
    next_obs: Dict[str, torch.Tensor]
    policy_step_end: int


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

    def collect(self, iter_num: int) -> RolloutPayload:
        from sheeprl_tpu_torch.utils.metric import SumMetric
        from sheeprl_tpu_torch.utils.timer import timer

        step_start = self.policy_step
        with timer("Time/env_interaction_time", SumMetric, sync_on_compute=False):
            self.carry, data, events = self.rollout(self.carry, self.draw_noise())
        self.policy_step += self.rollout_steps * self.total_envs
        self._apply_events(events, step_start)
        next_obs = {k: self.carry["obs"][k] for k in self.obs_keys}
        return RolloutPayload(iter_num, data, next_obs, self.policy_step)

"""SAC gradient dispatches (counterpart of the training half of
``sheeprl_tpu/algos/sac/sac.py``).

:func:`make_train_fn` builds the train function of ``make_train_fn``
(``sac.py:65-232``, the single-device core): G gradient steps over a
(G, B, ...) batch, each one

1. the critic update against the target ``r + (1 - d) gamma (min_i Q'_i(s', a') - alpha log pi(a'|s'))``
   (with prioritized replay each sample's squared error is scaled by its IS
   weight, and the step's |delta| comes back for the priorities);
2. the target critic's EMA, under that step's flag;
3. the actor update against the *updated* critic;
4. the alpha update on the actor's log-probs, their gradient stopped;

with one Adam per component (``build_optimizer``).  ``Grads/agent`` is the
global norm of the three raw gradients; the losses are averaged over G.
Parameters and optimizer states are updated in place.

:func:`train_dispatch` is the training block of ``main`` (``sac.py:492-577``):
flush the rows the env loop held back into the device cache, draw G
batches (prioritized or uniform), cast them to f32, run the train function,
and feed the TD errors back into the priorities.

Randomness: a train function call draws its standard-normal noise
(G, 2, B, A) up front from a ``torch.Generator`` (``[:, 0]`` for the next
actions, ``[:, 1]`` for the actor loss), or takes it pre-drawn.

Not ported yet: the env loop around the dispatch, the samples-per-insert
rate limiter (``buffer.rate_limiter``), the training-health sentinel
(``guard_update``, off by default), the multi-device core (``dp_axes``),
``bf16-true``, checkpoints and ``test``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import SACAgent, actor_action_and_log_prob
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, critic_loss_weighted, entropy_loss, policy_loss, td_error_abs
from sheeprl_tpu_torch.optim import Adam, AdamState, build_optimizer, global_norm
from sheeprl_tpu_torch.utils.utils import ema_, grads_or_zeros, trainable_params

__all__ = ["SACTrainState", "make_train_fn", "make_train_state", "train_dispatch"]

OBS_KEYS = ("observations",)


def make_train_fn(runtime, agent: SACAgent, txs: Dict[str, Adam], cfg, target_entropy: float, prioritized: bool = False):
    """``train(opt_states, data, do_ema, noise=None, generator=None)`` ->
    ``(opt_states, metrics)``, and ``td_abs`` (G, B) third when
    ``prioritized``.  ``data`` holds (G, B, ...) f32 tensors on the agent's
    device (``is_weights`` (G, B, 1) when ``prioritized``), ``do_ema`` G host
    booleans; ``metrics`` are 0-d tensors (nothing is copied to the host)."""
    gamma = float(cfg.algo.gamma)
    tau = float(cfg.algo.tau)
    num_critics = int(cfg.algo.critic.n)
    actor, critic, target_critic = agent.actor, agent.critic, agent.target_critic
    actor_params, critic_params = trainable_params(actor), trainable_params(critic)
    alpha_params = {"log_alpha": agent.log_alpha}

    def train(opt_states: Dict[str, AdamState], data: Dict[str, torch.Tensor], do_ema: Sequence[bool], noise=None, generator=None):
        g, b = data["rewards"].shape[:2]
        if len(do_ema) != g:
            raise ValueError(f"{len(do_ema)} EMA flags for {g} gradient steps")
        if noise is None:
            noise = torch.randn((g, 2, b, actor.action_dim), generator=generator, device=data["rewards"].device)
        losses, tds = [], []
        for step in range(g):
            batch = {k: v[step] for k, v in data.items()}
            alpha = agent.log_alpha.detach().exp()

            # critic update (Eq. 5)
            with torch.no_grad():
                next_actions, next_logp = actor_action_and_log_prob(actor, batch["next_observations"], noise[step, 0])
                qf_next = target_critic(batch["next_observations"], next_actions)
                min_qf_next = qf_next.min(-1, keepdim=True).values - alpha * next_logp
                next_qf_value = batch["rewards"] + (1 - batch["terminated"]) * gamma * min_qf_next
            qf_values = critic(batch["observations"], batch["actions"])
            if prioritized:
                qf_loss = critic_loss_weighted(qf_values, next_qf_value, num_critics, batch["is_weights"])
                tds.append(td_error_abs(qf_values.detach(), next_qf_value))
            else:
                qf_loss = critic_loss(qf_values, next_qf_value, num_critics)
            qf_grads = grads_or_zeros(qf_loss, critic_params)
            txs["critic"].update(critic_params, qf_grads, opt_states["critic"])

            # EMA target
            if do_ema[step]:
                ema_(target_critic, critic, tau)

            # actor update (Eq. 7), against the updated critic
            actions, logp = actor_action_and_log_prob(actor, batch["observations"], noise[step, 1])
            q = critic(batch["observations"], actions)
            actor_loss = policy_loss(alpha, logp, q.min(-1, keepdim=True).values)
            actor_grads = grads_or_zeros(actor_loss, actor_params)
            txs["actor"].update(actor_params, actor_grads, opt_states["actor"])

            # alpha update (Eq. 17)
            alpha_loss = entropy_loss(agent.log_alpha, logp, target_entropy)
            alpha_grads = grads_or_zeros(alpha_loss, alpha_params)
            txs["alpha"].update(alpha_params, alpha_grads, opt_states["alpha"])

            grad_norm = global_norm([*qf_grads.values(), *actor_grads.values(), *alpha_grads.values()])
            losses.append(torch.stack([qf_loss.detach(), actor_loss.detach(), alpha_loss.detach(), grad_norm]))
        mean = torch.stack(losses).mean(0)
        metrics = {
            "Loss/value_loss": mean[0],
            "Loss/policy_loss": mean[1],
            "Loss/alpha_loss": mean[2],
            "Grads/agent": mean[3],
        }
        if prioritized:
            return opt_states, metrics, torch.stack(tds)
        return opt_states, metrics

    return train


@dataclass
class SACTrainState:
    """What ``main`` carries between dispatches."""

    agent: SACAgent
    txs: Dict[str, Adam]
    opt_states: Dict[str, AdamState]
    train_fn: Callable
    prioritized: bool
    runtime: Any  # the mesh: its world size scales the batch; host-fed batches are split over it
    gradient_steps: int = 0  # cumulative_per_rank_gradient_steps


def make_train_state(runtime, agent: SACAgent, cfg, target_entropy: float, prioritized: bool = False) -> SACTrainState:
    """An Adam per component (``_make_optimizer``), their states and the train function."""
    txs = {name: build_optimizer(cfg.algo[name].optimizer, None, runtime.precision) for name in ("actor", "critic", "alpha")}
    opt_states = {
        "actor": txs["actor"].init(trainable_params(agent.actor)),
        "critic": txs["critic"].init(trainable_params(agent.critic)),
        "alpha": txs["alpha"].init({"log_alpha": agent.log_alpha}),
    }
    train_fn = make_train_fn(runtime, agent, txs, cfg, target_entropy, prioritized)
    return SACTrainState(agent, txs, opt_states, train_fn, bool(prioritized), runtime)


def train_dispatch(
    state: SACTrainState,
    rb,
    device_cache,
    cfg,
    ema_flags: Sequence[bool],
    policy_step: int,
    beta_fn: Callable[[int], float],
    pending_rows: Optional[List[Dict[str, np.ndarray]]] = None,
    generator: Optional[torch.Generator] = None,
    *,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One dispatch of ``len(ema_flags)`` gradient steps (``sac.py:492-577``).

    ``pending_rows`` are the env steps' rows not yet in the cache (emptied
    here by one windowed add).  The batch comes from the cache when it can
    sample (``sample_transitions_per`` with ``beta_fn(policy_step)`` when
    prioritized, else ``sample_transitions``), else from ``rb`` on the host
    (unit IS weights when prioritized).  ``draws`` optionally gives the
    draw's uniforms (``r01``, or ``envs`` and ``u``), ``noise`` the train
    function's.  Returns the dispatch's metrics.

    On a mesh of several shards the cache is the env-sharded one: its draw
    comes back whole (prioritized) or in shard order (uniform), the train
    function runs once on the whole batch, which is the arithmetic of JAX's
    data-parallel step up to the order of its reductions, and the TD errors
    go to the shards' sub-trees.  A gradient step takes
    ``per_rank_batch_size`` rows for each shard, as JAX's ``main`` scales the
    batch by the world size (``sac.py:479``); its env loop, which also runs
    ``env.num_envs`` envs per shard, is not ported."""
    g = len(ema_flags)
    batch_unit = int(cfg.algo.per_rank_batch_size) * state.runtime.world_size
    sample_next_obs = bool(cfg.buffer.sample_next_obs)
    device = state.agent.log_alpha.device
    draws = draws or {}
    if device_cache is not None and pending_rows:
        device_cache.add({k: np.concatenate([r[k] for r in pending_rows], axis=0) for k in pending_rows[0]})
        pending_rows.clear()
    sample_idx = None
    if device_cache is not None and device_cache.can_sample_transitions(sample_next_obs):
        if state.prioritized:
            sampled, sample_idx = device_cache.sample_transitions_per(
                g, batch_unit, generator, beta_fn(policy_step), sample_next_obs=sample_next_obs, obs_keys=OBS_KEYS,
                r01=draws.get("r01"),
            )
        else:
            sampled = device_cache.sample_transitions(
                g, batch_unit, generator, sample_next_obs=sample_next_obs, obs_keys=OBS_KEYS,
                envs=draws.get("envs"), u=draws.get("u"),
            )
        data = {k: v.float() for k, v in sampled.items()}
    else:
        sample = rb.sample(batch_size=g * batch_unit, sample_next_obs=sample_next_obs)
        data = {
            k: torch.from_numpy(np.asarray(v, dtype=np.float32).reshape(g, batch_unit, *v.shape[2:])).to(device)
            for k, v in sample.items()
        }
        if state.prioritized:
            data["is_weights"] = torch.ones((g, batch_unit, 1), device=device)
        data = state.runtime.shard_batch(data, axis=1)
    out = state.train_fn(state.opt_states, data, [bool(f) for f in ema_flags], noise=noise, generator=generator)
    state.opt_states, metrics = out[0], out[1]
    if sample_idx is not None:
        device_cache.update_priorities(sample_idx, out[2])
    state.gradient_steps += g
    return metrics

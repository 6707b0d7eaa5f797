"""DroQ gradient dispatches and env loop (counterpart of
``sheeprl_tpu/algos/droq/droq.py``; arXiv:2110.02034).

:func:`make_train_fn` builds the train function of ``make_train_fn``
(``droq.py:46-184``, the single-device core): G critic steps over a
(G, B, ...) batch, each one

1. the critic update against the target ``r + (1 - d) gamma (min_i Q'_i(s', a') - alpha log pi(a'|s'))``,
   the target critic deterministic and the online critic under dropout
   (with prioritized replay each sample's squared error is scaled by its IS
   weight, and the step's |delta| comes back for the priorities);
2. the target critic's EMA after every step;

then one actor step on a separate batch against the *mean* of the updated
critics' Q under dropout, and one alpha step on the actor's log-probs.
``Grads/agent`` is the global norm of the actor's and alpha's gradients;
``Loss/value_loss`` the mean over the G critic steps.  Parameters and
optimizer states are updated in place.

Randomness: a call draws its noise up front from a ``torch.Generator``, or
takes it pre-drawn (``noise=``): ``next`` (G, B, A) standard normals for the
next actions, ``critic_masks`` (G, L, N, B, hidden) dropout keep masks of
the online critic, ``actor`` (B, A) and ``actor_masks`` (L, N, B, hidden)
for the actor's loss; the masks are None at dropout 0.

:func:`train_dispatch` is the training block of ``main`` (``droq.py:380-443``):
the critic's G batches (``sample_transitions_per`` when prioritized, else
``sample_transitions``), the actor's one uniform batch, the train function,
and the TD errors into the priorities.  :func:`main` runs SAC's env loop
(``algos/sac/sac.py:run_off_policy``) with DroQ's agent and dispatch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac.agent import SACAgent, actor_action_and_log_prob
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, critic_loss_weighted, entropy_loss, policy_loss, td_error_abs
from sheeprl_tpu_torch.algos.sac.sac import OBS_KEYS, OffPolicyFamily, SACTrainState, run_off_policy, sac_opt_groups, sac_player
from sheeprl_tpu_torch.algos.sac.sac import make_train_state as sac_make_train_state
from sheeprl_tpu_torch.algos.sac.utils import test
from sheeprl_tpu_torch.optim import Adam, AdamState, global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import ema_, grads_or_zeros, trainable_params

__all__ = ["DROQ_FAMILY", "draw_noise", "main", "make_train_fn", "make_train_state", "train_dispatch"]


def draw_noise(agent: SACAgent, g: int, b: int, device, generator=None) -> Dict[str, Optional[torch.Tensor]]:
    """Every draw of one train call (module docstring)."""
    critic = agent.critic
    a = agent.actor.action_dim
    mask_shape = (critic.hidden_layers, critic.num_critics, b, critic.hidden_size)
    keep = 1.0 - critic.rate

    def masks(*lead):
        if not critic.rate:
            return None
        return torch.rand((*lead, *mask_shape), generator=generator, device=device) < keep

    return {
        "next": torch.randn((g, b, a), generator=generator, device=device),
        "critic_masks": masks(g),
        "actor": torch.randn((b, a), generator=generator, device=device),
        "actor_masks": masks(),
    }


def make_train_fn(runtime, agent: SACAgent, txs: Dict[str, Adam], cfg, target_entropy: float, prioritized: bool = False):
    """``train(opt_states, critic_data, actor_data, noise=None, generator=None)``
    -> ``(opt_states, metrics)``, and ``td_abs`` (G, B) third when
    ``prioritized``.  ``critic_data`` holds (G, B, ...) f32 tensors on the
    agent's device (``is_weights`` (G, B, 1) when ``prioritized``),
    ``actor_data`` (B, ...); ``metrics`` are 0-d tensors."""
    gamma = float(cfg.algo.gamma)
    tau = float(cfg.algo.tau)
    num_critics = int(cfg.algo.critic.n)
    actor, critic, target_critic = agent.actor, agent.critic, agent.target_critic
    actor_params, critic_params = trainable_params(actor), trainable_params(critic)
    alpha_params = {"log_alpha": agent.log_alpha}

    def train(opt_states: Dict[str, AdamState], critic_data: Dict[str, torch.Tensor],
              actor_data: Dict[str, torch.Tensor], noise=None, generator=None):
        g, b = critic_data["rewards"].shape[:2]
        if noise is None:
            noise = draw_noise(agent, g, b, critic_data["rewards"].device, generator)
        critic_masks = noise["critic_masks"]
        alpha = agent.log_alpha.detach().exp()
        qf_losses, tds = [], []
        for step in range(g):
            batch = {k: v[step] for k, v in critic_data.items()}
            with torch.no_grad():
                next_actions, next_logp = actor_action_and_log_prob(actor, batch["next_observations"], noise["next"][step])
                qf_next = target_critic(batch["next_observations"], next_actions)
                min_qf_next = qf_next.min(-1, keepdim=True).values - alpha * next_logp
                target = batch["rewards"] + (1 - batch["terminated"]) * gamma * min_qf_next
            q = critic(batch["observations"], batch["actions"], masks=None if critic_masks is None else critic_masks[step])
            if prioritized:
                qf_loss = critic_loss_weighted(q, target, num_critics, batch["is_weights"])
                tds.append(td_error_abs(q.detach(), target))
            else:
                qf_loss = critic_loss(q, target, num_critics)
            qf_grads = grads_or_zeros(qf_loss, critic_params)
            txs["critic"].update(critic_params, qf_grads, opt_states["critic"])
            ema_(target_critic, critic, tau)
            qf_losses.append(qf_loss.detach())

        # one actor step on its own batch, against the critics' mean Q under dropout
        actions, logp = actor_action_and_log_prob(actor, actor_data["observations"], noise["actor"])
        q = critic(actor_data["observations"], actions, masks=noise["actor_masks"])
        actor_loss = policy_loss(alpha, logp, q.mean(-1, keepdim=True))
        actor_grads = grads_or_zeros(actor_loss, actor_params)
        txs["actor"].update(actor_params, actor_grads, opt_states["actor"])

        alpha_loss = entropy_loss(agent.log_alpha, logp, target_entropy)
        alpha_grads = grads_or_zeros(alpha_loss, alpha_params)
        txs["alpha"].update(alpha_params, alpha_grads, opt_states["alpha"])

        metrics = {
            "Loss/value_loss": torch.stack(qf_losses).mean(),
            "Loss/policy_loss": actor_loss.detach(),
            "Loss/alpha_loss": alpha_loss.detach(),
            "Grads/agent": global_norm([*actor_grads.values(), *alpha_grads.values()]),
        }
        if prioritized:
            return opt_states, metrics, torch.stack(tds)
        return opt_states, metrics

    return train


def make_train_state(runtime, agent: SACAgent, cfg, target_entropy: float, prioritized: bool = False) -> SACTrainState:
    """SAC's train state (an Adam per component) around DroQ's train function."""
    return sac_make_train_state(runtime, agent, cfg, target_entropy, prioritized, train_fn_factory=make_train_fn)


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
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """One dispatch of ``len(ema_flags)`` critic steps and one actor step
    (``droq.py:380-443``; the EMA follows every critic step, so the flags
    count the steps only).  ``pending_rows`` are flushed into the cache
    first.  Returns the dispatch's metrics."""
    g = len(ema_flags)
    bs = int(cfg.algo.per_rank_batch_size) * state.runtime.world_size
    sample_next_obs = bool(cfg.buffer.sample_next_obs)
    device = state.agent.log_alpha.device
    if device_cache is not None and pending_rows:
        device_cache.add({k: np.concatenate([r[k] for r in pending_rows], axis=0) for k in pending_rows[0]})
        pending_rows.clear()
    sample_idx = None
    if device_cache is not None and device_cache.can_sample_transitions(sample_next_obs):
        if state.prioritized:
            sampled, sample_idx = device_cache.sample_transitions_per(
                g, bs, generator, beta_fn(policy_step), sample_next_obs=sample_next_obs, obs_keys=OBS_KEYS
            )
        else:
            sampled = device_cache.sample_transitions(g, bs, generator, sample_next_obs=sample_next_obs, obs_keys=OBS_KEYS)
        critic_data = {k: v.float() for k, v in sampled.items()}
        actor_sample = device_cache.sample_transitions(1, bs, generator, sample_next_obs=sample_next_obs, obs_keys=OBS_KEYS)
        actor_data = {k: v[0].float() for k, v in actor_sample.items()}
    else:
        def host(n):
            sample = rb.sample(batch_size=n * bs, sample_next_obs=sample_next_obs)
            return {k: torch.from_numpy(np.asarray(v, dtype=np.float32).reshape(n, bs, *v.shape[2:])).to(device)
                    for k, v in sample.items()}

        critic_data = host(g)
        if state.prioritized:
            # the cache cannot sample yet: unweighted, no priorities to update
            critic_data["is_weights"] = torch.ones((g, bs, 1), device=device)
        actor_data = {k: v[0] for k, v in host(1).items()}
        critic_data = state.runtime.shard_batch(critic_data, axis=1)
        actor_data = state.runtime.shard_batch(actor_data, axis=0)
    out = state.train_fn(state.opt_states, critic_data, actor_data, noise=noise, generator=generator)
    state.opt_states, metrics = out[0], out[1]
    if sample_idx is not None:
        device_cache.update_priorities(sample_idx, out[2])
    state.gradient_steps += g
    return metrics


# the dispatch is looked up at each call, so that a caller may wrap the module's train_dispatch
DROQ_FAMILY = OffPolicyFamily("DroQ", build_agent, make_train_state, lambda *a, **k: train_dispatch(*a, **k),
                              sac_player, sac_opt_groups, test, batched=False)


@register_algorithm()
def main(runtime, cfg):
    """DroQ's env loop: SAC's (``run_off_policy``) with DroQ's agent and
    dispatch.  Returns the run's summary."""
    return run_off_policy(runtime, cfg, DROQ_FAMILY)

"""SAC-AE's gradient dispatches and env loop (counterpart of
``sheeprl_tpu/algos/sac_ae/sac_ae.py``; arXiv:1910.01741).

:func:`make_train_fn` builds the train function of ``make_train_fn``
(``sac_ae.py:44-238``): G gradient steps over a (G, B, ...) batch, the
step counter starting at ``counter0`` (the cumulative gradient step,
carried across dispatches), each step

1. the critic update: the encoder and the Q ensemble together, against
   ``r + (1 - d) gamma (min_i Q'_i(s', a') - alpha log pi(a'|s'))`` with the
   target encoder and Q functions;
2. where ``counter % critic.per_rank_target_network_update_freq == 0``, the
   targets' EMA: the encoder at ``encoder.tau``, the Q functions at ``tau``;
3. where ``counter % actor.per_rank_update_freq == 0``, the actor update on
   the freshly updated encoder's features (not differentiated), then alpha's
   on the actor's log-probs;
4. where ``counter % decoder.per_rank_update_freq == 0``, the autoencoder
   update: the reconstruction loss (the images' 5-bit targets with
   dequantisation noise, the vectors as they are) plus ``l2_lambda`` times
   the latent's L2, which steps the encoder with its own Adam state and the
   decoder with AdamW.

Five optimizer states (``critic``, ``actor``, ``alpha``, ``encoder``,
``decoder``, ``sac_ae.py:283-287``); each loss metric is the mean over the
steps on which its branch fired.  Parameters and optimizer states are
updated in place.

Randomness: a call draws its noise up front from a ``torch.Generator``, or
takes it pre-drawn (``noise=``): ``next`` and ``actor`` (G, B, A) standard
normals for the next actions and the actor's loss, and ``pixels`` {image
key: (G, B, H, W, C) uniforms} for the decoder's image targets.

:func:`train_dispatch` is the training block of ``main``
(``sac_ae.py:412-449``): G uniform batches from the device cache
(``sample_transitions``, kernel #4) or from the host buffer, cast to f32,
and the train function.  :func:`main` is the off-policy loop
(``algos/sac/sac.py:run_off_policy``) with SAC-AE's family: each key's rows
as they are, one dispatch an iteration, the player on the critic's encoder.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.sac import OffPolicyFamily, SACTrainState, run_off_policy
from sheeprl_tpu_torch.algos.sac_ae.agent import SACAEAgent, SACAEPlayer, actions_and_log_probs, build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import prepare_obs, preprocess_obs, test
from sheeprl_tpu_torch.optim import build_optimizer
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import ema_, grads_or_zeros, trainable_params

__all__ = ["SAC_AE_FAMILY", "draw_noise", "main", "make_player", "make_train_fn", "make_train_state", "opt_groups",
           "train_dispatch"]


def opt_groups(agent: SACAEAgent) -> Dict[str, torch.nn.Module]:
    """The five optimizer groups and the module each one steps (``alpha``:
    the agent, whose ``log_alpha`` it is)."""
    return {"critic": agent.critic, "actor": agent.actor, "alpha": agent, "encoder": agent.critic.encoder,
            "decoder": agent.decoder}


def draw_noise(cfg, agent: SACAEAgent, data: Dict[str, torch.Tensor], generator=None) -> Dict[str, torch.Tensor]:
    """Every draw of one train call (module docstring)."""
    g, b = data["rewards"].shape[:2]
    device = data["rewards"].device
    a = agent.actor.action_dim
    out = {"next": torch.randn((g, b, a), generator=generator, device=device),
           "actor": torch.randn((g, b, a), generator=generator, device=device)}
    out["pixels"] = {k: torch.rand(data[k].shape, generator=generator, device=device) for k in cfg.algo.cnn_keys.decoder}
    return out


def make_train_fn(runtime, agent: SACAEAgent, txs, cfg, target_entropy: float):
    """``train(opt_states, data, counter0, noise=None, generator=None)`` ->
    ``(opt_states, metrics)``; ``data`` holds (G, B, ...) f32 tensors
    (images in [0, 255]), ``metrics`` 0-d tensors."""
    algo = cfg.algo
    gamma, tau, encoder_tau = float(algo.gamma), float(algo.tau), float(algo.encoder.tau)
    l2_lambda = float(algo.decoder.l2_lambda)
    target_freq = int(algo.critic.per_rank_target_network_update_freq)
    actor_freq = int(algo.actor.per_rank_update_freq)
    decoder_freq = int(algo.decoder.per_rank_update_freq)
    num_critics = int(algo.critic.n)
    cnn_keys, mlp_keys = tuple(algo.cnn_keys.encoder), tuple(algo.mlp_keys.encoder)
    cnn_keys_dec, mlp_keys_dec = tuple(algo.cnn_keys.decoder), tuple(algo.mlp_keys.decoder)
    critic, target, actor, decoder = agent.critic, agent.target, agent.actor, agent.decoder
    encoder = critic.encoder
    params = {g: trainable_params(m) for g, m in opt_groups(agent).items() if g != "alpha"}
    params["alpha"] = {"log_alpha": agent.log_alpha}

    def norm(batch, prefix=""):
        obs = {k: batch[prefix + k] / 255.0 for k in cnn_keys}
        obs.update({k: batch[prefix + k] for k in mlp_keys})
        return obs

    def step(group: str, loss: torch.Tensor, opt_states) -> None:
        txs[group].update(params[group], grads_or_zeros(loss, params[group]), opt_states[group])

    def train(opt_states, data: Dict[str, torch.Tensor], counter0: int, noise=None, generator=None):
        g = data["rewards"].shape[0]
        if noise is None:
            noise = draw_noise(cfg, agent, data, generator)
        losses, flags = [], []
        for i in range(g):
            counter = int(counter0) + i
            batch = {k: v[i] for k, v in data.items()}
            alpha = agent.log_alpha.detach().exp()
            obs, next_obs = norm(batch), norm(batch, "next_")

            # critic: the encoder and the Q ensemble together
            with torch.no_grad():
                next_actions, next_logp = actions_and_log_probs(actor, encoder, next_obs, noise["next"][i])
                qf_next = target(next_obs, next_actions)
                min_qf_next = qf_next.min(-1, keepdim=True).values - alpha * next_logp
                next_qf_value = batch["rewards"] + (1 - batch["terminated"]) * gamma * min_qf_next
            qf_loss = critic_loss(critic(obs, batch["actions"]), next_qf_value, num_critics)
            step("critic", qf_loss, opt_states)

            # the targets' EMA
            if counter % target_freq == 0:
                with torch.no_grad():
                    ema_(target.encoder, critic.encoder, encoder_tau)
                    ema_(target.qfs, critic.qfs, tau)

            # actor and alpha, on the updated encoder's features
            zero = torch.zeros((), device=qf_loss.device)
            actor_loss = alpha_loss = zero
            if counter % actor_freq == 0:
                actions, logp = actions_and_log_probs(actor, encoder, obs, noise["actor"][i])
                q = critic.qfs(encoder(obs).detach(), actions)
                actor_loss = policy_loss(alpha, logp, q.min(-1, keepdim=True).values)
                step("actor", actor_loss, opt_states)
                alpha_loss = entropy_loss(agent.log_alpha, logp, target_entropy)
                step("alpha", alpha_loss, opt_states)

            # the autoencoder: the encoder on its own Adam state, the decoder on AdamW
            rec_loss = zero
            if counter % decoder_freq == 0:
                hidden = encoder(obs)
                reconstruction = decoder(hidden)
                l2 = (0.5 * (hidden**2).sum(-1)).mean()
                rec_loss = zero
                for k in cnn_keys_dec:
                    pixels = preprocess_obs(batch[k], noise["pixels"][k][i], bits=5)
                    rec_loss = rec_loss + torch.mean((pixels - reconstruction[k]) ** 2) + l2_lambda * l2
                for k in mlp_keys_dec:
                    rec_loss = rec_loss + torch.mean((batch[k] - reconstruction[k]) ** 2) + l2_lambda * l2
                grads = grads_or_zeros(rec_loss, {**params["encoder"], **{f"decoder/{k}": v for k, v in params["decoder"].items()}})
                txs["encoder"].update(params["encoder"], {k: grads[k] for k in params["encoder"]}, opt_states["encoder"])
                txs["decoder"].update(params["decoder"], {k: grads[f"decoder/{k}"] for k in params["decoder"]},
                                      opt_states["decoder"])
            losses.append(torch.stack([qf_loss.detach(), actor_loss.detach(), alpha_loss.detach(), rec_loss.detach()]))
            fired = [1.0, float(counter % actor_freq == 0), float(counter % actor_freq == 0), float(counter % decoder_freq == 0)]
            flags.append(fired)
        totals = torch.tensor(flags, device=losses[0].device).sum(0)
        mean = torch.stack(losses).sum(0) / torch.clamp(totals, min=1.0)
        metrics = {"Loss/value_loss": mean[0], "Loss/policy_loss": mean[1], "Loss/alpha_loss": mean[2],
                   "Loss/reconstruction_loss": mean[3]}
        return opt_states, metrics

    return train


def make_train_state(runtime, agent: SACAEAgent, cfg, target_entropy: float, prioritized: bool = False) -> SACTrainState:
    """The five optimizers (no clip) and their states, and the train function."""
    txs = {g: build_optimizer(cfg.algo[g].optimizer, None, runtime.precision) for g in opt_groups(agent)}
    states = {g: txs[g].init(trainable_params(m)) for g, m in opt_groups(agent).items() if g != "alpha"}
    states["alpha"] = txs["alpha"].init({"log_alpha": agent.log_alpha})
    return SACTrainState(agent, txs, states, make_train_fn(runtime, agent, txs, cfg, target_entropy), bool(prioritized),
                         runtime)


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
    """One dispatch of ``len(ema_flags)`` gradient steps (``sac_ae.py:412-449``;
    the cadences run on the cumulative step counter, so the flags count the
    steps only): G uniform batches from the cache when it can sample, else
    from ``rb`` on the host.  Returns the dispatch's metrics."""
    g = len(ema_flags)
    batch_unit = int(cfg.algo.per_rank_batch_size) * state.runtime.world_size
    sample_next_obs = bool(cfg.buffer.sample_next_obs)
    device = state.agent.log_alpha.device
    obs_keys = tuple(cfg.algo.cnn_keys.encoder) + tuple(cfg.algo.mlp_keys.encoder)
    if device_cache is not None and pending_rows:
        device_cache.add({k: np.concatenate([r[k] for r in pending_rows], axis=0) for k in pending_rows[0]})
        pending_rows.clear()
    if device_cache is not None and device_cache.can_sample_transitions(sample_next_obs):
        sampled = device_cache.sample_transitions(g, batch_unit, generator, sample_next_obs=sample_next_obs,
                                                  obs_keys=obs_keys)
        data = {k: v.float() for k, v in sampled.items()}
    else:
        sample = rb.sample(batch_size=g * batch_unit, sample_next_obs=sample_next_obs)
        data = {
            k: torch.from_numpy(np.asarray(v, dtype=np.float32).reshape(g, batch_unit, *v.shape[2:])).to(device)
            for k, v in sample.items()
        }
        data = state.runtime.shard_batch(data, axis=1)
    state.opt_states, metrics = state.train_fn(state.opt_states, data, state.gradient_steps, noise=noise,
                                               generator=generator)
    state.gradient_steps += g
    return metrics


def make_player(agent: SACAEAgent, cfg, num_envs: int) -> SACAEPlayer:
    """The player: the actor on the critic's encoder, every encoder key."""
    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    return SACAEPlayer(agent, lambda o: prepare_obs({k: o[k] for k in keys}, cnn_keys=cnn_keys, num_envs=num_envs))


# the dispatch is looked up at each call, so that a caller may wrap the module's train_dispatch
SAC_AE_FAMILY = OffPolicyFamily("SAC-AE", build_agent, make_train_state, lambda *a, **k: train_dispatch(*a, **k),
                                make_player, opt_groups, test, batched=False, keyed_rows=True)


@register_algorithm()
def main(runtime, cfg):
    """SAC-AE's env loop: the off-policy loop (``run_off_policy``) with
    SAC-AE's family.  Returns the run's summary."""
    return run_off_policy(runtime, cfg, SAC_AE_FAMILY)

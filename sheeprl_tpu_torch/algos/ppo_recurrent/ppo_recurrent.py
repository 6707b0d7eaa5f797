"""Recurrent PPO on the device-env backend (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``).

- ``make_update_fn``: GAE over the (T, B) rollout, ``is_first[t] =
  done[t-1]`` (zeros with ``reset_recurrent_state_on_done`` off), the
  rollout cut into ``n_seqs = (T / sl) B`` sequences of
  ``per_rank_sequence_length`` steps, each starting from the stored
  ``prev_hx``/``prev_cx`` of its first step, then ``update_epochs`` epochs
  of ``per_rank_num_batches`` minibatches of sequences over a fresh
  permutation each epoch (padded with its own head when the last minibatch
  would run short): one truncated-BPTT clipped-surrogate step and one
  AdamW step a minibatch.  The losses are the mean over minibatches, then
  over epochs.  The JAX package compiles all of it into one program; here
  it runs as eager torch operations, the parameters updated in place.  The
  permutations come from the run's generator, or the caller supplies them
  (the tests feed JAX's).
- ``main``: PPO's loop (``algos/ppo/ppo.py:run_on_policy``) with the
  recurrent agent, :class:`~sheeprl_tpu_torch.envs.device.collect.FusedRecurrentCollector`
  and the recurrent test episode.  JAX's checks stay: MineDojo is refused,
  ``rollout_steps`` must be a multiple of ``per_rank_sequence_length`` and
  ``buffer.size`` at least ``rollout_steps``.  A port checkpoint also holds
  the envs' state, the recurrent carry and the run's generator, so a
  resumed run continues where it stopped (JAX resets its envs and carry).

The rank-local DDP core (``shard_map``) waits for ROADMAP A5, the host
``RecurrentCollector`` (``algo.env_backend=host``) for A2: both raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import OnPolicyFamily, annealed_coefs, epoch_permutations, run_on_policy
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import RecurrentPPOPlayer, build_agent, evaluate_actions
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import prepare_obs, test
from sheeprl_tpu_torch.envs.device.collect import FusedRecurrentCollector
from sheeprl_tpu_torch.optim import global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, trainable_params

__all__ = ["RPPO_FAMILY", "main", "make_update_fn", "sequence_layout"]


def sequence_layout(t_len: int, n_envs: int, sl: int, num_batches: int):
    """``(n_seqs, mb_size, num_minibatches, n_used)`` of a (T, B) rollout cut
    into sequences of ``sl`` steps, ``num_batches`` minibatches an epoch."""
    n_seqs = (t_len // sl) * n_envs
    mb_size = max(1, n_seqs // max(1, num_batches))
    num_minibatches = max(1, -(-n_seqs // mb_size))
    return n_seqs, mb_size, num_minibatches, num_minibatches * mb_size


def make_update_fn(runtime, agent, tx, cfg: Dict[str, Any], obs_keys: Sequence[str]):
    """``update(opt_state, data, next_values, *, clip_coef, ent_coef, lr,
    generator=None, perms=None) -> metrics``: one recurrent-PPO update of
    ``agent`` (in place) on a (T, B, ...) rollout with its (B, 1) bootstrap
    values.  ``perms`` are the epochs' sequence orders (``epoch_permutations``'
    layout over the ``n_seqs`` sequences); drawn from ``generator`` (the
    runtime's by default) when not supplied."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = list(obs_keys)
    update_epochs = int(cfg.algo.update_epochs)
    num_batches = max(1, int(cfg.algo.per_rank_num_batches))
    sl = int(cfg.algo.per_rank_sequence_length)
    gamma = float(cfg.algo.gamma)
    gae_lambda = float(cfg.algo.gae_lambda)
    vf_coef = float(cfg.algo.vf_coef)
    clip_vloss = bool(cfg.algo.clip_vloss)
    reduction = str(cfg.algo.loss_reduction)
    normalize_adv = bool(cfg.algo.normalize_advantages)
    reset_on_done = bool(cfg.algo.reset_recurrent_state_on_done)
    params = trainable_params(agent)

    def loss_fn(mb, hx, cx, clip_coef, ent_coef):
        obs = normalize_obs({k: mb[k].to(torch.float32) for k in obs_keys}, cnn_keys, obs_keys)
        new_logprobs, entropy, new_values = evaluate_actions(
            agent, obs, mb["prev_actions"], mb["is_first"], hx, cx, mb["actions"]
        )
        adv = normalize_tensor(mb["advantages"]) if normalize_adv else mb["advantages"]
        pg = policy_loss(new_logprobs, mb["logprobs"], adv, clip_coef, reduction)
        vl = value_loss(new_values, mb["values"], mb["returns"], clip_coef, clip_vloss, reduction)
        ent = entropy_loss(entropy, reduction)
        return pg + vf_coef * vl + ent_coef * ent, (pg, vl, ent)

    def update(opt_state, data, next_values, *, clip_coef: float, ent_coef: float, lr: float,
               generator: Optional[torch.Generator] = None, perms=None):
        tx.learning_rate = float(lr)
        t_len, n_envs = data["rewards"].shape[:2]
        with torch.no_grad():
            returns, advantages = gae(data["rewards"], data["values"], data["dones"], next_values, gamma, gae_lambda)
        is_first = torch.zeros_like(data["dones"])
        if reset_on_done:
            is_first[1:] = data["dones"][:-1]
        data = {**data, "returns": returns, "advantages": advantages, "is_first": is_first}
        n_seqs, mb_size, num_minibatches, n_used = sequence_layout(t_len, n_envs, sl, num_batches)
        n_chunks = t_len // sl

        def to_seq(x):  # (T, B, ...) -> (sl, n_chunks * B, ...), chunk-major
            x = x.reshape(n_chunks, sl, n_envs, *x.shape[2:]).transpose(0, 1)
            return x.reshape(sl, n_seqs, *x.shape[3:])

        seq = {k: to_seq(v) for k, v in data.items() if k not in ("prev_hx", "prev_cx")}
        hx0 = data["prev_hx"].reshape(n_chunks, sl, n_envs, -1)[:, 0].reshape(n_seqs, -1)
        cx0 = data["prev_cx"].reshape(n_chunks, sl, n_envs, -1)[:, 0].reshape(n_seqs, -1)
        if perms is None:
            gen = runtime.generator if generator is None else generator
            perms = epoch_permutations(n_seqs, n_used, update_epochs, gen, runtime.device)
        epoch_losses = []
        for epoch in range(update_epochs):
            mb_losses = []
            for i in range(num_minibatches):
                idx = perms[epoch, i * mb_size : (i + 1) * mb_size]
                mb = {k: v[:, idx] for k, v in seq.items()}
                total, (pg, vl, ent) = loss_fn(mb, hx0[idx], cx0[idx], clip_coef, ent_coef)
                grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
                tx.update(params, grads, opt_state, global_norm(grads.values()))
                mb_losses.append(torch.stack([pg.detach(), vl.detach(), ent.detach()]))
            epoch_losses.append(torch.stack(mb_losses).mean(0))
        mean = torch.stack(epoch_losses).mean(0)
        return {"Loss/policy_loss": mean[0], "Loss/value_loss": mean[1], "Loss/entropy_loss": mean[2]}

    return update


RPPO_FAMILY = OnPolicyFamily(
    build_agent=build_agent,
    collector=FusedRecurrentCollector,
    make_player=lambda agent, runtime, cnn_keys: RecurrentPPOPlayer(
        agent, lambda obs: prepare_obs(obs, cnn_keys=cnn_keys, num_envs=1, device=runtime.device), num_envs=1
    ),
    test=test,
    bootstrap=lambda payload: payload.next_values,
    batch_key="num_batches",
    batch_cfg="per_rank_num_batches",
)


@register_algorithm()
def main(runtime, cfg: Dict[str, Any]):
    if "minedojo" in str(cfg.env.wrapper.get("_target_", "")).lower():
        raise ValueError(
            "MineDojo is not currently supported by the Recurrent PPO agent "
            "(no action-mask handling); use one of the Dreamer agents."
        )
    if cfg.algo.rollout_steps % cfg.algo.per_rank_sequence_length != 0:
        raise ValueError(
            f"rollout_steps ({cfg.algo.rollout_steps}) must be a multiple of "
            f"per_rank_sequence_length ({cfg.algo.per_rank_sequence_length})"
        )
    return run_on_policy(runtime, cfg, "Recurrent PPO", make_update_fn, annealed_coefs(cfg), RPPO_FAMILY)

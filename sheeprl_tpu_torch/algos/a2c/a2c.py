"""A2C on the device-env backend (counterpart of ``sheeprl_tpu/algos/a2c/a2c.py``).

The loop is PPO's (``algos/ppo/ppo.py:run_on_policy``); the update
differs: GAE, one permutation of the rollout's rows, the gradients of
every minibatch taken at the same parameters and summed, then one
optimizer step (the reference's ``no_backward_sync`` and deferred
``optimizer.step``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.a2c.loss import policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.agent import evaluate_actions, get_values
from sheeprl_tpu_torch.algos.ppo.ppo import annealed, epoch_permutations, run_on_policy
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs
from sheeprl_tpu_torch.optim import global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, trainable_params

__all__ = ["main", "make_update_fn"]


def make_update_fn(runtime, agent, tx, cfg: Dict[str, Any], obs_keys: Sequence[str]):
    """``update(opt_state, data, next_obs, *, lr, generator=None, perm=None)
    -> metrics``: one A2C update of ``agent`` (in place).  ``perm`` is the
    rollout's row order (``n_used`` rows); drawn from ``generator`` (the
    runtime's by default) when not supplied."""
    obs_keys = list(obs_keys)
    mb_size = int(cfg.algo.per_rank_batch_size) * runtime.world_size
    gamma = float(cfg.algo.gamma)
    gae_lambda = float(cfg.algo.gae_lambda)
    vf_coef = float(cfg.algo.vf_coef)
    reduction = str(cfg.algo.loss_reduction)
    normalize_adv = bool(cfg.algo.get("normalize_advantages", False))
    ent_coef = float(cfg.algo.ent_coef)
    params = trainable_params(agent)

    def norm(obs):
        return normalize_obs({k: obs[k].to(torch.float32) for k in obs_keys}, (), obs_keys)

    def loss_fn(mb):
        logprobs, entropy, new_values = evaluate_actions(agent, norm(mb), mb["actions"])
        adv = normalize_tensor(mb["advantages"]) if normalize_adv else mb["advantages"]
        pg = policy_loss(logprobs, adv, reduction)
        vl = value_loss(new_values, mb["returns"], reduction)
        return pg + vf_coef * vl - ent_coef * entropy.mean(), (pg, vl)

    def update(opt_state, data, next_obs, *, lr: float, generator: Optional[torch.Generator] = None, perm=None):
        tx.learning_rate = float(lr)
        with torch.no_grad():
            next_values = get_values(agent, norm(next_obs))
            returns, advantages = gae(data["rewards"], data["values"], data["dones"], next_values, gamma, gae_lambda)
        data = {**data, "returns": returns, "advantages": advantages}
        n_total = data["rewards"].shape[0] * data["rewards"].shape[1]
        flat = {k: v.reshape(n_total, *v.shape[2:]) for k, v in data.items()}
        num_minibatches = max(1, -(-n_total // mb_size))
        if perm is None:
            gen = runtime.generator if generator is None else generator
            perm = epoch_permutations(n_total, num_minibatches * mb_size, 1, gen, runtime.device)[0]
        shuffled = {k: v[perm] for k, v in flat.items()}
        acc, losses = None, []
        for i in range(num_minibatches):
            mb = {k: v[i * mb_size : (i + 1) * mb_size] for k, v in shuffled.items()}
            total, (pg, vl) = loss_fn(mb)
            grads = torch.autograd.grad(total, list(params.values()))
            acc = list(grads) if acc is None else torch._foreach_add(acc, grads)
            losses.append(torch.stack([pg.detach(), vl.detach()]))
        grads = dict(zip(params, acc))
        grad_norm = global_norm(grads.values())
        tx.update(params, grads, opt_state, grad_norm)
        mean = torch.stack(losses).mean(0)
        return {"Loss/policy_loss": mean[0], "Loss/value_loss": mean[1], "Grads/agent": grad_norm}

    return update


@register_algorithm()
def main(runtime, cfg: Dict[str, Any]):
    if len(cfg.algo.cnn_keys.encoder) > 0:
        raise ValueError("A2C supports only vector observations (mlp keys)")
    lr0 = float(cfg.algo.optimizer.get("learning_rate", 1e-3))

    def coefs(done_iters: int, total_iters: int) -> Dict[str, float]:
        return {"lr": annealed(lr0, cfg.algo.anneal_lr, done_iters, total_iters)}

    return run_on_policy(runtime, cfg, "A2C", make_update_fn, coefs)

"""DreamerV1 losses (counterpart of ``sheeprl_tpu/algos/dreamer_v1/loss.py``):
the actor's ``-mean(discounted lambda returns)``, the critic's
unit-variance Normal regression and the ELBO with a plain Gaussian KL and
free nats (no balancing).  The continue term is ``- log_prob``, as in the
JAX package."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import kl_divergence

__all__ = ["actor_loss", "critic_loss", "reconstruction_loss"]


def actor_loss(discounted_lambda_values: torch.Tensor) -> torch.Tensor:
    return -torch.mean(discounted_lambda_values)


def critic_loss(qv, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    return -torch.mean(discount * qv.log_prob(lambda_values))


def reconstruction_loss(
    qo: Dict[str, object],
    observations: Dict[str, torch.Tensor],
    qr,
    rewards: torch.Tensor,
    posteriors_dist,
    priors_dist,
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    qc=None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, ...]:
    """-> (loss, kl, state_loss, reward_loss, observation_loss, continue_loss), scalars."""
    observation_loss = -sum(qo[k].log_prob(observations[k]).mean() for k in qo.keys())
    reward_loss = -qr.log_prob(rewards).mean()
    kl = kl_divergence(posteriors_dist, priors_dist).mean()
    state_loss = torch.clamp(kl, min=kl_free_nats)
    if qc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -qc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    return rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss

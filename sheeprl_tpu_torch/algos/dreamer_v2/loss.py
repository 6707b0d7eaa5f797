"""DreamerV2 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v2/loss.py``): the ELBO with KL balancing
(``alpha`` KL(sg(post) || prior) + (1 - alpha) KL(post || sg(prior))),
free nats on the means (``kl_free_avg``) or on each element, unit-variance
Normal observation and reward heads and the optional Bernoulli continue
head."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.loss import _kl

__all__ = ["reconstruction_loss"]


def reconstruction_loss(
    po: Dict[str, object],
    observations: Dict[str, torch.Tensor],
    pr,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    pc=None,
    continue_targets: Optional[torch.Tensor] = None,
    discount_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """-> (loss, kl, kl_loss, reward_loss, observation_loss, continue_loss);
    ``kl`` is the (T, B) KL(sg(post) || prior), the rest are scalars."""
    observation_loss = -sum(po[k].log_prob(observations[k]).mean() for k in po.keys())
    reward_loss = -pr.log_prob(rewards).mean()
    lhs = kl = _kl(posteriors_logits.detach(), priors_logits)
    rhs = _kl(posteriors_logits, priors_logits.detach())
    if kl_free_avg:
        loss_lhs = torch.clamp(lhs.mean(), min=kl_free_nats)
        loss_rhs = torch.clamp(rhs.mean(), min=kl_free_nats)
    else:
        loss_lhs = torch.clamp(lhs, min=kl_free_nats).mean()
        loss_rhs = torch.clamp(rhs, min=kl_free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    if pc is not None and continue_targets is not None:
        continue_loss = discount_scale_factor * -pc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    return rec_loss, kl, kl_loss, reward_loss, observation_loss, continue_loss

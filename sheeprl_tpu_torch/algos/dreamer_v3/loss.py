"""DreamerV3 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v3/loss.py``): observation, reward and continue
log-likelihoods and the two-sided KL (dynamic and representation terms)
with free nats."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import Independent, OneHotCategoricalStraightThrough, kl_divergence

__all__ = ["reconstruction_loss"]


def _kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    return kl_divergence(
        Independent(OneHotCategoricalStraightThrough(logits=p_logits), 1),
        Independent(OneHotCategoricalStraightThrough(logits=q_logits), 1),
    )


def reconstruction_loss(
    po: Dict[str, object],
    observations: Dict[str, torch.Tensor],
    pr,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc=None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """-> (loss, kl, kl_loss, reward_loss, observation_loss, continue_loss),
    each a mean over (T, B)."""
    observation_loss = -sum(po[k].log_prob(observations[k]) for k in po.keys())
    reward_loss = -pr.log_prob(rewards)
    # KL balancing: dynamic (posterior detached) + representation (prior detached)
    kl = _kl(posteriors_logits.detach(), priors_logits)
    dyn_loss = kl_dynamic * torch.clamp(kl, min=kl_free_nats)
    repr_loss = kl_representation * torch.clamp(_kl(posteriors_logits, priors_logits.detach()), min=kl_free_nats)
    kl_loss = dyn_loss + repr_loss
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets)
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    return rec_loss, kl.mean(), kl_loss.mean(), reward_loss.mean(), observation_loss.mean(), continue_loss.mean()

"""PPO losses on torch tensors (counterpart of ``sheeprl_tpu/algos/ppo/loss.py``).

Every loss takes optional per-element ``weights`` (broadcast to the loss
terms): a weight-0 row rides through the batch without moving the
gradients.  With ``weights=None`` the reductions are the plain ones.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["entropy_loss", "policy_loss", "value_loss"]


def _reduce(x: torch.Tensor, reduction: str, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    reduction = reduction.lower()
    if weights is not None:
        w = torch.broadcast_to(weights.to(x.dtype), x.shape)
        if reduction == "none":
            return x * w
        if reduction == "mean":
            return (x * w).sum() / torch.clamp_min(w.sum(), 1.0)
        if reduction == "sum":
            return (x * w).sum()
        raise ValueError(f"Unrecognized reduction: {reduction}")
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(f"Unrecognized reduction: {reduction}")


def policy_loss(
    new_logprobs: torch.Tensor,
    logprobs: torch.Tensor,
    advantages: torch.Tensor,
    clip_coef: float,
    reduction: str = "mean",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Clipped surrogate objective, eq. (7) of the PPO paper."""
    ratio = torch.exp(new_logprobs - logprobs)
    pg_loss1 = advantages * ratio
    pg_loss2 = advantages * torch.clamp(ratio, 1.0 - clip_coef, 1.0 + clip_coef)
    return _reduce(-torch.minimum(pg_loss1, pg_loss2), reduction, weights)


def value_loss(
    new_values: torch.Tensor,
    old_values: torch.Tensor,
    returns: torch.Tensor,
    clip_coef: float,
    clip_vloss: bool,
    reduction: str = "mean",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if not clip_vloss:
        return _reduce((new_values - returns) ** 2, reduction, weights)
    v_loss_unclipped = (new_values - returns) ** 2
    v_clipped = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    v_loss = torch.maximum(v_loss_unclipped, (v_clipped - returns) ** 2)
    if weights is not None:
        return 0.5 * _reduce(v_loss, "mean", weights)
    return 0.5 * v_loss.mean()


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean", weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _reduce(-entropy, reduction, weights)

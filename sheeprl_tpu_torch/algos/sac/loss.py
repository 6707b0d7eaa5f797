"""SAC losses (counterpart of ``sheeprl_tpu/algos/sac/loss.py``; arXiv:1812.05905)."""

from __future__ import annotations

import torch

__all__ = ["critic_loss", "critic_loss_weighted", "entropy_loss", "policy_loss", "td_error_abs"]


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, qf_values: torch.Tensor) -> torch.Tensor:
    # Eq. 7
    return ((alpha * logprobs) - qf_values).mean()


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor, num_critics: int) -> torch.Tensor:
    # Eq. 5: the sum of the critics' MSEs against the shared target
    return sum(((qf_values[..., i : i + 1] - next_qf_value) ** 2).mean() for i in range(num_critics))


def critic_loss_weighted(
    qf_values: torch.Tensor, next_qf_value: torch.Tensor, num_critics: int, weights: torch.Tensor
) -> torch.Tensor:
    """Prioritized replay's critic loss: each sample's squared error scaled by
    its IS weight (Schaul et al., 2016, Alg. 1 line 11).  The actor and
    alpha objectives stay unweighted."""
    return sum((weights * (qf_values[..., i : i + 1] - next_qf_value) ** 2).mean() for i in range(num_critics))


def td_error_abs(qf_values: torch.Tensor, next_qf_value: torch.Tensor) -> torch.Tensor:
    """Each sample's |delta| for the priority updates: the ensemble mean of
    the absolute TD errors, (B,)."""
    return torch.abs(qf_values - next_qf_value).mean(-1)


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    # Eq. 17, with no gradient through the log-probs
    return (-log_alpha * (logprobs.detach() + target_entropy)).mean()

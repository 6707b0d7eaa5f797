"""V-trace off-policy correction on torch tensors (counterpart of
``sheeprl_tpu/algos/ppo/vtrace.py``).

The lambda-generalised estimator, over time-major (T, B, 1) inputs::

    rho_t   = min(rho_clip, exp(log_rho_t))
    c_t     = lam * min(c_clip, exp(log_rho_t))
    delta_t = rho_t * (r_t + gamma * nd_t * V_{t+1} - V_t)
    err_t   = delta_t + gamma * nd_t * c_t * err_{t+1}     (reverse loop)
    vs_t    = V_t + err_t

With on-policy data (``log_rhos == 0``) it is :func:`~sheeprl_tpu_torch.utils.utils.gae`.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["vtrace", "vtrace_pg_advantage"]


def vtrace(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    log_rhos: torch.Tensor,
    gamma: float,
    lam: float,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vs, advantages)``, both (T, B, 1) f32; ``next_value`` is (B, 1)."""
    values = values.float()
    rewards = rewards.float()
    not_done = 1.0 - dones.float()
    next_values = torch.cat([values[1:], next_value.float()[None]], 0)
    rhos = torch.exp(log_rhos.float())
    clipped_rhos = torch.clamp_max(rhos, rho_clip)
    cs = lam * torch.clamp_max(rhos, c_clip)
    err = torch.zeros_like(next_value, dtype=torch.float32)
    errs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = clipped_rhos[t] * (rewards[t] + gamma * next_values[t] * not_done[t] - values[t])
        err = delta + gamma * not_done[t] * cs[t] * err
        errs.append(err)
    errs = torch.stack(errs[::-1], 0)
    return errs + values, errs


def vtrace_pg_advantage(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    vs: torch.Tensor,
    log_rhos: torch.Tensor,
    gamma: float,
    rho_clip: float = 1.0,
) -> torch.Tensor:
    """IMPALA's one-step advantage ``rho_t (r_t + gamma vs_{t+1} - V_t)``;
    ``vs`` is :func:`vtrace`'s first output."""
    values = values.float()
    not_done = 1.0 - dones.float()
    vs_next = torch.cat([vs[1:], next_value.float()[None]], 0)
    rhos = torch.clamp_max(torch.exp(log_rhos.float()), rho_clip)
    return rhos * (rewards.float() + gamma * not_done * vs_next - values)

"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``):
the percentile-EMA return normaliser ("Moments") and the lambda returns."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sheeprl_tpu_torch.utils.utils import lambda_values as compute_lambda_values  # noqa: F401

__all__ = ["compute_lambda_values", "init_moments", "update_moments"]


def init_moments(device=None) -> Dict[str, torch.Tensor]:
    return {"low": torch.zeros((), device=device), "high": torch.zeros((), device=device)}


@torch.no_grad()
def update_moments(
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1e8,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """-> (new_state, offset, invscale).  Quantiles interpolate linearly,
    as ``jnp.quantile`` and ``torch.quantile`` both do by default."""
    x = x.float().reshape(-1)
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state["low"] + (1 - decay) * low
    new_high = decay * state["high"] + (1 - decay) * high
    invscale = torch.clamp(new_high - new_low, min=1.0 / max_)
    return {"low": new_low, "high": new_high}, new_low, invscale

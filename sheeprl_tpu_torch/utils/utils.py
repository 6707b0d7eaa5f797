"""Small tensor helpers (counterpart of ``sheeprl_tpu/utils/utils.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

__all__ = [
    "ema_",
    "grads_or_zeros",
    "lambda_values",
    "resolve_device",
    "symexp",
    "symlog",
    "trainable_params",
    "two_hot_encoder",
]


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: Optional[int] = None) -> torch.Tensor:
    """Two-hot encoding of ``x`` (..., 1) over ``num_buckets`` bins evenly
    spanning ``[-support_range, support_range]``: (..., num_buckets).
    The caller applies symlog.  Closed form over the uniform support, as
    the JAX package computes it (no comparison broadcast)."""
    if num_buckets is None:
        num_buckets = support_range * 2 + 1
    x = torch.clamp(x, -support_range, support_range)
    step = (2.0 * support_range) / (num_buckets - 1)
    below = torch.floor((x + support_range) / step).to(torch.int64).clamp(0, num_buckets - 1)
    above = (below + 1).clamp(0, num_buckets - 1)
    sup_below = -support_range + below.to(x.dtype) * step
    sup_above = -support_range + above.to(x.dtype) * step
    equal = below == above
    dist_below = torch.where(equal, torch.ones_like(x), torch.abs(sup_below - x))
    dist_above = torch.where(equal, torch.ones_like(x), torch.abs(sup_above - x))
    total = dist_below + dist_above
    w_below = dist_above / total
    w_above = dist_below / total
    oh_below = F.one_hot(below.squeeze(-1), num_buckets).to(x.dtype) * w_below
    oh_above = F.one_hot(above.squeeze(-1), num_buckets).to(x.dtype) * w_above
    return oh_below + oh_above


def lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """TD(lambda) returns over (T, B, 1) inputs, ``continues`` already
    scaled by gamma: ``R[t] = r[t] + c[t]((1 - lambda) v[t] + lambda R[t+1])``
    seeded with ``R[T] = v[T-1]`` (the JAX package's reverse scan)."""
    interm = rewards + continues * values * (1 - lmbda)
    carry = values[-1]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = interm[t] + continues[t] * lmbda * carry
        out.append(carry)
    return torch.stack(out[::-1], 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Without a card, asking for ``cuda`` (or nothing) raises:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sheeprl_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def trainable_params(module: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """``module``'s parameters that take gradients, by name."""
    return {k: p for k, p in module.named_parameters() if p.requires_grad}


def grads_or_zeros(loss: torch.Tensor, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach gets zeros, as in JAX."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), got)}


@torch.no_grad()
def ema_(target: torch.nn.Module, source: torch.nn.Module, tau: float) -> None:
    """``optax.incremental_update``: target = tau * source + (1 - tau) * target."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.mul_(1.0 - tau).add_(s, alpha=tau)

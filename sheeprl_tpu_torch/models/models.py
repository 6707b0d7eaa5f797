"""Building blocks of the DreamerV3 player as torch modules.

Counterpart of ``sheeprl_tpu/models/models.py`` (``resolve_activation``,
``ln_act_apply``, ``gru_cell_apply``, ``LayerNormGRUCell``).  The
LayerNorms keep flax's formulas, not ``torch.nn.LayerNorm``'s: statistics
in f32, the fast variance ``max(E[x^2] - E[x]^2, 0)``, then
``(x - mean) * (rsqrt(var + eps) * scale) + bias``.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.gru_cell import gru_cell

__all__ = [
    "LayerNorm",
    "LayerNormGRUCell",
    "flax_init_",
    "gru_cell_apply",
    "layer_norm",
    "ln_act_apply",
    "resolve_activation",
]

_ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": F.leaky_relu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}
# accept reference-style names so existing configs run unmodified
_TORCH_ALIASES = {
    "torch.nn.relu": "relu",
    "torch.nn.tanh": "tanh",
    "torch.nn.silu": "silu",
    "torch.nn.elu": "elu",
    "torch.nn.gelu": "gelu",
    "torch.nn.leakyrelu": "leaky_relu",
    "torch.nn.sigmoid": "sigmoid",
    "torch.nn.identity": "identity",
}


def resolve_activation(act: Union[str, Callable, None]) -> Callable:
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    key = str(act).lower()
    key = _TORCH_ALIASES.get(key, key)
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation '{act}'. Known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]


# the std of a unit normal cut at +-2: flax's truncated normal divides by it
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_init_(weight: torch.Tensor, init: str) -> None:
    """One of the JAX package's kernel initialisers, in distribution:
    ``trunc`` (variance scaling 1.0, fan_avg, truncated normal: Hafner's
    trunk init), ``uniform`` (variance scaling 1.0, fan_avg, uniform: the
    distribution heads) or ``zeros`` (reward and critic heads).  The first
    two dims of ``weight`` are its in and out features (in either order, as
    Linear, Conv2d and ConvTranspose2d hold them), the rest the receptive
    field."""
    if init == "zeros":
        weight.zero_()
        return
    rf = int(np.prod(weight.shape[2:], dtype=np.int64))
    fan_avg = (weight.shape[0] + weight.shape[1]) * rf / 2
    if init == "uniform":
        limit = math.sqrt(3.0 / fan_avg)
        weight.uniform_(-limit, limit)
        return
    if init != "trunc":
        raise ValueError(f"unknown initialiser '{init}'")
    std = math.sqrt(1.0 / fan_avg) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, dim: int = -1
) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over ``dim``: f32 statistics, fast variance.
    Returns f32."""
    xf = x.float()
    mu = xf.mean(dim, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim, keepdim=True) - mu * mu, min=0.0)
    shape = [1] * xf.dim()
    shape[dim] = -1
    mul = torch.rsqrt(var + eps) * weight.float().reshape(shape)
    return (xf - mu) * mul + bias.float().reshape(shape)


class LayerNorm(nn.Module):
    """Parameters of one flax LayerNorm (``scale`` -> ``weight``)."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, dim)


def ln_act_apply(
    norm: LayerNorm, x: torch.Tensor, *, act, dtype: torch.dtype, dim: int = -1
) -> torch.Tensor:
    """LayerNorm (f32 statistics) then the activation in the compute dtype:
    the post-matmul half of ``LinearLnAct``."""
    return resolve_activation(act)(norm(x, dim).to(dtype))


def gru_cell_apply(
    cell: "LayerNormGRUCell", h: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """One step of ``cell`` on (..., H) state and (..., X) input.

    ``cell.fused`` selects the LayerNorm of the JAX path it mirrors: the
    fused Pallas kernel's two-pass variance, or the flax cell's fast
    variance.  Either way CPU tensors compute the plain version and CUDA
    tensors run the hand-written kernel (``ops/gru_cell.py``)."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1]).float().contiguous()
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    w = cell.weight if cell.dtype == torch.float32 else cell.weight.to(cell.dtype)
    if x2.dtype not in (torch.float32, w.dtype):
        x2 = x2.float()
    out = cell.impl(h2, x2, w.contiguous(), cell.norm.weight, cell.norm.bias, eps=cell.norm.eps, two_pass=cell.fused)
    return out.reshape(*lead, -1)


class LayerNormGRUCell(nn.Module):
    """Hafner-style GRU cell: one bias-free dense over [h, x] -> LayerNorm
    over 3H -> reset/candidate/update with the update-gate ``-1`` bias.

    ``weight`` is (H + X, 3H), the flax ``Dense_0/kernel`` layout, which is
    the layout the kernel reads.  ``impl`` is the step function
    (``ops.gru_cell.gru_cell``); a comparison may set it to
    ``gru_cell_plain`` to run the plain version on the card."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        *,
        fused: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.fused = bool(fused)
        self.dtype = dtype
        k = self.hidden_size + int(input_size)
        # flax Dense's default kernel init: LeCun normal (fan_in = k), truncated at 2 std
        std = math.sqrt(1.0 / k) / _TRUNC_STD
        self.weight = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(k, 3 * self.hidden_size, device=device), 0.0, std, -2 * std, 2 * std)
        )
        self.norm = LayerNorm(3 * self.hidden_size, eps=1e-6, device=device)
        self.impl = gru_cell

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return gru_cell_apply(self, h, x)

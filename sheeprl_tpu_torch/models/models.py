"""Building blocks as torch modules.

Counterpart of ``sheeprl_tpu/models/models.py`` (``resolve_activation``,
``MLP``, ``ln_act_apply``, ``gru_cell_apply``, ``LayerNormGRUCell``, with
or without its dense's bias).  The
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
    "MLP",
    "dropout",
    "dropout_mask",
    "flax_init_",
    "lecun_normal_",
    "gru_cell_apply",
    "gru_cell_biased",
    "layer_norm",
    "layer_norm_stacked",
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


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default Dense kernel init, ``lecun_normal``: a normal of
    variance 1 / fan_in truncated at 2 std (the std rescaled for the cut)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


def _per_layer(spec, n: int) -> list:
    """Broadcast a scalar spec to ``n`` layers."""
    if isinstance(spec, (list, tuple)):
        if len(spec) != n:
            raise ValueError(f"Per-layer spec length {len(spec)} != num layers {n}")
        return list(spec)
    return [spec] * n


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


def layer_norm_stacked(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """N flax LayerNorms side by side: ``x`` (N, ..., F), ``weight`` and
    ``bias`` (N, F), member i normalised with row i.  Returns f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    shape = (weight.shape[0],) + (1,) * (xf.dim() - 2) + (weight.shape[-1],)
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
    variance, which under bf16 also rounds the product to bf16 before the
    LayerNorm (``parts = inp.astype(bf16) @ kernel.astype(bf16)``).  Either
    way CPU tensors compute the plain version and CUDA tensors run the
    hand-written kernel (``ops/gru_cell.py``)."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1]).float().contiguous()
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    w = cell.weight if cell.dtype == torch.float32 else cell.weight.to(cell.dtype)
    if x2.dtype not in (torch.float32, w.dtype):
        x2 = x2.float()
    out = cell.impl(
        h2, x2, w.contiguous(), cell.norm.weight, cell.norm.bias, eps=cell.norm.eps, two_pass=cell.fused,
        round_parts=not cell.fused and cell.dtype == torch.bfloat16,
    )
    return out.reshape(*lead, -1)


def gru_cell_biased(cell: "LayerNormGRUCell", h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One step of a cell with a bias (flax's ``LayerNormGRUCell(use_bias=True)``,
    DreamerV2's): the dense over [h, x] with its bias in the compute dtype,
    then the LayerNorm, gates and state update in f32.  The step kernel
    (``csrc/gru_cell.cu``) has no bias, as the JAX package's fused cell has
    none, so this runs in PyTorch on any device."""
    dt = cell.dtype
    inp = torch.cat([h.to(dt), x.to(dt)], -1)
    w = cell.weight if dt == torch.float32 else cell.weight.to(dt)
    b = cell.bias if dt == torch.float32 else cell.bias.to(dt)
    parts = cell.norm((inp @ w + b).float())
    reset, cand, update = torch.chunk(parts, 3, -1)
    reset = torch.sigmoid(reset)
    cand = torch.tanh(reset * cand)
    update = torch.sigmoid(update - 1.0)
    return update * cand + (1.0 - update) * h.float()


class LayerNormGRUCell(nn.Module):
    """Hafner-style GRU cell: one bias-free dense over [h, x] -> LayerNorm
    over 3H -> reset/candidate/update with the update-gate ``-1`` bias.

    ``weight`` is (H + X, 3H), the flax ``Dense_0/kernel`` layout, which is
    the layout the kernel reads.  ``impl`` is the step function
    (``ops.gru_cell.gru_cell``); a comparison may set it to
    ``gru_cell_plain`` to run the plain version on the card.  With
    ``use_bias`` (flax's ``Dense_0/bias``, DreamerV2's cell) the step is
    :func:`gru_cell_biased` and never the kernel, as in the JAX package,
    whose fused cell takes no bias."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        *,
        fused: bool = False,
        use_bias: bool = False,
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
        self.bias = nn.Parameter(torch.zeros(3 * self.hidden_size, device=device)) if use_bias else None
        self.norm = LayerNorm(3 * self.hidden_size, eps=1e-6, device=device)
        self.impl = gru_cell

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            return gru_cell_biased(self, h, x)
        return gru_cell_apply(self, h, x)


def dropout_mask(shape, rate: float, generator: torch.Generator, device=None) -> torch.Tensor:
    """flax ``Dropout``'s keep mask: True with probability ``1 - rate``,
    drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < (1.0 - float(rate))


def dropout(x: torch.Tensor, rate: float, mask: torch.Tensor = None) -> torch.Tensor:
    """flax ``nn.Dropout``: ``x / (1 - rate)`` where ``mask`` keeps, else 0;
    ``x`` itself when ``mask`` is None (deterministic)."""
    if mask is None or not rate:
        return x
    return torch.where(mask, x / (1.0 - float(rate)), torch.zeros_like(x))


class MLP(nn.Module):
    """``sheeprl_tpu/models/models.py:MLP``: per hidden layer linear ->
    dropout -> LayerNorm -> activation, then an optional linear head.
    Initialised as flax does (``lecun_normal`` kernels, zero biases).
    ``layers``/``head`` are ``nn.Linear`` (weight (out, in), the flax kernel
    transposed); the LayerNorms keep flax's formulas (:func:`layer_norm`).

    Dropout is chosen per call, not by ``.training``: deterministic unless
    ``masks`` (one keep mask per hidden layer with a nonzero rate, shaped
    like its output) or a ``generator`` to draw them from is given."""

    def __init__(
        self,
        input_dim: int,
        hidden_sizes=(),
        output_dim=None,
        activation="relu",
        layer_norm=False,
        norm_args=None,
        dropout=0.0,
        flatten_dim=None,
        device=None,
    ):
        super().__init__()
        n = len(hidden_sizes)
        self.acts = [resolve_activation(a) for a in _per_layer(activation, n)]
        norms = _per_layer(layer_norm, n)
        norm_args = _per_layer(norm_args, n)
        self.rates = [float(r or 0.0) for r in _per_layer(dropout, n)]
        self.flatten_dim = flatten_dim
        self.layers = nn.ModuleList()
        self.norms = nn.ModuleList()
        dims = [int(input_dim), *[int(h) for h in hidden_sizes]]
        for i in range(n):
            self.layers.append(self._linear(dims[i], dims[i + 1], device))
            eps = (norm_args[i] or {}).get("eps", 1e-5) if isinstance(norm_args[i], dict) else 1e-5
            self.norms.append(LayerNorm(dims[i + 1], eps=eps, device=device) if norms[i] else nn.Identity())
        self.head = None if output_dim is None else self._linear(dims[-1], int(output_dim), device)

    @staticmethod
    def _linear(fan_in: int, fan_out: int, device) -> nn.Linear:
        lin = nn.Linear(fan_in, fan_out, device=device)
        lecun_normal_(lin.weight, fan_in)
        nn.init.zeros_(lin.bias)
        return lin

    def forward(self, x: torch.Tensor, masks=None, generator: torch.Generator = None) -> torch.Tensor:
        if self.flatten_dim is not None:
            x = x.reshape(*x.shape[: self.flatten_dim], -1)
        masks = list(masks) if masks is not None else None
        for lin, rate, norm, act in zip(self.layers, self.rates, self.norms, self.acts):
            x = lin(x)
            if rate:
                if masks is not None:
                    mask = masks.pop(0)
                elif generator is not None:
                    mask = dropout_mask(x.shape, rate, generator, x.device)
                else:
                    mask = None
                x = dropout(x, rate, mask)
            x = act(norm(x))
        return x if self.head is None else self.head(x)

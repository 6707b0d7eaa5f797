"""The LayerNorm-GRU step: a hand-written CUDA kernel, its plain version,
and the autograd op that training runs.

Counterpart of ``sheeprl_tpu/ops/pallas_gru.py``.  One step computes

    parts = LN(concat([h, x]) @ W)          # no bias, LN over 3H
    reset, cand, update = split(parts, 3)
    h' = sigmoid(update - 1) * tanh(sigmoid(reset) * cand)
         + (1 - sigmoid(update - 1)) * h

with W stored (H + X, 3H) row-major, exactly as the JAX package stores the
``LayerNormGRUCell_0/Dense_0/kernel`` leaf.  ``two_pass=True`` is the fused
Pallas kernel's LayerNorm (variance of the centred values, ``pallas_gru.py``
:63-64); ``two_pass=False`` is the flax cell's ``max(E[p^2] - E[p]^2, 0)``
(``models.py`` :309-312).  Both use eps 1e-6.  ``round_parts=True`` rounds
the product to bf16 before the LayerNorm, as the unfused flax cell does under
bf16 (``models.py`` :303-306, :374).

:func:`gru_cell` is the op.  Its forward is the kernel in
``csrc/gru_cell.cu`` for CUDA tensors (or it raises) and
:func:`gru_cell_plain` for CPU tensors.  When a gradient is needed it runs
as a ``torch.autograd.Function`` whose backward is the counterpart of
``pallas_gru.py:_gru_bwd``: it recomputes the step through the plain
formulas from the saved (h, x, W, gamma, beta) and differentiates them.
JAX computes that backward in XLA, outside any Pallas kernel, so here its
products go to ``torch.matmul``.
"""

from __future__ import annotations

import ctypes

import torch

from sheeprl_tpu_torch.ops.build import CudaLibrary, current_stream

__all__ = ["LIBRARY", "gru_cell", "gru_cell_plain", "split_k", "tile_depth", "tile_rows"]

# the product kernel's tile (csrc/gru_cell.cu: kBN, Tile::kBK)
_BLOCK_N = 128


def tile_depth(bm: int) -> int:
    """K rows of a product tile: 64 for 128-row blocks, else 32."""
    return 64 if bm == 128 else 32


def _bind(lib: ctypes.CDLL) -> None:
    lib.sheeprl_gru_cell_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    lib.sheeprl_gru_cell_forward.restype = ctypes.c_int
    lib.sheeprl_gru_input_product.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.sheeprl_gru_input_product.restype = ctypes.c_int


LIBRARY = CudaLibrary("gru_cell.cu", "libsheeprl_gru", _bind)


def gru_cell_plain(
    h: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-6,
    two_pass: bool = True,
    round_parts: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the step (``pallas_gru.py:reference_gru_cell``).

    The operands are rounded to W's dtype and multiplied in f32: a product
    of two bf16 values is exact in f32, so this is the bf16-operand,
    f32-accumulate product of the kernel.  ``round_parts`` rounds each sum
    to bf16 (nearest even) before the LayerNorm."""
    inp = torch.cat([h.float(), x.float()], -1)
    if w.dtype != torch.float32:
        inp = inp.to(w.dtype)
    parts = inp.float() @ w.float()
    if round_parts:
        parts = parts.to(torch.bfloat16).float()
    mean = parts.mean(-1, keepdim=True)
    if two_pass:
        var = ((parts - mean) ** 2).mean(-1, keepdim=True)
    else:
        var = torch.clamp((parts * parts).mean(-1, keepdim=True) - mean * mean, min=0.0)
    parts = (parts - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    hidden = h.shape[-1]
    reset = torch.sigmoid(parts[..., :hidden])
    cand = torch.tanh(reset * parts[..., hidden : 2 * hidden])
    update = torch.sigmoid(parts[..., 2 * hidden :] - 1.0)
    return update * cand + (1.0 - update) * h.float()


def tile_rows(batch: int, hidden: int, sm_count: int) -> int:
    """Batch rows of a product block (csrc/gru_cell.cu: BM): 16 up to
    B = 16 (one MMA row tile), else 128 where the 128-row tiles alone give
    every SM a block, else 64."""
    if batch <= 16:
        return 16
    if -(-batch // 128) * -(-3 * hidden // _BLOCK_N) >= sm_count:
        return 128
    return 64


def split_k(batch: int, hidden: int, xdim: int, sm_count: int) -> tuple:
    """``(bm, ts, S)``: the block's batch rows, the K tiles of each slice and
    the number of slices.

    K is walked in tiles of :func:`tile_depth` rows, ``ceil(H/depth)``
    over h and then ``ceil(X/depth)`` over x.  128-row blocks fill the card
    without a split.  Blocks of 16 or 64 rows run two to an SM and split
    the tiles into about as many slices as give 6 (16 rows, where the step
    streams W) or 3 (64 rows) blocks per SM, never below two tiles a slice:
    the counts that ran fastest on an H100 at the DV3-XL and DV3-S shapes
    (``PERF.md``)."""
    bm = tile_rows(batch, hidden, sm_count)
    tiles = -(-hidden // tile_depth(bm)) + -(-xdim // tile_depth(bm))
    blocks = -(-batch // bm) * -(-3 * hidden // _BLOCK_N)
    want = 1 if bm == 128 else max(1, round((6 if bm == 16 else 3) * sm_count / blocks))
    ts = max(-(-tiles // want), min(2, tiles))
    return bm, ts, -(-tiles // ts)


def _check(h, x, w, gamma, beta) -> None:
    dev = h.device
    for name, t in (("x", x), ("w", w), ("gamma", gamma), ("beta", beta)):
        if t.device != dev:
            raise ValueError(f"gru_cell: {name} is on {t.device}, h is on {dev}")
    if h.dim() != 2 or x.dim() != 2 or w.dim() != 2:
        raise ValueError("gru_cell: h, x and w must be 2-d")
    b, hidden = h.shape
    if x.shape[0] != b:
        raise ValueError(f"gru_cell: x has {x.shape[0]} rows, h has {b}")
    if tuple(w.shape) != (hidden + x.shape[1], 3 * hidden):
        raise ValueError(f"gru_cell: w is {tuple(w.shape)}, expected {(hidden + x.shape[1], 3 * hidden)}")
    if tuple(gamma.shape) != (3 * hidden,) or tuple(beta.shape) != (3 * hidden,):
        raise ValueError("gru_cell: gamma and beta must be (3H,)")
    if h.dtype != torch.float32 or gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError("gru_cell: h, gamma and beta must be float32")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_cell: w must be float32 or bfloat16, got {w.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_cell: x must be float32 or bfloat16, got {x.dtype}")
    # the kernel's rows are staged in 16-byte copies
    if hidden % 4 or x.shape[1] % 4:
        raise ValueError(f"gru_cell: the kernel needs H % 4 == 0 and X % 4 == 0, got H={hidden}, X={x.shape[1]}")
    if w.dtype == torch.bfloat16 and hidden % 8:
        raise ValueError(f"gru_cell: the kernel needs H % 8 == 0 for bf16 W, got H={hidden}")
    if x.dtype == torch.bfloat16 and x.shape[1] % 8:
        raise ValueError(f"gru_cell: the kernel needs X % 8 == 0 for bf16 x, got X={x.shape[1]}")
    for name, t in (("h", h), ("x", x), ("w", w), ("gamma", gamma), ("beta", beta)):
        if not t.is_contiguous():
            raise ValueError(f"gru_cell: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"gru_cell: {name} must be 16-byte aligned")


_SM_COUNT: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def _forward(h, x, w, gamma, beta, eps: float, two_pass: bool, round_parts: bool) -> torch.Tensor:
    """The step without autograd: the plain version for CPU tensors, the
    kernel (one count in ``gru_cell.launches``) for CUDA tensors."""
    if h.device.type == "cpu":
        return gru_cell_plain(h, x, w, gamma, beta, eps=eps, two_pass=two_pass, round_parts=round_parts)
    if h.device.type != "cuda":
        raise ValueError(f"gru_cell: no kernel for device {h.device}")
    _check(h, x, w, gamma, beta)
    lib = LIBRARY.load()
    b, hidden = h.shape
    xdim = x.shape[1]
    out = torch.empty((b, hidden), dtype=torch.float32, device=h.device)
    if b == 0:
        return out
    bm, ts, n_split = split_k(b, hidden, xdim, _sm_count(h.device))
    partials = torch.empty((n_split, b, 3 * hidden), dtype=torch.float32, device=h.device)
    stream = current_stream(h.get_device())
    err = lib.sheeprl_gru_cell_forward(
        h.data_ptr(), x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), partials.data_ptr(),
        b, hidden, xdim, bm, ts, n_split,
        int(w.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16), int(two_pass), int(round_parts),
        float(eps), stream,
    )
    if err != 0:
        raise RuntimeError(f"gru_cell kernel launch failed: cudaError {err}")
    gru_cell.launches += 1
    return out


class _GruCellFunction(torch.autograd.Function):
    """Forward through :func:`_forward`; backward through the plain
    formulas, recomputed in f32 from the saved inputs (``_gru_bwd``)."""

    @staticmethod
    def forward(ctx, h, x, w, gamma, beta, eps, two_pass, round_parts):
        ctx.save_for_backward(h, x, w, gamma, beta)
        ctx.eps, ctx.two_pass, ctx.round_parts = eps, two_pass, round_parts
        return _forward(h, x, w, gamma, beta, eps, two_pass, round_parts)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_(n) for t, n in zip(saved, need)]
            out = gru_cell_plain(*leaves, eps=ctx.eps, two_pass=ctx.two_pass, round_parts=ctx.round_parts)
            wanted = [leaf for leaf, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(out, wanted, grad))
        grads = [next(got).to(t.dtype) if n else None for t, n in zip(saved, need)]
        return (*grads, None, None, None)


def gru_cell(
    h: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-6,
    two_pass: bool = True,
    round_parts: bool = False,
) -> torch.Tensor:
    """One LayerNorm-GRU step: (B, H) f32 state out.

    CPU tensors take :func:`gru_cell_plain`; CUDA tensors launch the kernel
    (and count one in ``gru_cell.launches``) or raise.  Under autograd the
    step is differentiable, with the backward described in the module
    docstring."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, x, w, gamma, beta)):
        return _GruCellFunction.apply(h, x, w, gamma, beta, float(eps), bool(two_pass), bool(round_parts))
    return _forward(h, x, w, gamma, beta, eps, two_pass, round_parts)


gru_cell.launches = 0

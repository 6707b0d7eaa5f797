"""The LayerNorm-GRU step: a hand-written CUDA kernel and its plain version.

Counterpart of ``sheeprl_tpu/ops/pallas_gru.py`` (forward only: the
custom-VJP backward belongs to the training slice).  One step computes

    parts = LN(concat([h, x]) @ W)          # no bias, LN over 3H
    reset, cand, update = split(parts, 3)
    h' = sigmoid(update - 1) * tanh(sigmoid(reset) * cand)
         + (1 - sigmoid(update - 1)) * h

with W stored (H + X, 3H) row-major, exactly as the JAX package stores the
``LayerNormGRUCell_0/Dense_0/kernel`` leaf.  ``two_pass=True`` is the fused
Pallas kernel's LayerNorm (variance of the centred values, ``pallas_gru.py``
:63-64); ``two_pass=False`` is the flax cell's ``max(E[p^2] - E[p]^2, 0)``
(``models.py`` :309-312).  Both use eps 1e-6.

:func:`gru_cell` is the wrapper: for tensors on the CPU it computes
:func:`gru_cell_plain`; for CUDA tensors it launches the kernel in
``csrc/gru_cell.cu`` or raises.  The kernel is compiled with ``nvcc`` for
``sm_90a`` on first use into ``build/torch_kernels/`` (rebuilt when the
source changes) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["gru_cell", "gru_cell_plain", "build_library", "split_k", "SOURCE"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gru_cell.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the product kernel's tile (csrc/gru_cell.cu: kBlockN, kChunk)
_BLOCK_N = 1024
_CHUNK = 32

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def gru_cell_plain(
    h: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-6,
    two_pass: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the step (``pallas_gru.py:reference_gru_cell``).

    The operands are rounded to W's dtype and multiplied in f32: a product
    of two bf16 values is exact in f32, so this is the bf16-operand,
    f32-accumulate product of the kernel."""
    inp = torch.cat([h.float(), x.float()], -1)
    if w.dtype != torch.float32:
        inp = inp.to(w.dtype)
    parts = inp.float() @ w.float()
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


BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the GRU kernel")


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.

    ``build_library.log`` keeps the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) and
    ``build_library.seconds`` the time the last build took (0 when the
    library was already built)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = BUILD_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        target = out_dir / f"libsheeprl_gru_{digest}.so"
        t0 = time.perf_counter()
        if not target.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_library.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_library.log}")
            os.replace(tmp, target)
        build_library.seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        lib.sheeprl_gru_cell_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.sheeprl_gru_cell_forward.restype = ctypes.c_int
        _lib = lib
        return lib


build_library.log = ""
build_library.seconds = 0.0


def split_k(batch: int, hidden: int, kdim: int, sm_count: int) -> tuple:
    """``(ks, S)``: the K slice length and the number of slices.

    Enough (batch tile, column block, slice) blocks to put about four on
    every SM, with slices a whole number of the kernel's 32-row chunks."""
    rows = 1 if batch <= 1 else 2 if batch <= 2 else 4 if batch <= 4 else 8 if batch <= 8 else 16
    tiles = -(-batch // rows) * -(-3 * hidden // _BLOCK_N)
    want = max(1, -(-4 * sm_count // tiles))
    ks = -(-kdim // want)
    ks = -(-ks // _CHUNK) * _CHUNK
    return ks, -(-kdim // ks)


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
    if hidden % 4:
        raise ValueError(f"gru_cell: the kernel needs H % 4 == 0, got H={hidden}")
    for name, t in (("h", h), ("x", x), ("w", w), ("gamma", gamma), ("beta", beta)):
        if not t.is_contiguous():
            raise ValueError(f"gru_cell: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"gru_cell: {name} must be 16-byte aligned")


def gru_cell(
    h: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-6,
    two_pass: bool = True,
) -> torch.Tensor:
    """One LayerNorm-GRU step: (B, H) f32 state out.

    CPU tensors take :func:`gru_cell_plain`; CUDA tensors launch the kernel
    (and count one in ``gru_cell.launches``) or raise."""
    if h.device.type == "cpu":
        return gru_cell_plain(h, x, w, gamma, beta, eps=eps, two_pass=two_pass)
    if h.device.type != "cuda":
        raise ValueError(f"gru_cell: no kernel for device {h.device}")
    _check(h, x, w, gamma, beta)
    lib = build_library()
    b, hidden = h.shape
    xdim = x.shape[1]
    out = torch.empty((b, hidden), dtype=torch.float32, device=h.device)
    if b == 0:
        return out
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    ks, n_split = split_k(b, hidden, hidden + xdim, sms)
    partials = torch.empty((n_split, b, 3 * hidden), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = lib.sheeprl_gru_cell_forward(
        h.data_ptr(), x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), partials.data_ptr(),
        b, hidden, xdim, ks, n_split,
        int(w.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16), int(two_pass),
        float(eps), stream,
    )
    if err != 0:
        raise RuntimeError(f"gru_cell kernel launch failed: cudaError {err}")
    gru_cell.launches += 1
    return out


gru_cell.launches = 0

"""The sequence LayerNorm-GRU: T gated steps in one hand-written CUDA kernel,
its plain version, and the autograd op that training runs.

Counterpart of ``sheeprl_tpu/ops/seq_gru.py``.  For t = 0 .. T-1, from
``h = h0``:

    hg    = (1 - is_first[t]) * h + is_first[t] * init_rec
    parts = LN(concat([hg, xs[t]]) @ W)     # no bias, LN over 3H
    reset, cand, update = split(parts, 3)
    h     = sigmoid(update - 1) * tanh(sigmoid(reset) * cand)
            + (1 - sigmoid(update - 1)) * hg
    hs[t] = h

with W stored (H + X, 3H) row-major (the flax ``Dense_0/kernel`` layout)
and the flax cell's one-pass LayerNorm, ``var = max(E[p^2] - E[p]^2, 0)``,
eps 1e-6 (``seq_gru.py:_ln``): one step is ``gru_cell_plain(hg, x, ...,
two_pass=False)``.

:func:`gru_sequence` is the op.  Its forward is the kernels in
``csrc/seq_gru.cu`` for CUDA tensors (or it raises) and
:func:`gru_sequence_plain` for CPU tensors.  On the card it takes one of two
routes, chosen by shape in :func:`sequence_route`:

- ``cluster``: the input half of every step's product, ``xs @ W[H:]``,
  first, for all T*B rows in one launch of ``csrc/gru_cell.cu``'s product
  (:func:`gru_input_product`), then the recurrence on one cluster of 16
  blocks that keep W[:H] and the state in shared memory;
- ``grid``: the whole sequence in one cooperative launch of one block per
  SM, each holding its columns of the whole W.

When a gradient is needed it
runs as a ``torch.autograd.Function`` whose backward is the counterpart of
``seq_gru.py:_bwd``, the efficient BPTT: the pre-LN activations of every
step are recomputed from the saved states in one (T*B, H+X) @ (H+X, 3H)
product, the reverse loop carries only dh, and dW, dxs, dgamma, dbeta and
d init_rec are one contraction each.  JAX computes that backward in XLA,
outside any Pallas kernel, so here its products go to ``torch.matmul``.
``is_first`` gets no gradient.

The kernels take f32 operands only; any other dtype on a CUDA tensor
raises.  The plain version also takes a bf16 W (the operands rounded to it,
the product in f32), as JAX's ``matmul_dtype`` does.
"""

from __future__ import annotations

import ctypes
import torch

from sheeprl_tpu_torch.ops import gru_cell as _cell
from sheeprl_tpu_torch.ops.build import CudaLibrary, current_stream
from sheeprl_tpu_torch.ops.gru_cell import gru_cell_plain

__all__ = [
    "CLUSTER_BLOCKS",
    "CLUSTER_MAX_BATCH",
    "LIBRARY",
    "MAX_UNITS",
    "cluster_smem_bytes",
    "grid_smem_bytes",
    "gru_input_product",
    "gru_sequence",
    "gru_sequence_plain",
    "sequence_grid",
    "sequence_route",
]

# hidden units a block of the grid route owns at most (csrc/seq_gru.cu: kMaxUnits)
MAX_UNITS = 8
# the cluster route (csrc/seq_gru.cu: kCluster, and the two 16-row tiles it takes)
CLUSTER_BLOCKS = 16
CLUSTER_MAX_BATCH = 32


def _bind(lib: ctypes.CDLL) -> None:
    lib.sheeprl_gru_sequence_forward.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.sheeprl_gru_sequence_forward.restype = ctypes.c_int
    lib.sheeprl_gru_sequence_cluster.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.sheeprl_gru_sequence_cluster.restype = ctypes.c_int
    lib.sheeprl_gru_sequence_cluster_prepare.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sheeprl_gru_sequence_cluster_prepare.restype = ctypes.c_int
    lib.sheeprl_gru_sequence_cluster_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sheeprl_gru_sequence_cluster_smem.restype = ctypes.c_longlong
    lib.sheeprl_gru_sequence_smem_optin.argtypes = []
    lib.sheeprl_gru_sequence_smem_optin.restype = ctypes.c_int


LIBRARY = CudaLibrary("seq_gru.cu", "libsheeprl_seq_gru", _bind)


def gru_sequence_plain(
    h0: torch.Tensor,
    xs: torch.Tensor,
    w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    is_first: torch.Tensor,
    init_rec: torch.Tensor,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version of the sequence (``gru_sequence_reference``):
    a loop of T one-pass LayerNorm-GRU steps.  (T, B, H) f32."""
    is_first = is_first.reshape(*xs.shape[:2], 1).float()
    h = h0.float()
    init_rec = init_rec.float()
    out = []
    for t in range(xs.shape[0]):
        first = is_first[t]
        hg = (1.0 - first) * h + first * init_rec
        h = gru_cell_plain(hg, xs[t], w, gamma, beta, eps=eps, two_pass=False)
        out.append(h)
    return torch.stack(out)


def sequence_grid(hidden: int, sm_count: int) -> tuple:
    """``(units, blocks)``: the hidden units each block of the cooperative
    grid owns, and the number of blocks, one per SM where H allows."""
    units = -(-hidden // sm_count)
    return units, -(-hidden // units)


def cluster_smem_bytes(hidden: int, batch: int) -> int:
    """Shared memory a block of the cluster route needs (0 where the route
    cannot take the shape: H not a multiple of 128, or B over 32).

    Block r owns U = H/16 units: W[:H]'s 3U columns (H x 3U f32), the whole
    state hg in 16-row tiles (16 ceil(B/16) x H, 4 bytes an element), every
    block's row sum and sum of squares (16 x rows x 2), its groups of 8
    units' (U/8 x rows x 2) and two 8-byte mbarriers (the state's and the
    row sums')."""
    if hidden <= 0 or hidden % 128 or not 0 < batch <= CLUSTER_MAX_BATCH:
        return 0
    rows = 16 * -(-batch // 16)
    units = hidden // CLUSTER_BLOCKS
    return 4 * (3 * hidden * hidden // 16 + rows * hidden + CLUSTER_BLOCKS * rows * 2 + units // 8 * rows * 2) + 16


def grid_smem_bytes(hidden: int, xdim: int, batch: int, sm_count: int) -> int:
    """Shared memory a block of the grid route needs at the least: its
    columns of the whole W (3S x (H + X) f32), z and the statistics of every
    row, every block's partial sums, and one staged row of [hg, x]."""
    units, blocks = sequence_grid(hidden, sm_count)
    k = hidden + xdim
    return 4 * (3 * units * k + batch * 3 * units + 2 * batch + 2 * batch * blocks + k)


def sequence_route(hidden: int, xdim: int, batch: int, smem_optin: int, sm_count: int) -> str:
    """Which kernel runs a sequence of this shape on a card with
    ``smem_optin`` bytes of shared memory a block and ``sm_count`` SMs:
    ``"cluster"`` wherever the cluster route's W[:H] slice and state fit
    (:func:`cluster_smem_bytes`), else ``"grid"`` where its blocks hold at
    most :data:`MAX_UNITS` units and fit.  Raises ``ValueError`` for a
    shape neither takes."""
    need = cluster_smem_bytes(hidden, batch)
    if 0 < need <= smem_optin:
        return "cluster"
    units, _ = sequence_grid(hidden, sm_count)
    if units > MAX_UNITS:
        raise ValueError(
            f"gru_sequence: H={hidden} needs {units} units a block on {sm_count} SMs; "
            f"the kernel holds at most {MAX_UNITS}"
        )
    if grid_smem_bytes(hidden, xdim, batch, sm_count) > smem_optin:
        raise ValueError(f"gru_sequence: H={hidden}, X={xdim}, B={batch} does not fit {smem_optin} bytes a block")
    return "grid"


def gru_input_product(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(M, X) @ (X, N) -> (M, N) f32, the cluster route's input product:
    ``x @ w`` in f32 for CPU tensors; for CUDA tensors one launch of
    ``csrc/gru_cell.cu``'s 3xTF32 product (one count in
    ``gru_input_product.launches``) into ``out`` (contiguous (M, N) f32, or
    a new tensor) or a raise.  Contiguous f32 operands, 16-byte aligned, X
    and N multiples of 4."""
    if x.device.type == "cpu":
        return x.float() @ w.float()
    m, xdim = x.shape
    n = w.shape[1]
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("gru_input_product: the kernel takes float32 operands")
    if w.shape[0] != xdim or xdim % 4 or n % 4 or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"gru_input_product: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit the kernel")
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    if (x.data_ptr() | w.data_ptr()) % 16:
        raise ValueError("gru_input_product: x and w must be 16-byte aligned")
    index = x.get_device()
    bm = _cell.tile_rows(m, n // 3, _cell._sm_count(x.device))
    err = _cell.LIBRARY.load().sheeprl_gru_input_product(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, xdim, n, bm, current_stream(index)
    )
    if err != 0:
        raise RuntimeError(f"gru_input_product kernel launch failed: cudaError {err}")
    gru_input_product.launches += 1
    return out


gru_input_product.launches = 0


def _check(h0, xs, w, gamma, beta, is_first, init_rec) -> None:
    dev = h0.device
    named = (("xs", xs), ("w", w), ("gamma", gamma), ("beta", beta), ("is_first", is_first), ("init_rec", init_rec))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"gru_sequence: {name} is on {t.device}, h0 is on {dev}")
    if h0.dim() != 2 or xs.dim() != 3 or w.dim() != 2:
        raise ValueError("gru_sequence: h0 must be (B, H), xs (T, B, X) and w (H + X, 3H)")
    b, hidden = h0.shape
    steps, xb, xdim = xs.shape
    if xb != b or tuple(init_rec.shape) != (b, hidden) or tuple(is_first.shape) != (steps, b, 1):
        raise ValueError(
            f"gru_sequence: xs {tuple(xs.shape)}, init_rec {tuple(init_rec.shape)} and is_first "
            f"{tuple(is_first.shape)} do not match h0 {tuple(h0.shape)}"
        )
    if tuple(w.shape) != (hidden + xdim, 3 * hidden):
        raise ValueError(f"gru_sequence: w is {tuple(w.shape)}, expected {(hidden + xdim, 3 * hidden)}")
    if tuple(gamma.shape) != (3 * hidden,) or tuple(beta.shape) != (3 * hidden,):
        raise ValueError("gru_sequence: gamma and beta must be (3H,)")
    if hidden % 4 or xdim % 4:
        raise ValueError(f"gru_sequence: the kernel needs H and X multiples of 4, got H={hidden}, X={xdim}")
    for name, t in (("h0", h0), *named):
        if t.dtype != torch.float32:
            raise TypeError(f"gru_sequence: the kernel takes float32 operands, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gru_sequence: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"gru_sequence: {name} must be 16-byte aligned")


_OPTIN: dict = {}
# (device index, H, 16-row tiles) whose cluster launch is prepared
_CLUSTER_READY: set = set()


def _smem_optin(index: int) -> int:
    """Shared memory a block may opt in to on device ``index``."""
    if index not in _OPTIN:
        with torch.cuda.device(index):
            _OPTIN[index] = int(LIBRARY.load().sheeprl_gru_sequence_smem_optin())
    return _OPTIN[index]


def _forward(h0, xs, w, gamma, beta, is_first, init_rec, eps: float) -> torch.Tensor:
    """The sequence without autograd: the plain version for CPU tensors, the
    route's kernels (one count in ``gru_sequence.launches`` for the
    recurrence) for CUDA tensors."""
    if h0.device.type == "cpu":
        return gru_sequence_plain(h0, xs, w, gamma, beta, is_first, init_rec, eps=eps)
    if h0.device.type != "cuda":
        raise ValueError(f"gru_sequence: no kernel for device {h0.device}")
    _check(h0, xs, w, gamma, beta, is_first, init_rec)
    steps, b, xdim = xs.shape
    hidden = h0.shape[1]
    hs = torch.empty((steps, b, hidden), dtype=torch.float32, device=h0.device)
    if steps == 0 or b == 0:
        return hs
    index = h0.get_device()
    sms = _cell._sm_count(h0.device)
    route = sequence_route(hidden, xdim, b, _smem_optin(index), sms)
    lib = LIBRARY.load()
    stream = current_stream(index)
    with torch.cuda.device(index):
        if route == "cluster":
            tiles = -(-b // 16)
            if (index, hidden, tiles) not in _CLUSTER_READY:
                err = lib.sheeprl_gru_sequence_cluster_prepare(hidden, b)
                if err != 0:
                    raise RuntimeError(f"gru_sequence cluster route at H={hidden}, B={b} refused: cudaError {err}")
                _CLUSTER_READY.add((index, hidden, tiles))
            # one allocation: zx (T*B, 3H), then the exchange buffer (16 tiles rows x H)
            n = steps * b * 3 * hidden
            scratch = torch.empty(n + 16 * tiles * hidden, dtype=torch.float32, device=h0.device)
            zx = gru_input_product(xs.view(steps * b, xdim), w[hidden:], out=scratch[:n].view(steps * b, 3 * hidden))
            exchange = scratch[n:]
            err = lib.sheeprl_gru_sequence_cluster(
                h0.data_ptr(), zx.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                is_first.data_ptr(), init_rec.data_ptr(), hs.data_ptr(), exchange.data_ptr(),
                steps, b, hidden, float(eps), stream,
            )
        else:
            units, blocks = sequence_grid(hidden, sms)
            partials = torch.empty((blocks, b, 2), dtype=torch.float32, device=h0.device)
            err = lib.sheeprl_gru_sequence_forward(
                h0.data_ptr(), xs.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                is_first.data_ptr(), init_rec.data_ptr(), hs.data_ptr(), partials.data_ptr(),
                steps, b, hidden, xdim, units, float(eps), stream,
            )
    if err != 0:
        raise RuntimeError(f"gru_sequence {route} kernel launch failed: cudaError {err}")
    gru_sequence.launches += 1
    return hs


def _backward(h0, xs, w, gamma, beta, is_first, init_rec, hs, grad, eps: float):
    """``seq_gru.py:_bwd``: (dh0, dxs, dw, dgamma, dbeta, dinit_rec)."""
    steps, b, xdim = xs.shape
    hidden = h0.shape[-1]
    f32 = torch.float32
    h_prev = torch.cat([h0[None].to(f32), hs[:-1]], 0)  # (T, B, H)
    hg = (1.0 - is_first) * h_prev + is_first * init_rec.to(f32)

    # batched recompute of every step's pre-LN activations and gates
    inp = torch.cat([hg, xs.to(f32)], -1)
    if w.dtype != f32:
        inp = inp.to(w.dtype)
    z = inp.to(f32) @ w.to(f32)  # (T, B, 3H)
    mu = z.mean(-1, keepdim=True)
    var = torch.clamp((z * z).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    zhat = (z - mu) * inv
    parts = zhat * gamma.to(f32) + beta.to(f32)
    p1, p2, p3 = parts.split(hidden, -1)
    reset = torch.sigmoid(p1)
    cand = torch.tanh(reset * p2)
    update = torch.sigmoid(p3 - 1.0)
    # d parts / d h_total, per gate: everything in the reverse loop that
    # does not depend on dh, batched over the sequence
    dtanh = update * (1.0 - cand * cand)
    dparts_dh = torch.stack(
        [dtanh * p2 * reset * (1.0 - reset), dtanh * reset, (cand - hg) * update * (1.0 - update)], -2
    )  # (T, B, 3, H)
    keep = 1.0 - is_first
    w_h_t = w[:hidden].to(f32).t()  # (3H, H)
    g32 = gamma.to(f32)

    dh = torch.zeros((b, hidden), dtype=f32, device=hs.device)
    dh_tots, dzs, dhgs = [], [], []
    for t in range(steps - 1, -1, -1):
        dh_tot = dh + grad[t]
        dzhat = (dh_tot[:, None, :] * dparts_dh[t]).reshape(b, 3 * hidden) * g32
        zt = zhat[t]
        dz = inv[t] * (dzhat - dzhat.mean(-1, keepdim=True) - zt * (dzhat * zt).mean(-1, keepdim=True))
        # into the carry: through the product's h rows and the convex update
        dhg = torch.addmm((1.0 - update[t]) * dh_tot, dz, w_h_t)
        dh = keep[t] * dhg
        dh_tots.append(dh_tot)
        dzs.append(dz)
        dhgs.append(dhg)
    dh_tot = torch.stack(dh_tots[::-1])  # (T, B, H)
    dz = torch.stack(dzs[::-1]).reshape(steps * b, 3 * hidden)
    dhg = torch.stack(dhgs[::-1])

    # everything else batches over T*B: one contraction each
    dparts = (dh_tot[:, :, None, :] * dparts_dh).reshape(steps * b, 3 * hidden)
    dw = inp.to(f32).reshape(steps * b, hidden + xdim).t() @ dz
    dxs = (dz @ w[hidden:].to(f32).t()).reshape(steps, b, xdim)
    dgamma = (dparts * zhat.reshape(steps * b, 3 * hidden)).sum(0)
    dbeta = dparts.sum(0)
    dinit = (is_first * dhg).sum(0)
    return (
        dh.to(h0.dtype), dxs.to(xs.dtype), dw.to(w.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
        dinit.to(init_rec.dtype),
    )


class _GruSequenceFunction(torch.autograd.Function):
    """Forward through :func:`_forward`; backward by :func:`_backward`."""

    @staticmethod
    def forward(ctx, h0, xs, w, gamma, beta, is_first, init_rec, eps):
        hs = _forward(h0, xs, w, gamma, beta, is_first, init_rec, eps)
        ctx.save_for_backward(h0, xs, w, gamma, beta, is_first, init_rec, hs)
        ctx.eps = eps
        return hs

    @staticmethod
    def backward(ctx, grad):
        h0, xs, w, gamma, beta, is_first, init_rec, hs = ctx.saved_tensors
        grads = _backward(h0, xs, w, gamma, beta, is_first, init_rec, hs, grad.float(), ctx.eps)
        need = ctx.needs_input_grad
        dh0, dxs, dw, dgamma, dbeta, dinit = (g if n else None for g, n in zip(grads, need[:5] + need[6:7]))
        return dh0, dxs, dw, dgamma, dbeta, None, dinit, None


def gru_sequence(
    h0: torch.Tensor,
    xs: torch.Tensor,
    w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    is_first: torch.Tensor,
    init_rec: torch.Tensor,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """T gated LayerNorm-GRU steps: h0 (B, H), xs (T, B, X), w (H + X, 3H),
    gamma/beta (3H,), is_first (T, B, 1) or (T, B), init_rec (B, H) ->
    hs (T, B, H) f32.

    CPU tensors take :func:`gru_sequence_plain`; CUDA tensors launch the
    recurrence kernel of :func:`sequence_route`'s route once (and count one
    in ``gru_sequence.launches``), after the input product on the cluster
    route, or raise.
    Under autograd the op is differentiable in every input but
    ``is_first``, with the backward described in the module docstring."""
    is_first = is_first.reshape(*xs.shape[:2], 1).float()
    args = (h0.contiguous(), xs.contiguous(), w.contiguous(), gamma, beta, is_first.contiguous(), init_rec.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GruSequenceFunction.apply(*args, float(eps))
    return _forward(*args, float(eps))


gru_sequence.launches = 0

"""The replay gathers: hand-written CUDA kernels and their plain versions.

The window gather (sequence replay) and the flat-transition gather
(SAC-family replay), one kernel body in ``csrc/gather.cu``.

Counterpart of ``sheeprl_tpu/ops/pallas_gather.py:gather_windows_fused``
together with the ``swapaxes`` that ``DeviceReplayCache._window_gather_out``
applies to its result.  For rings ``bufs[k]`` (cap, n_envs, *feat) and
(flat,) int32 ``starts``/``envs`` with flat = n_samples * batch:

    out[k][s, t, b] = bufs[k][(starts[f] + t) % cap, envs[f]],  f = s * batch + b

one (n_samples, L, batch, *feat) tensor per key, bytes exact.  And of
``pallas_gather.py:gather_transitions_fused``: every key's rows
``bufs[k][rows[f], envs[f]]``, plus successor rows for the next keys.

For rings on the CPU the wrappers compute the plain versions (per-key
advanced indexing, as the JAX package's lax branch does,
``device_buffer.py:163-172`` and ``:281-288``).  For CUDA rings they launch
the kernel once for all keys (one count in ``gather_windows.launches`` or
``gather_transitions.launches``) or raise: :func:`gather_plan` checks a set
of rings once and lays out the C entry's table, :func:`_plan_for` caches it
on every ring's pointer, shape and dtype, and a call checks only its
indices, allocates one block for all its outputs (each a contiguous,
16-byte-aligned view of it) and makes one ``ctypes`` call.
"""

from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from typing import Dict, Sequence

import torch

from sheeprl_tpu_torch.ops.build import CudaLibrary, current_stream

__all__ = [
    "LIBRARY",
    "GatherPlan",
    "gather_plan",
    "gather_transitions",
    "gather_transitions_plain",
    "gather_windows",
    "gather_windows_plain",
    "window_cells",
]


MAX_ENTRIES = 32  # csrc/gather.cu: kMaxEntries, the most outputs of one call


class _PlanC(ctypes.Structure):
    """``csrc/gather.cu:GatherPlan``, field for field."""

    _fields_ = [
        ("src", ctypes.c_void_p * MAX_ENTRIES),
        ("row_bytes", ctypes.c_longlong * MAX_ENTRIES),
        ("shift", ctypes.c_int * MAX_ENTRIES),
        ("next", ctypes.c_int * MAX_ENTRIES),
        ("first", ctypes.c_int * (MAX_ENTRIES + 1)),
        ("n", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("n_envs", ctypes.c_int),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    lib.sheeprl_gather_transitions.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.sheeprl_gather_transitions.restype = ctypes.c_int
    lib.sheeprl_gather_windows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.sheeprl_gather_windows.restype = ctypes.c_int
    lib.sheeprl_gather_max_entries.argtypes = []
    lib.sheeprl_gather_max_entries.restype = ctypes.c_int
    lib.sheeprl_gather_plan_bytes.argtypes = []
    lib.sheeprl_gather_plan_bytes.restype = ctypes.c_size_t
    if (lib.sheeprl_gather_max_entries(), lib.sheeprl_gather_plan_bytes()) != (MAX_ENTRIES, ctypes.sizeof(_PlanC)):
        raise RuntimeError("gather: the library's plan layout differs from ops/gather.py:_PlanC")


LIBRARY = CudaLibrary("gather.cu", "libsheeprl_gather", _bind)


def window_cells(starts: torch.Tensor, envs: torch.Tensor, *, seq_len: int, batch_size: int, cap: int, n_envs: int):
    """Flat ring cells ``row * n_envs + env`` in output order
    (n_samples, L, batch): the index a per-key ``index_select`` over the
    flattened ring needs to produce the same output."""
    t_idx = (starts.long()[:, None] + torch.arange(seq_len, device=starts.device)[None, :]) % cap  # (flat, L)
    cell = t_idx * n_envs + envs.long()[:, None]
    n_samples = starts.shape[0] // batch_size
    return cell.reshape(n_samples, batch_size, seq_len).transpose(1, 2).reshape(-1)


def gather_windows_plain(
    bufs: Dict[str, torch.Tensor], starts: torch.Tensor, envs: torch.Tensor, *, seq_len: int, batch_size: int
) -> Dict[str, torch.Tensor]:
    """Per-key advanced indexing, then (n_samples, batch, L) -> (n_samples, L, batch)."""
    first = next(iter(bufs.values()))
    cap = first.shape[0]
    n_samples = starts.shape[0] // batch_size
    t_idx = (starts.long()[:, None] + torch.arange(seq_len, device=starts.device)[None, :]) % cap
    e_idx = envs.long()[:, None]
    out = {}
    for k, buf in bufs.items():
        g = buf[t_idx, e_idx]  # (flat, L, *feat)
        g = g.reshape(n_samples, batch_size, seq_len, *buf.shape[2:])
        out[k] = g.transpose(1, 2).contiguous()
    return out


def gather_transitions_plain(
    bufs: Dict[str, torch.Tensor], rows: torch.Tensor, envs: torch.Tensor, *, next_keys: Sequence[str] = ()
) -> Dict[str, torch.Tensor]:
    """Per-key advanced indexing (``device_buffer.py:163-172``): every key's
    (flat, *feat) rows, and ``next_<k>`` from row ``(row + 1) % cap`` for the
    ``next_keys``."""
    cap = next(iter(bufs.values())).shape[0]
    r, e = rows.long(), envs.long()
    out = {k: buf[r, e] for k, buf in bufs.items()}
    if next_keys:
        nr = (r + 1) % cap
        for k in next_keys:
            out[f"next_{k}"] = bufs[k][nr, e]
    return out


# ------------------------------------------------------- plans and the kernel
class _Layout:
    """The outputs of one call as views of one uint8 block: entry ``e`` at a
    byte offset that is the sum of the entries before it, each rounded up to
    16 bytes (``csrc/gather.cu`` places them the same way), each of shape
    ``(*lead, *feat)``.  ``dtypes`` are the typed views of the block the
    entries need (uint8 first); ``views`` each entry's (typed view, shape,
    stride, offset)."""

    __slots__ = ("nbytes", "dtypes", "views")

    def __init__(self, specs, lead: tuple):
        self.dtypes = [torch.uint8]
        self.views = []
        rows = math.prod(lead)
        off = 0
        for feat, dtype in specs:
            if dtype not in self.dtypes:
                self.dtypes.append(dtype)
            shape = (*lead, *feat)
            strides, step = [], 1
            for d in reversed(shape):  # contiguous, as torch strides it
                strides.insert(0, step)
                step *= max(d, 1)
            self.views.append((self.dtypes.index(dtype), shape, tuple(strides), off // dtype.itemsize))
            off = (off + rows * math.prod(feat) * dtype.itemsize + 15) // 16 * 16
        self.nbytes = off


class GatherPlan:
    """What a call of either gather needs of its rings, worked out once for a
    set of rings (:func:`gather_plan`): the output entries, each output's
    feature shape and dtype, and the kernel's plan (``c``: each entry's ring
    pointer, row bytes, successor flag and chunk width, the prefix of the
    entries' chunk counts, ``cap`` and ``n_envs``).  It holds no reference to
    a ring."""

    __slots__ = ("names", "specs", "device", "device_index", "c", "c_address", "chunks_per_row", "layouts")

    def __init__(self, names, specs, device, c, chunks_per_row):
        self.names = names
        self.specs = specs
        self.device = device
        self.device_index = device.index if device.index is not None else -1
        self.c = c
        self.c_address = ctypes.addressof(c)  # what the C entry takes; ``c`` keeps it alive
        self.chunks_per_row = chunks_per_row
        self.layouts = {}  # lead dims -> _Layout

    def layout(self, *lead: int) -> _Layout:
        """The outputs' layout for leading dims ``lead``: (flat,) for the
        transitions, (n_samples, L, batch) for the windows."""
        layout = self.layouts.get(lead)
        if layout is None:
            if len(self.layouts) >= 4:
                self.layouts.clear()
            layout = self.layouts[lead] = _Layout(self.specs, lead)
        return layout

    def outputs(self, layout: _Layout, like: torch.Tensor) -> tuple:
        """One block on ``like``'s device and the outputs as views of it."""
        block = like.new_empty((layout.nbytes,), dtype=torch.uint8)
        typed = [block] + [block.view(dtype) for dtype in layout.dtypes[1:]]
        return block, [typed[b].as_strided(shape, stride, off) for b, shape, stride, off in layout.views]


def _chunk_shift(row_bytes: int, base: int) -> int:
    """log2 of the widest chunk (16, 4 or 1 bytes) that divides an entry's
    row bytes and its ring's base address: every row of the ring then starts
    on a chunk (every output starts on 16 bytes of the call's block)."""
    for shift in (4, 2):
        if (row_bytes | base) % (1 << shift) == 0:
            return shift
    return 0


def gather_plan(bufs: Dict[str, torch.Tensor], next_keys: Sequence[str] = ()) -> GatherPlan:
    """Check the rings and build their plan (no device work): stored keys
    first, then ``next_<k>`` for ``next_keys`` (a stored key named like a
    successor output is replaced by it, as in the plain version).  The
    window gather's plan is the one with no next keys."""
    name = "gather"
    if not bufs:
        raise ValueError(f"{name}: no buffers")
    first = next(iter(bufs.values()))
    cap, n_envs = first.shape[:2]
    for k, buf in bufs.items():
        if buf.device != first.device:
            raise ValueError(f"{name}: '{k}' is on {buf.device}, the rings on {first.device}")
        if buf.dim() < 2 or tuple(buf.shape[:2]) != (cap, n_envs):
            raise ValueError(f"{name}: '{k}' is {tuple(buf.shape)}, the rings are ({cap}, {n_envs}, ...)")
        if not buf.is_contiguous():
            raise ValueError(f"{name}: '{k}' must be contiguous")
    missing = [k for k in next_keys if k not in bufs]
    if missing:
        raise KeyError(f"{name}: next keys {missing} are not buffers")
    nxt = [(f"next_{k}", k, 1) for k in next_keys]
    entries = [(k, k, 0) for k in bufs if k not in {out for out, _, _ in nxt}] + nxt
    if len(entries) > MAX_ENTRIES:
        raise ValueError(f"{name}: {len(entries)} outputs, the kernel takes at most {MAX_ENTRIES}")
    c = _PlanC()
    c.n, c.cap, c.n_envs = len(entries), int(cap), int(n_envs)
    chunks = 0
    for e, (_, k, flag) in enumerate(entries):
        buf = bufs[k]
        row_bytes = buf[0, 0].numel() * buf.element_size()
        shift = _chunk_shift(row_bytes, buf.data_ptr())
        c.src[e], c.row_bytes[e], c.shift[e], c.next[e], c.first[e] = buf.data_ptr(), row_bytes, shift, flag, chunks
        chunks += row_bytes >> shift
    c.first[len(entries)] = chunks
    specs = tuple((tuple(bufs[k].shape[2:]), bufs[k].dtype) for _, k, _ in entries)
    return GatherPlan(tuple(out for out, _, _ in entries), specs, first.device, c, chunks)


_PLANS: "OrderedDict[tuple, GatherPlan]" = OrderedDict()
_PLANS_KEPT = 8  # a cache's rings make one plan a gather; a few caches (or tests) share the process


def _plan_for(bufs: Dict[str, torch.Tensor], next_keys: Sequence[str]) -> GatherPlan:
    """The plan of these rings, from the cache when every ring's pointer,
    shape and dtype (and the next keys) are those it was built for: a ring
    replaced by another tensor gets a new plan, so no stale pointer is
    launched."""
    key = (tuple(next_keys), *[(k, v.data_ptr(), v.shape, v.dtype) for k, v in bufs.items()])
    plan = _PLANS.get(key)
    if plan is None:
        plan = gather_plan(bufs, next_keys)
        _PLANS[key] = plan
        if len(_PLANS) > _PLANS_KEPT:
            _PLANS.popitem(last=False)
    return plan


def _check_indices(name: str, plan: GatherPlan, rows: torch.Tensor, envs: torch.Tensor) -> None:
    for arg, t in (("indices", rows), ("envs", envs)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name}: {arg} must be a contiguous 1-d int32 tensor")
        if t.device != plan.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the rings on {plan.device}")
    if rows.shape != envs.shape:
        raise ValueError(f"{name}: {rows.shape[0]} indices, {envs.shape[0]} envs")


def _indices_ok(plan: GatherPlan, idx: torch.Tensor, envs: torch.Tensor) -> bool:
    """The indices' dtype, layout, length and device, as the kernel takes them."""
    return (
        idx.dtype is torch.int32 and envs.dtype is torch.int32 and idx.dim() == 1 and idx.is_contiguous()
        and envs.is_contiguous() and idx.shape == envs.shape
        and idx.get_device() == plan.device_index == envs.get_device()
    )


def gather_windows(
    bufs: Dict[str, torch.Tensor], starts: torch.Tensor, envs: torch.Tensor, *, seq_len: int, batch_size: int
) -> Dict[str, torch.Tensor]:
    """Every key's (n_samples, L, batch, *feat) windows.

    CPU rings take :func:`gather_windows_plain`; CUDA rings launch the
    kernel in ``csrc/gather.cu`` once for all keys (one count in
    ``gather_windows.launches``) or raise.  The rings' checks and the
    kernel's table are made once per set of rings (:func:`_plan_for`).
    ``starts`` must already lie in [0, cap) and ``envs`` in [0, n_envs)."""
    if not starts.is_cuda:
        if starts.device.type == "cpu":
            return gather_windows_plain(bufs, starts, envs, seq_len=seq_len, batch_size=batch_size)
        raise ValueError(f"gather_windows: no kernel for device {starts.device}")
    plan = _plan_for(bufs, ())
    if not _indices_ok(plan, starts, envs):
        _check_indices("gather_windows", plan, starts, envs)
    flat = starts.shape[0]
    if batch_size < 1 or flat % batch_size:
        raise ValueError(f"gather_windows: {flat} starts for batches of {batch_size}")
    if not 0 < seq_len <= plan.c.cap:
        raise ValueError(f"gather_windows: seq_len {seq_len} outside (0, {plan.c.cap}]")
    n_samples = flat // batch_size
    block, outs = plan.outputs(plan.layout(n_samples, seq_len, batch_size), starts)
    if n_samples and plan.chunks_per_row:
        err = LIBRARY.load().sheeprl_gather_windows(
            plan.c_address, block.data_ptr(), starts.data_ptr(), envs.data_ptr(), n_samples, seq_len, batch_size,
            current_stream(plan.device_index),
        )
        if err != 0:
            raise RuntimeError(f"gather_windows kernel launch failed: cudaError {err}")
        gather_windows.launches += 1
    return dict(zip(plan.names, outs))


gather_windows.launches = 0


def gather_transitions(
    bufs: Dict[str, torch.Tensor], rows: torch.Tensor, envs: torch.Tensor, *, next_keys: Sequence[str] = ()
) -> Dict[str, torch.Tensor]:
    """Counterpart of ``pallas_gather.py:gather_transitions_fused``: every
    key's (flat, *feat) rows, plus ``next_<k>`` successor rows for
    ``next_keys``.

    CPU rings take :func:`gather_transitions_plain`; CUDA rings launch the
    kernel in ``csrc/gather.cu`` once for every key (one count in
    ``gather_transitions.launches``) or raise.  The rings' checks and the
    kernel's table are made once per set of rings (:func:`_plan_for`).
    ``rows`` must lie in [0, cap) and ``envs`` in [0, n_envs)."""
    if not rows.is_cuda:
        if rows.device.type == "cpu":
            return gather_transitions_plain(bufs, rows, envs, next_keys=next_keys)
        raise ValueError(f"gather_transitions: no kernel for device {rows.device}")
    plan = _plan_for(bufs, next_keys)
    if not _indices_ok(plan, rows, envs):
        _check_indices("gather_transitions", plan, rows, envs)
    flat = rows.shape[0]
    block, outs = plan.outputs(plan.layout(flat), rows)
    if flat and plan.chunks_per_row:
        err = LIBRARY.load().sheeprl_gather_transitions(
            plan.c_address, block.data_ptr(), rows.data_ptr(), envs.data_ptr(), flat, current_stream(plan.device_index)
        )
        if err != 0:
            raise RuntimeError(f"gather_transitions kernel launch failed: cudaError {err}")
        gather_transitions.launches += 1
    return dict(zip(plan.names, outs))


gather_transitions.launches = 0

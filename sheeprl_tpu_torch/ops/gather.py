"""The replay gathers: hand-written CUDA kernels and their plain versions.

The window gather (sequence replay) and, below it, the flat-transition
gather (SAC-family replay).

Counterpart of ``sheeprl_tpu/ops/pallas_gather.py:gather_windows_fused``
together with the ``swapaxes`` that ``DeviceReplayCache._window_gather_out``
applies to its result.  For rings ``bufs[k]`` (cap, n_envs, *feat) and
(flat,) int32 ``starts``/``envs`` with flat = n_samples * batch:

    out[k][s, t, b] = bufs[k][(starts[f] + t) % cap, envs[f]],  f = s * batch + b

one (n_samples, L, batch, *feat) tensor per key, bytes exact.

:func:`gather_windows` is the wrapper: for rings on the CPU it computes
:func:`gather_windows_plain` (per-key advanced indexing, as the JAX
package's lax branch does, ``device_buffer.py:281-288``); for CUDA rings it
launches the kernel in ``csrc/gather_windows.cu`` once for all keys (and
counts one in ``gather_windows.launches``) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from sheeprl_tpu_torch.ops.build import CudaLibrary

__all__ = [
    "LIBRARY",
    "TRANSITIONS_LIBRARY",
    "gather_transitions",
    "gather_transitions_plain",
    "gather_windows",
    "gather_windows_plain",
    "window_cells",
]


def _bind(lib: ctypes.CDLL) -> None:
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.sheeprl_gather_windows.argtypes = (
        [ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    lib.sheeprl_gather_windows.restype = ctypes.c_int
    lib.sheeprl_gather_windows_max_keys.argtypes = []
    lib.sheeprl_gather_windows_max_keys.restype = ctypes.c_int


def _bind_transitions(lib: ctypes.CDLL) -> None:
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.sheeprl_gather_transitions.argtypes = (
        [ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    lib.sheeprl_gather_transitions.restype = ctypes.c_int
    lib.sheeprl_gather_transitions_max_entries.argtypes = []
    lib.sheeprl_gather_transitions_max_entries.restype = ctypes.c_int


LIBRARY = CudaLibrary("gather_windows.cu", "libsheeprl_gather", _bind)
TRANSITIONS_LIBRARY = CudaLibrary("gather_transitions.cu", "libsheeprl_gather_transitions", _bind_transitions)


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


def _check(bufs: Dict[str, torch.Tensor], starts, envs, seq_len: int, batch_size: int, name: str = "gather_windows") -> None:
    if not bufs:
        raise ValueError(f"{name}: no buffers")
    first = next(iter(bufs.values()))
    cap, n_envs = first.shape[:2]
    for k, buf in bufs.items():
        if buf.device != starts.device or envs.device != starts.device:
            raise ValueError(f"{name}: '{k}', starts and envs must be on one device")
        if buf.dim() < 2 or tuple(buf.shape[:2]) != (cap, n_envs):
            raise ValueError(f"{name}: '{k}' is {tuple(buf.shape)}, the rings are ({cap}, {n_envs}, ...)")
        if not buf.is_contiguous():
            raise ValueError(f"{name}: '{k}' must be contiguous")
    for arg, t in (("starts", starts), ("envs", envs)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name}: {arg} must be a contiguous 1-d int32 tensor")
    if starts.shape != envs.shape or starts.shape[0] % batch_size:
        raise ValueError(f"{name}: {starts.shape[0]} starts for batches of {batch_size}")
    if not 0 < seq_len <= cap:
        raise ValueError(f"{name}: seq_len {seq_len} outside (0, {cap}]")


def gather_windows(
    bufs: Dict[str, torch.Tensor], starts: torch.Tensor, envs: torch.Tensor, *, seq_len: int, batch_size: int
) -> Dict[str, torch.Tensor]:
    """Every key's (n_samples, L, batch, *feat) windows.

    CPU rings take :func:`gather_windows_plain`; CUDA rings launch the
    kernel once for all keys (one count in ``gather_windows.launches``) or
    raise.  ``starts`` must already lie in [0, cap) and ``envs`` in
    [0, n_envs)."""
    if starts.device.type == "cpu":
        return gather_windows_plain(bufs, starts, envs, seq_len=seq_len, batch_size=batch_size)
    if starts.device.type != "cuda":
        raise ValueError(f"gather_windows: no kernel for device {starts.device}")
    _check(bufs, starts, envs, seq_len, batch_size)
    lib = LIBRARY.load()
    keys = list(bufs)
    max_keys = lib.sheeprl_gather_windows_max_keys()
    if len(keys) > max_keys:
        raise ValueError(f"gather_windows: {len(keys)} keys, the kernel takes at most {max_keys}")
    cap, n_envs = next(iter(bufs.values())).shape[:2]
    n_samples = starts.shape[0] // batch_size
    out = {
        k: torch.empty((n_samples, seq_len, batch_size, *bufs[k].shape[2:]), dtype=bufs[k].dtype, device=starts.device)
        for k in keys
    }
    n = len(keys)
    srcs = (ctypes.c_void_p * n)(*[bufs[k].data_ptr() for k in keys])
    dsts = (ctypes.c_void_p * n)(*[out[k].data_ptr() for k in keys])
    row_bytes = (ctypes.c_longlong * n)(*[bufs[k][0, 0].numel() * bufs[k].element_size() for k in keys])
    stream = torch.cuda.current_stream(starts.device).cuda_stream
    err = lib.sheeprl_gather_windows(
        srcs, dsts, row_bytes, n, starts.data_ptr(), envs.data_ptr(),
        n_samples, int(seq_len), int(batch_size), int(cap), int(n_envs), stream,
    )
    if err != 0:
        raise RuntimeError(f"gather_windows kernel launch failed: cudaError {err}")
    gather_windows.launches += 1
    return out


gather_windows.launches = 0


# ---------------------------------------------------------------- transitions
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


def gather_transitions(
    bufs: Dict[str, torch.Tensor], rows: torch.Tensor, envs: torch.Tensor, *, next_keys: Sequence[str] = ()
) -> Dict[str, torch.Tensor]:
    """Counterpart of ``pallas_gather.py:gather_transitions_fused``: every
    key's (flat, *feat) rows, plus ``next_<k>`` successor rows for
    ``next_keys``.

    CPU rings take :func:`gather_transitions_plain`; CUDA rings launch the
    kernel in ``csrc/gather_transitions.cu`` once for every key (one count
    in ``gather_transitions.launches``) or raise.  ``rows`` must lie in
    [0, cap) and ``envs`` in [0, n_envs)."""
    if rows.device.type == "cpu":
        return gather_transitions_plain(bufs, rows, envs, next_keys=next_keys)
    if rows.device.type != "cuda":
        raise ValueError(f"gather_transitions: no kernel for device {rows.device}")
    _check(bufs, rows, envs, 1, 1, "gather_transitions")
    missing = [k for k in next_keys if k not in bufs]
    if missing:
        raise KeyError(f"gather_transitions: next keys {missing} are not buffers")
    lib = TRANSITIONS_LIBRARY.load()
    # a stored key named like a successor output is replaced by it, as in the plain version
    nxt = [(f"next_{k}", k, 1) for k in next_keys]
    entries = [(k, k, 0) for k in bufs if k not in {name for name, _, _ in nxt}] + nxt
    if len(entries) > lib.sheeprl_gather_transitions_max_entries():
        raise ValueError(
            f"gather_transitions: {len(entries)} outputs, the kernel takes at most "
            f"{lib.sheeprl_gather_transitions_max_entries()}"
        )
    cap, n_envs = next(iter(bufs.values())).shape[:2]
    flat = int(rows.shape[0])
    out = {
        name: torch.empty((flat, *bufs[k].shape[2:]), dtype=bufs[k].dtype, device=rows.device)
        for name, k, _ in entries
    }
    n = len(entries)
    srcs = (ctypes.c_void_p * n)(*[bufs[k].data_ptr() for _, k, _ in entries])
    dsts = (ctypes.c_void_p * n)(*[out[name].data_ptr() for name, _, _ in entries])
    row_bytes = (ctypes.c_longlong * n)(*[bufs[k][0, 0].numel() * bufs[k].element_size() for _, k, _ in entries])
    nxt = (ctypes.c_int * n)(*[flag for _, _, flag in entries])
    err = lib.sheeprl_gather_transitions(
        srcs, dsts, row_bytes, nxt, n, rows.data_ptr(), envs.data_ptr(), flat, int(cap), int(n_envs),
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gather_transitions kernel launch failed: cudaError {err}")
    gather_transitions.launches += 1
    return out


gather_transitions.launches = 0

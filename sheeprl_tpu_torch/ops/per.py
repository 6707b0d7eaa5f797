"""The prioritized-replay sum-tree: hand-written CUDA kernels and their plain versions.

Counterpart of ``sheeprl_tpu/ops/pallas_per.py``: ``sum_tree_sample`` (#5),
``sum_tree_write`` (#6), ``sum_tree_update`` (#7), ``sum_tree_descend`` (#8)
and ``sum_tree_scatter`` (#9).  The tree is the 1-based heap of
``replay/priority_tree.py``: a (2P,) f32 tensor, the root at 1, leaf ``l`` at
``P + l``, slot 0 unused.

- :func:`sum_tree_sample`: ``n`` proportional draws with exclusions folded
  into the descent as mass corrections (the stored tree is not copied), and
  the batch-max-normalised IS weights.  The uniforms ``r01`` are an input, so
  a caller (or a test) decides where they come from.
- :func:`sum_tree_write`: set leaves where ``active``, rebuild their
  ancestors bottom-up, in place on ``tree``.
- :func:`sum_tree_update`: the same write, and the running max
  ``max(max_p, max(where(active, priorities, 0)))``, returned.
- :func:`sum_tree_descend`: the corrected descent alone, for uniforms
  already placed in the tree's mass interval: each draw's leaf and stored
  mass.  One shard's sub-tree of the env-sharded tree
  (``replay/priority_tree.py:shard_proportional_draw``).
- :func:`sum_tree_scatter`: one shard's write, for the lanes that are active
  and owned by the shard (``shard_ids == rank``), in place on the shard's
  sub-tree, and the shard's candidate running max
  ``max(where(active & owned, values, 0))``, returned.

The writes (#6, #7, #9) are one entry of the library and one launch a
call, whatever the lane count: up to 1,024 lanes (``kBlockLanes``) one
block sorts them by leaf and rebuilds the touched nodes in shared memory; more lanes take one cooperative launch (a grid barrier a
level up to the top 2^11 nodes, which one block finishes).  The running max
and a shard's candidate max come out of the same launch.  The grid write
picks each leaf's writer in a (P,) int32 scratch that holds -1 on entry and
again on exit: a caller that writes often keeps one from
:func:`owner_scratch` and passes it as ``owner`` (``PriorityTree`` does), so a
call costs the lanes' paths and no P-sized fill.

The draws (#5, #8) take a ``scratch`` from :func:`draw_scratch`, kept by
the caller in the same way: the blocks' maxima of a sample's weights, then
room for the exclusions' pre-pass (the corrected top of the tree and the
exclusions sorted by bucket).  Every call writes what it reads there, so a
scratch needs no clearing; its size is the kernel library's, and the
library refuses a smaller one.  A draw is one launch without exclusions
and two with them (the pre-pass, then the draws).  Without a ``scratch``
the wrapper makes one for the call (an allocation, no fill).

Duplicates: a leaf that several active lanes write takes the value of the
last of them (the highest lane index), which is what XLA's scatter keeps on
the CPU; inactive lanes write nothing.  JAX parks an inactive lane at heap
slot 0 and leaves junk there; here slot 0 is never written.

Each wrapper computes its plain version for a tree on the CPU, and for a tree
on a CUDA device launches the kernels of ``csrc/sum_tree.cu`` (counting one
in its ``launches``) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sheeprl_tpu_torch.ops.build import CudaLibrary, current_stream

__all__ = [
    "LIBRARY",
    "draw_scratch",
    "owner_scratch",
    "sum_tree_descend",
    "sum_tree_descend_plain",
    "sum_tree_sample",
    "sum_tree_sample_plain",
    "sum_tree_scatter",
    "sum_tree_scatter_plain",
    "sum_tree_update",
    "sum_tree_update_plain",
    "sum_tree_write",
    "sum_tree_write_plain",
]


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    size = ctypes.c_size_t
    lib.sheeprl_sum_tree_draw_scratch_bytes.argtypes = [i32, i32]
    lib.sheeprl_sum_tree_draw_scratch_bytes.restype = size
    lib.sheeprl_sum_tree_sample.argtypes = [ptr, i32, ptr, i32, f32, f32, ptr, ptr, i32, ptr, ptr, ptr, size, ptr]
    lib.sheeprl_sum_tree_sample.restype = i32
    lib.sheeprl_sum_tree_write.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, f32, ptr, ptr]
    lib.sheeprl_sum_tree_write.restype = i32
    lib.sheeprl_sum_tree_descend.argtypes = [ptr, i32, ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, size, ptr]
    lib.sheeprl_sum_tree_descend.restype = i32


LIBRARY = CudaLibrary("sum_tree.cu", "libsheeprl_sum_tree", _bind)

_TINY = torch.finfo(torch.float32).tiny


def draw_scratch(depth: int, n_excl: int, device) -> torch.Tensor:
    """The draws' scratch for a tree of ``depth`` and up to ``n_excl``
    exclusions, of the size the kernel library gives: int32, uninitialised
    (every call writes what it reads)."""
    nbytes = LIBRARY.load().sheeprl_sum_tree_draw_scratch_bytes(int(depth), int(n_excl))
    if not nbytes:
        raise ValueError(f"no draw scratch for a tree of depth {depth} with {n_excl} exclusions")
    return torch.empty((nbytes + 3) // 4, dtype=torch.int32, device=device)


def _excl_args(tree: torch.Tensor, exclude_idx, exclude_active) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(E,) int32 leaves and (E,) bool mask on the tree's device, or (None, None)."""
    if exclude_idx is None:
        return None, None
    excl = torch.as_tensor(exclude_idx, device=tree.device).reshape(-1).to(torch.int32)
    if exclude_active is None:
        eact = torch.ones(excl.shape, dtype=torch.bool, device=tree.device)
    else:
        eact = torch.as_tensor(exclude_active, device=tree.device).reshape(excl.shape).to(torch.bool)
    return excl.contiguous(), eact.contiguous()


def _scalar(x, tree: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(float(x), dtype=torch.float32, device=tree.device)


# ------------------------------------------------------------------ plain
def _descend_plain(tree: torch.Tensor, u: torch.Tensor, depth: int, enode=None, emass=None) -> torch.Tensor:
    """``_corrected_descent`` (``pallas_per.py:78-97``): the heap node each
    ``u`` descends to, the excluded masses ``emass`` at heap nodes ``enode``
    subtracted from each level's left child."""
    node = torch.ones(u.shape, dtype=torch.int64, device=tree.device)
    for lvl in range(depth):
        child = 2 * node
        left = tree[child]
        if enode is not None:
            anc = enode >> (depth - 1 - lvl)
            left = left - torch.where(anc[None, :] == child[:, None], emass[None, :], torch.zeros((), device=tree.device)).sum(1)
        right = u >= left
        u = torch.where(right, u - left, u)
        node = child + right.long()
    return node


def _excluded(tree: torch.Tensor, excl, eact, depth: int):
    """The excluded leaves' heap nodes and masses (0 where inactive), or (None, None)."""
    if excl is None:
        return None, None
    enode = excl.long() + (1 << depth)
    return enode, torch.where(eact, tree[enode], torch.zeros((), device=tree.device))


def sum_tree_sample_plain(
    tree: torch.Tensor, r01: torch.Tensor, beta, count, *, depth: int, exclude_idx=None, exclude_active=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_sample_kernel`` with ``_corrected_descent`` (``pallas_per.py:78-117``)
    in torch ops: (n,) int32 leaves and (n,) f32 weights."""
    enode, emass = _excluded(tree, *_excl_args(tree, exclude_idx, exclude_active), depth)
    total = tree[1] if enode is None else tree[1] - emass.sum()
    node = _descend_plain(tree, r01.float() * total, depth, enode, emass)
    mass = tree[node]
    probs = torch.clamp_min(mass, _TINY) / torch.clamp_min(total, _TINY)
    w = (torch.clamp_min(_scalar(count, tree), 1.0) * probs) ** (-_scalar(beta, tree))
    return (node - (1 << depth)).to(torch.int32), w / w.max()


def sum_tree_descend_plain(
    tree: torch.Tensor, u: torch.Tensor, *, depth: int, exclude_idx=None, exclude_active=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_descend_kernel`` (``pallas_per.py:120-125``) in torch ops: (n,)
    int32 leaves and their (n,) f32 stored masses."""
    enode, emass = _excluded(tree, *_excl_args(tree, exclude_idx, exclude_active), depth)
    node = _descend_plain(tree, u.float(), depth, enode, emass)
    return (node - (1 << depth)).to(torch.int32), tree[node]


def sum_tree_write_plain(tree: torch.Tensor, leaf_idx, values, active, *, depth: int) -> torch.Tensor:
    """``_write_impl`` (``priority_tree.py:74-91``) in torch ops, in place on
    ``tree``: one writer per leaf (the last active lane), then each touched
    ancestor rebuilt from its final children.  Returns ``tree``."""
    p = 1 << depth
    active = torch.as_tensor(active, device=tree.device).reshape(-1).to(torch.bool)
    leaf = torch.as_tensor(leaf_idx, device=tree.device).reshape(-1).long()[active]
    vals = torch.as_tensor(values, device=tree.device).reshape(-1).to(tree.dtype)[active]
    if leaf.numel() == 0:
        return tree
    uniq, inv = torch.unique(leaf, return_inverse=True)
    lane = torch.arange(leaf.numel(), device=tree.device)
    last = torch.full(uniq.shape, -1, dtype=torch.int64, device=tree.device).scatter_reduce_(0, inv, lane, "amax")
    node = uniq + p
    tree[node] = vals[last]
    for _ in range(depth):
        node = torch.unique(node >> 1)
        tree[node] = tree[2 * node] + tree[2 * node + 1]
    return tree


def sum_tree_update_plain(tree: torch.Tensor, max_p, leaf_idx, priorities, active, *, depth: int) -> torch.Tensor:
    """``_tree_update``: the running max (returned, 0-d f32), then the write
    in place on ``tree``."""
    pri = torch.as_tensor(priorities, device=tree.device).reshape(-1).to(tree.dtype)
    act = torch.as_tensor(active, device=tree.device).reshape(-1).to(torch.bool)
    new_max = torch.maximum(_scalar(max_p, tree), torch.where(act, pri, torch.zeros((), device=tree.device)).max())
    sum_tree_write_plain(tree, leaf_idx, pri, act, depth=depth)
    return new_max


def sum_tree_scatter_plain(
    tree: torch.Tensor, local_leaf, values, active, shard_ids, rank: int, *, depth: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's write of ``ShardedPriorityTree._build_write``'s body
    (``priority_tree.py:475-490``) in torch ops: the lanes with ``active``
    and ``shard_ids == rank`` written in place on ``tree``, and the shard's
    candidate max ``max(where(those lanes, values, 0))`` (0-d f32).
    Returns ``(tree, cand_max)``."""
    vals = torch.as_tensor(values, device=tree.device).reshape(-1).to(tree.dtype)
    act = torch.as_tensor(active, device=tree.device).reshape(-1).to(torch.bool)
    act = act & (torch.as_tensor(shard_ids, device=tree.device).reshape(-1) == int(rank))
    if not act.numel():
        raise ValueError("sum_tree_scatter: no lanes (the max of nothing is undefined)")
    cand = torch.where(act, vals, torch.zeros((), device=tree.device)).max()
    return sum_tree_write_plain(tree, local_leaf, vals, act, depth=depth), cand


# ---------------------------------------------------------------- kernels
def _check_tree(tree: torch.Tensor, depth: int, name: str) -> None:
    if tree.dtype != torch.float32 or tree.dim() != 1 or not tree.is_contiguous():
        raise TypeError(f"{name}: the tree must be a contiguous 1-d f32 tensor")
    if tree.shape[0] != 2 << depth:
        raise ValueError(f"{name}: a tree of depth {depth} has {2 << depth} slots, got {tree.shape[0]}")


def _device_is_cpu(tree: torch.Tensor, name: str) -> None:
    """For a tree that is not on a card: the plain version runs on the CPU
    only."""
    if tree.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {tree.device}")


def _on(x, tree: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether ``x`` is a contiguous ``dtype`` tensor on the tree's card: then
    the kernels take it as it is (flat in memory, whatever its shape)."""
    return (
        isinstance(x, torch.Tensor) and x.dtype is dtype and x.is_cuda and x.get_device() == tree.get_device()
        and x.is_contiguous()
    )


def _lanes(x, tree: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as it is when it is contiguous ``dtype`` on the tree's card, else
    converted to flat contiguous ``dtype`` there."""
    if _on(x, tree, dtype):
        return x
    return torch.as_tensor(x, device=tree.device).reshape(-1).to(dtype).contiguous()


def _excl_kernel_args(tree: torch.Tensor, exclude_idx, exclude_active):
    """(excl, eact, E) for the kernels: int32 and bool, contiguous, on the
    tree's device (as given when they are); eact None means all active."""
    if exclude_idx is None:
        return None, None, 0
    excl = exclude_idx
    if not _on(excl, tree, torch.int32):
        excl = torch.as_tensor(excl, device=tree.device).reshape(-1).to(torch.int32).contiguous()
    eact = exclude_active
    if eact is not None:
        if not _on(eact, tree, torch.bool):
            eact = torch.as_tensor(eact, device=tree.device).reshape(-1).to(torch.bool).contiguous()
        if eact.numel() != excl.numel():
            raise ValueError(f"{excl.numel()} exclusions, {eact.numel()} flags")
    return excl, eact, excl.numel()


def _scratch_for(scratch, tree: torch.Tensor, depth: int, n_excl: int, sample: bool, name: str):
    """The call's draw scratch: the caller's (its size is checked by the
    library), one made for it, or None where the call needs none."""
    if scratch is None:
        return draw_scratch(depth, n_excl, tree.device) if sample or n_excl else None
    if not _on(scratch, tree, torch.int32):
        raise ValueError(f"{name}: scratch must be contiguous int32 on {tree.device} (draw_scratch)")
    return scratch


_CUDA_ERROR_INVALID_VALUE = 1


def _launched(err: int, tree: torch.Tensor, name: str, scratch, depth: int, n_excl: int) -> None:
    if err == 0:
        return
    if tree.data_ptr() % 16 or (scratch is not None and scratch.data_ptr() % 16):
        raise ValueError(f"{name}: the tree and the scratch must start on a 16-byte boundary (copied in bulk)")
    if err == _CUDA_ERROR_INVALID_VALUE and scratch is not None:
        need = LIBRARY.load().sheeprl_sum_tree_draw_scratch_bytes(int(depth), n_excl)
        if 4 * scratch.numel() < need:
            raise ValueError(f"{name}: a scratch of {4 * scratch.numel()} bytes, {need} needed (draw_scratch)")
    raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def sum_tree_sample(
    tree: torch.Tensor, r01: torch.Tensor, beta, count, *, depth: int, exclude_idx=None, exclude_active=None,
    scratch: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n = r01.numel()`` proportional draws: (n,) int32 leaves and (n,) f32
    IS weights normalised by their max.  ``exclude_idx`` (distinct where
    active) are left out of the draw without touching the tree.  ``scratch``
    is a :func:`draw_scratch` (by default one is made for the call)."""
    if not tree.is_cuda:  # the per-call path reads as few tensor attributes as it can
        _device_is_cpu(tree, "sum_tree_sample")
        return sum_tree_sample_plain(
            tree, r01, beta, count, depth=depth, exclude_idx=exclude_idx, exclude_active=exclude_active
        )
    _check_tree(tree, depth, "sum_tree_sample")
    r01 = _lanes(r01, tree, torch.float32)
    excl, eact, n_excl = _excl_kernel_args(tree, exclude_idx, exclude_active)
    scratch = _scratch_for(scratch, tree, depth, n_excl, True, "sum_tree_sample")
    lib = LIBRARY.load()
    n = r01.numel()
    leaf, w = r01.new_empty(n, dtype=torch.int32), r01.new_empty(n)
    err = lib.sheeprl_sum_tree_sample(
        tree.data_ptr(), int(depth), r01.data_ptr(), n, float(beta), float(count),
        None if excl is None else excl.data_ptr(), None if eact is None else eact.data_ptr(), n_excl,
        leaf.data_ptr(), w.data_ptr(), scratch.data_ptr(), 4 * scratch.numel(), current_stream(tree.get_device()),
    )
    _launched(err, tree, "sum_tree_sample", scratch, depth, n_excl)
    sum_tree_sample.launches += 1
    return leaf, w


def _write_args(tree: torch.Tensor, leaf_idx, values, active, name: str):
    leaf, vals = _lanes(leaf_idx, tree, torch.int32), _lanes(values, tree, torch.float32)
    act = _lanes(active, tree, torch.bool)
    if not leaf.numel() == vals.numel() == act.numel():
        raise ValueError(f"{name}: {leaf.numel()} leaves, {vals.numel()} values, {act.numel()} flags")
    return leaf, vals, act


def owner_scratch(depth: int, device) -> torch.Tensor:
    """The writes' per-leaf scratch for a tree of ``depth``: (P,) int32 of -1."""
    return torch.full((1 << depth,), -1, dtype=torch.int32, device=device)


def _launch_write(tree, depth, leaf, vals, act, sid, rank: int, max_in, max_out, owner, name: str) -> None:
    """One launch of ``csrc/sum_tree.cu:sheeprl_sum_tree_write``: the lanes
    ``sid == rank`` of them where ``sid`` is given; ``max_out`` (a 0-d f32 on
    the card, or None) set to ``max(max_in, max(where(written, vals, 0)))``,
    ``max_in`` a 0-d f32 on the card or a number."""
    lib = LIBRARY.load()
    if owner is None:
        owner = owner_scratch(depth, tree.device)
    elif not (_on(owner, tree, torch.int32) and owner.numel() == 1 << depth):
        raise ValueError(f"{name}: owner must be {1 << depth} contiguous int32 on {tree.device}")
    in_ptr = max_in.data_ptr() if _on(max_in, tree, torch.float32) and max_in.numel() == 1 else None
    err = lib.sheeprl_sum_tree_write(
        tree.data_ptr(), int(depth), leaf.data_ptr(), vals.data_ptr(), act.data_ptr(),
        None if sid is None else sid.data_ptr(), int(rank), leaf.numel(), owner.data_ptr(),
        in_ptr, float("-inf") if max_in is None or in_ptr is not None else float(max_in),
        None if max_out is None else max_out.data_ptr(), current_stream(tree.get_device()),
    )
    if err != 0:
        owner.fill_(-1)  # a launch that failed part-way may leave claims behind
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def sum_tree_write(tree: torch.Tensor, leaf_idx, values, active, *, depth: int, owner=None) -> torch.Tensor:
    """Set ``leaf_idx`` to ``values`` where ``active`` and rebuild the touched
    ancestors, in place on ``tree`` (returned): one launch.  Leaves must lie
    in [0, P).  ``owner`` is a scratch from :func:`owner_scratch` (by default
    one is made for the call)."""
    if not tree.is_cuda:
        _device_is_cpu(tree, "sum_tree_write")
        return sum_tree_write_plain(tree, leaf_idx, values, active, depth=depth)
    _check_tree(tree, depth, "sum_tree_write")
    leaf, vals, act = _write_args(tree, leaf_idx, values, active, "sum_tree_write")
    if leaf.numel():
        _launch_write(tree, depth, leaf, vals, act, None, 0, None, None, owner, "sum_tree_write")
        sum_tree_write.launches += 1
    return tree


def sum_tree_update(tree: torch.Tensor, max_p, leaf_idx, priorities, active, *, depth: int, owner=None) -> torch.Tensor:
    """The write of :func:`sum_tree_write` with ``priorities``, in place on
    ``tree``; returns the new running max (0-d f32 on the tree's device),
    computed in the same launch."""
    if not tree.is_cuda:
        _device_is_cpu(tree, "sum_tree_update")
        return sum_tree_update_plain(tree, max_p, leaf_idx, priorities, active, depth=depth)
    _check_tree(tree, depth, "sum_tree_update")
    leaf, pri, act = _write_args(tree, leaf_idx, priorities, active, "sum_tree_update")
    if not leaf.numel():
        raise ValueError("sum_tree_update: no lanes (the running max of nothing is undefined)")
    new_max = tree.new_empty(())
    _launch_write(tree, depth, leaf, pri, act, None, 0, max_p, new_max, owner, "sum_tree_update")
    sum_tree_update.launches += 1
    return new_max


def sum_tree_descend(
    tree: torch.Tensor, u: torch.Tensor, *, depth: int, exclude_idx=None, exclude_active=None,
    scratch: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n = u.numel()`` corrected descents of ``u`` (in [0, the tree's mass
    less the excluded mass)): (n,) int32 leaves and their (n,) f32 stored
    masses.  ``exclude_idx`` (distinct where active) are left out of the
    descent without touching the tree.  ``scratch`` as for
    :func:`sum_tree_sample` (only the exclusions' pre-pass uses it)."""
    if not tree.is_cuda:
        _device_is_cpu(tree, "sum_tree_descend")
        return sum_tree_descend_plain(tree, u, depth=depth, exclude_idx=exclude_idx, exclude_active=exclude_active)
    _check_tree(tree, depth, "sum_tree_descend")
    u = _lanes(u, tree, torch.float32)
    excl, eact, n_excl = _excl_kernel_args(tree, exclude_idx, exclude_active)
    scratch = _scratch_for(scratch, tree, depth, n_excl, False, "sum_tree_descend")
    lib = LIBRARY.load()
    n = u.numel()
    leaf, mass = u.new_empty(n, dtype=torch.int32), u.new_empty(n)
    err = lib.sheeprl_sum_tree_descend(
        tree.data_ptr(), int(depth), u.data_ptr(), n,
        None if excl is None else excl.data_ptr(), None if eact is None else eact.data_ptr(), n_excl,
        leaf.data_ptr(), mass.data_ptr(), None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else 4 * scratch.numel(), current_stream(tree.get_device()),
    )
    _launched(err, tree, "sum_tree_descend", scratch, depth, n_excl)
    sum_tree_descend.launches += 1
    return leaf, mass


def sum_tree_scatter(
    tree: torch.Tensor, local_leaf, values, active, shard_ids, rank: int, *, depth: int, owner=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's write: ``local_leaf`` set to ``values`` for the lanes with
    ``active`` and ``shard_ids == rank`` (their leaves in [0, P)), ancestors
    rebuilt, in place on ``tree``; returns ``(tree, cand_max)`` with the
    shard's ``max(where(those lanes, values, 0))`` as a 0-d f32 tensor, from
    the same launch.  ``owner`` as for :func:`sum_tree_write`."""
    if not tree.is_cuda:
        _device_is_cpu(tree, "sum_tree_scatter")
        return sum_tree_scatter_plain(tree, local_leaf, values, active, shard_ids, rank, depth=depth)
    _check_tree(tree, depth, "sum_tree_scatter")
    leaf, vals, act = _write_args(tree, local_leaf, values, active, "sum_tree_scatter")
    sid = _lanes(shard_ids, tree, torch.int32)
    if sid.numel() != leaf.numel():
        raise ValueError(f"sum_tree_scatter: {leaf.numel()} leaves, {sid.numel()} shard ids")
    if not leaf.numel():
        raise ValueError("sum_tree_scatter: no lanes (the max of nothing is undefined)")
    cand = tree.new_empty(())
    _launch_write(tree, depth, leaf, vals, act, sid, rank, None, cand, owner, "sum_tree_scatter")
    sum_tree_scatter.launches += 1
    return tree, cand


sum_tree_sample.launches = 0
sum_tree_write.launches = 0
sum_tree_update.launches = 0
sum_tree_descend.launches = 0
sum_tree_scatter.launches = 0

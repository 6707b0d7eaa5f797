"""The transition gather's plan (#4 and #3, ``ops/gather.py:gather_plan`` and
``_plan_for``), on CPU tensors: what it is keyed on, its chunk table, and an
emulation of ``csrc/gather.cu``'s work split that reads and
writes bytes through the plan alone, against the plain version.

The emulation follows the kernel: a block takes ``rows_per_block`` rows
(``kChunksPerBlock`` over a row's chunks), its items run entry by entry
(item ``j`` of entry ``e``: row ``j // chunks_e``, chunk ``j % chunks_e``),
and each item copies ``1 << shift_e`` bytes from the ring cell of its row
(the successor row for a next key) to its output row.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import gather

torch.set_num_threads(1)

SOURCE = Path(gather.__file__).resolve().parent.parent / "csrc" / "gather.cu"


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def _rings(cap=9, n_envs=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "obs": torch.randn(cap, n_envs, 24, generator=g),  # 96 B
        "act": torch.randn(cap, n_envs, 6, generator=g),  # 24 B
        "rew": torch.randn(cap, n_envs, 1, generator=g),  # 4 B
        "done": torch.randint(0, 2, (cap, n_envs, 1), generator=g, dtype=torch.uint8),  # 1 B
        "flag": torch.randint(0, 2, (cap, n_envs), generator=g, dtype=torch.uint8),  # 1 B, no feature axis
    }


def _misaligned(cap, n_envs, row_bytes, offset, seed=1):
    """A contiguous uint8 ring whose base is ``offset`` bytes past an
    allocation's start (a slice of a larger buffer)."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randint(0, 256, (cap * n_envs * row_bytes + offset,), generator=g, dtype=torch.uint8)
    return flat[offset:].view(cap, n_envs, row_bytes)


def emulate(plan: gather.GatherPlan, bufs, rows, envs):
    """The kernel's work split over CPU rings, through the plan's table."""
    c = plan.c
    n = c.n
    per_row = c.first[n]
    assert "constexpr int kChunksPerBlock = kThreads * kUnroll;" in SOURCE.read_text()
    chunks_per_block = _constant("kThreads") * _constant("kUnroll")
    rows_per_block = 1 if per_row >= chunks_per_block else chunks_per_block // per_row
    base_of = {buf.data_ptr(): buf.reshape(-1).view(torch.uint8).numpy() for buf in bufs.values()}
    flat = rows.numel()
    out_off, off = [], 0  # the C entry's placement of the outputs in the block
    for e in range(n):
        out_off.append(off)
        off = (off + flat * c.row_bytes[e] + 15) // 16 * 16
    layout = plan.layout(flat)
    assert layout.nbytes == off
    block = np.full(off, 0xAB, np.uint8)
    written = np.zeros(off, np.int64)
    for f0 in range(0, flat, rows_per_block):
        nrows = min(rows_per_block, flat - f0)
        r_ = rows[f0 : f0 + nrows].numpy().astype(np.int64)
        e_ = envs[f0 : f0 + nrows].numpy().astype(np.int64)
        cell, ncell = r_ * c.n_envs + e_, ((r_ + 1) % c.cap) * c.n_envs + e_
        item0 = [c.first[e] * nrows for e in range(n + 1)]
        for item in range(item0[n]):
            e = max(k for k in range(n) if item0[k] <= item)
            chunks = c.first[e + 1] - c.first[e]
            j = item - item0[e]
            r, chunk = divmod(j, chunks)
            width = 1 << c.shift[e]
            src_off = int((ncell if c.next[e] else cell)[r]) * c.row_bytes[e] + chunk * width
            dst_off = out_off[e] + (f0 + r) * c.row_bytes[e] + chunk * width
            assert src_off % width == 0 and (c.src[e] + src_off) % width == 0 and dst_off % width == 0
            src = base_of[c.src[e]]
            block[dst_off : dst_off + width] = src[src_off : src_off + width]
            written[dst_off : dst_off + width] += 1
    for e in range(n):
        span = written[out_off[e] : out_off[e] + flat * c.row_bytes[e]]
        assert (span == 1).all(), "every output byte is written exactly once"
    # the wrapper's views of the block
    t = torch.from_numpy(block)
    typed = [t] + [t.view(dtype) for dtype in layout.dtypes[1:]]
    outs = [typed[b].as_strided(shape, stride, o) for b, shape, stride, o in layout.views]
    return dict(zip(plan.names, outs))


def test_plan_is_keyed_on_pointer_shape_dtype_and_next_keys():
    """The same rings (even in a new dict) give the cached plan; a ring
    replaced by another tensor, a ring viewed with another shape or dtype,
    and other next keys each give a new one; the cache stays bounded."""
    gather._PLANS.clear()
    bufs = _rings()
    plan = gather._plan_for(bufs, ())
    assert gather._plan_for(dict(bufs), ()) is plan
    assert gather._plan_for(bufs, ("obs",)) is not plan
    replaced = dict(bufs, act=bufs["act"].clone())
    new = gather._plan_for(replaced, ())
    assert new is not plan and new.c.src[1] == replaced["act"].data_ptr() != plan.c.src[1]
    assert gather._plan_for(dict(bufs, obs=bufs["obs"].view(9, 3, 4, 6)), ()) is not plan
    assert gather._plan_for(dict(bufs, obs=bufs["obs"].view(torch.int32)), ()) is not plan
    assert gather._plan_for(bufs, ()) is plan
    for k in range(2 * gather._PLANS_KEPT):
        gather._plan_for({"x": torch.zeros(4, 2, k + 1)}, ())
    assert len(gather._PLANS) == gather._PLANS_KEPT
    assert gather._plan_for(bufs, ()) is not plan  # evicted, rebuilt


@pytest.mark.parametrize("next_keys", [(), ("obs", "flag")])
def test_chunk_table(next_keys):
    """Rows of 96, 24, 4 and 1 bytes on aligned rings: 16-byte chunks where
    the row bytes allow, else 4-byte, else bytes; the prefix of the chunk
    counts; successor entries after the stored keys."""
    bufs = _rings()
    plan = gather.gather_plan(bufs, next_keys)
    c = plan.c
    names = ("obs", "act", "rew", "done", "flag") + tuple(f"next_{k}" for k in next_keys)
    assert plan.names == names and c.n == len(names) and (c.cap, c.n_envs) == (9, 3)
    want = {"obs": (96, 4, 6), "act": (24, 2, 6), "rew": (4, 2, 1), "done": (1, 0, 1), "flag": (1, 0, 1)}
    first = 0
    for e, name in enumerate(names):
        key = name[5:] if name.startswith("next_") else name
        row_bytes, shift, chunks = want[key]
        assert (c.row_bytes[e], c.shift[e], c.first[e], c.next[e]) == (row_bytes, shift, first, name != key)
        assert c.src[e] == bufs[key].data_ptr()
        first += chunks
    assert c.first[c.n] == plan.chunks_per_row == first
    assert plan.specs[names.index("flag")] == ((), torch.uint8) and plan.specs[0] == ((24,), torch.float32)


@pytest.mark.parametrize("offset,shift", [(0, 4), (16, 4), (8, 2), (4, 2), (2, 0), (1, 0)])
def test_chunk_width_follows_the_ring_base(offset, shift):
    """A 96-byte ring whose base is ``offset`` bytes into its allocation
    takes the widest chunk that divides both the row bytes and the base."""
    ring = _misaligned(7, 2, 96, offset)
    assert (ring.data_ptr() - offset) % 16 == 0  # the allocation itself is aligned (64 bytes in torch)
    plan = gather.gather_plan({"x": ring})
    assert plan.c.shift[0] == shift and plan.chunks_per_row == 96 >> shift


@pytest.mark.parametrize("flat", [1, 5, 1000])
@pytest.mark.parametrize("next_keys", [(), ("obs", "done", "flag")])
def test_emulated_kernel_matches_plain(flat, next_keys):
    """The kernel's split through the plan, bytes exact against
    ``gather_transitions_plain``: successor rows that wrap the ring, one row,
    a ragged last block, and a misaligned ring beside aligned ones."""
    bufs = _rings(cap=13, n_envs=4)
    bufs["odd"] = _misaligned(13, 4, 24, 3)
    g = torch.Generator().manual_seed(flat)
    rows = torch.randint(0, 13, (flat,), generator=g, dtype=torch.int32)
    rows[: min(flat, 3)] = 12
    envs = torch.randint(0, 4, (flat,), generator=g, dtype=torch.int32)
    plan = gather.gather_plan(bufs, next_keys)
    got = emulate(plan, bufs, rows, envs)
    ref = gather.gather_transitions_plain(bufs, rows, envs, next_keys=next_keys)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k])


def test_plan_refuses_what_the_kernel_does_not_take():
    bufs = _rings()
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_plan(dict(bufs, obs=bufs["obs"][:, :, ::2]))
    with pytest.raises(ValueError, match="rings are"):
        gather.gather_plan(dict(bufs, obs=torch.zeros(8, 3, 24)))
    with pytest.raises(KeyError):
        gather.gather_plan(bufs, ("missing",))
    many = {f"k{i}": torch.zeros(4, 2) for i in range(gather.MAX_ENTRIES + 1)}
    with pytest.raises(ValueError, match="at most"):
        gather.gather_plan(many)
    with pytest.raises(ValueError, match="no buffers"):
        gather.gather_plan({})


@pytest.mark.parametrize("flat", [0, 1, 7, 16384])
def test_layout_views_are_contiguous_aligned_and_disjoint(flat):
    """The outputs as views of one block: each keeps its dtype and shape, is
    contiguous, starts on 16 bytes, and no two overlap."""
    bufs = _rings()
    bufs["wide"] = torch.zeros(9, 3, 2, 5, dtype=torch.int64)
    plan = gather.gather_plan(bufs, ("obs", "flag"))
    layout = plan.layout(flat)
    assert plan.layout(flat) is layout
    block = torch.empty(layout.nbytes, dtype=torch.uint8)
    typed = [block] + [block.view(dtype) for dtype in layout.dtypes[1:]]
    outs = [typed[b].as_strided(shape, stride, o) for b, shape, stride, o in layout.views]
    spans = []
    for out, (feat, dtype) in zip(outs, plan.specs):
        assert out.dtype == dtype and out.shape == (flat, *feat) and out.is_contiguous()
        start = out.data_ptr() - block.data_ptr()
        assert start % 16 == 0
        spans.append((start, start + out.numel() * out.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= layout.nbytes


def test_max_entries_matches_the_kernel():
    assert gather.MAX_ENTRIES == _constant("kMaxEntries")

"""The window gather's plan (#3, ``ops/gather.py:gather_windows`` on the
plan of ``gather_plan`` with no next keys, cached by ``_plan_for``), on CPU
tensors: what it is keyed on, its chunk table, the outputs as views of one
block, and an emulation of ``csrc/gather.cu``'s windows mode that reads and
writes bytes through the plan alone, against ``gather_windows_plain`` and
JAX's ``gather_windows_fused`` in interpret mode.

The emulation follows the kernel: output row ``o = (s L + t) batch + b``
reads ring row ``(starts[f] + t) % cap`` of env ``envs[f]``,
``f = s batch + b``; a block takes ``rows_per_block`` output rows
(``kChunksPerBlock`` over a row's chunks), its items run entry by entry
(item ``j`` of entry ``e``: row ``j // chunks_e``, chunk ``j % chunks_e``),
and each item copies ``1 << shift_e`` bytes.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.pallas_gather import gather_windows_fused
from sheeprl_tpu_torch.ops import gather

torch.set_num_threads(1)

SOURCE = Path(gather.__file__).resolve().parent.parent / "csrc" / "gather.cu"


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def _rings(cap=11, n_envs=3, seed=0):
    """Crafter-shaped keys at a small size: uint8 frames, an f32 one-hot of
    17 actions (68 bytes), f32 scalars, a 3-byte uint8 key and a flag with no
    feature axis."""
    g = torch.Generator().manual_seed(seed)
    return {
        "rgb": torch.randint(0, 256, (cap, n_envs, 8, 8, 3), generator=g, dtype=torch.uint8),  # 192 B
        "actions": torch.randn(cap, n_envs, 17, generator=g),  # 68 B
        "reward": torch.randn(cap, n_envs, 1, generator=g),  # 4 B
        "odd": torch.randint(0, 256, (cap, n_envs, 3), generator=g, dtype=torch.uint8),  # 3 B
        "is_first": torch.randint(0, 2, (cap, n_envs), generator=g, dtype=torch.uint8),  # 1 B
    }


def _draw(cap, n_envs, n_samples, batch, seq_len, seed):
    g = torch.Generator().manual_seed(seed)
    flat = n_samples * batch
    starts = torch.randint(0, cap, (flat,), generator=g, dtype=torch.int32)
    starts[: min(flat, 3)] = torch.tensor([cap - 1, cap - seq_len // 2, cap - seq_len + 1], dtype=torch.int32)[: min(flat, 3)]
    envs = torch.randint(0, n_envs, (flat,), generator=g, dtype=torch.int32)
    return starts, envs


def emulate(plan: gather.GatherPlan, bufs, starts, envs, seq_len, batch):
    """The windows mode of the kernel over CPU rings, through the plan."""
    c = plan.c
    n = c.n
    assert not any(c.next[e] for e in range(n)), "a window plan has no successor entries"
    per_row = c.first[n]
    assert "constexpr int kChunksPerBlock = kThreads * kUnroll;" in SOURCE.read_text()
    chunks_per_block = _constant("kThreads") * _constant("kUnroll")
    rows_per_block = 1 if per_row >= chunks_per_block else chunks_per_block // per_row
    base_of = {buf.data_ptr(): buf.reshape(-1).view(torch.uint8).numpy() for buf in bufs.values()}
    n_samples = starts.numel() // batch
    n_rows = n_samples * seq_len * batch
    out_off, off = [], 0  # the C entry's placement of the outputs in the block
    for e in range(n):
        out_off.append(off)
        off = (off + n_rows * c.row_bytes[e] + 15) // 16 * 16
    layout = plan.layout(n_samples, seq_len, batch)
    assert layout.nbytes == off
    block = np.full(off, 0xAB, np.uint8)
    written = np.zeros(off, np.int64)
    st_np, env_np = starts.numpy().astype(np.int64), envs.numpy().astype(np.int64)
    for r0 in range(0, n_rows, rows_per_block):
        nrows = min(rows_per_block, n_rows - r0)
        cells = []
        for o in range(r0, r0 + nrows):
            st = o // batch
            f = (st // seq_len) * batch + (o - st * batch)
            cells.append(((st_np[f] + st % seq_len) % c.cap) * c.n_envs + env_np[f])
        item0 = [c.first[e] * nrows for e in range(n + 1)]
        for item in range(item0[n]):
            e = max(k for k in range(n) if item0[k] <= item)
            chunks = c.first[e + 1] - c.first[e]
            r, chunk = divmod(item - item0[e], chunks)
            width = 1 << c.shift[e]
            src_off = int(cells[r]) * c.row_bytes[e] + chunk * width
            dst_off = out_off[e] + (r0 + r) * c.row_bytes[e] + chunk * width
            assert (c.src[e] + src_off) % width == 0 and dst_off % width == 0
            block[dst_off : dst_off + width] = base_of[c.src[e]][src_off : src_off + width]
            written[dst_off : dst_off + width] += 1
    for e in range(n):
        span = written[out_off[e] : out_off[e] + n_rows * c.row_bytes[e]]
        assert (span == 1).all(), "every output byte is written exactly once"
    t = torch.from_numpy(block)
    typed = [t] + [t.view(dtype) for dtype in layout.dtypes[1:]]
    outs = [typed[b].as_strided(shape, stride, o) for b, shape, stride, o in layout.views]
    return dict(zip(plan.names, outs))


def test_window_plan_is_the_cached_plan_of_the_rings():
    """The window gather takes the plan of its rings with no next keys: the
    same rings (in a new dict) give the cached plan; a ring replaced by
    another tensor, or viewed with another shape or dtype, gives a new one
    whose table points at the new ring."""
    gather._PLANS.clear()
    bufs = _rings()
    plan = gather._plan_for(bufs, ())
    assert gather._plan_for(dict(bufs), ()) is plan
    assert plan.names == tuple(bufs) and not any(plan.c.next[e] for e in range(plan.c.n))
    replaced = dict(bufs, reward=bufs["reward"].clone())
    new = gather._plan_for(replaced, ())
    assert new is not plan and new.c.src[2] == replaced["reward"].data_ptr() != plan.c.src[2]
    assert gather._plan_for(dict(bufs, rgb=bufs["rgb"].view(11, 3, 64, 3)), ()) is not plan
    assert gather._plan_for(dict(bufs, actions=bufs["actions"].view(torch.int32)), ()) is not plan
    assert gather._plan_for(bufs, ()) is plan


def test_window_chunk_table():
    """uint8 frames of 192 bytes in 16-byte chunks, 68-byte f32 rows in
    4-byte chunks, 4-byte f32 scalars in one, and 3- and 1-byte uint8 keys
    byte by byte; the prefix of the chunk counts; cap and n_envs."""
    bufs = _rings()
    c = gather.gather_plan(bufs).c
    want = {"rgb": (192, 4, 12), "actions": (68, 2, 17), "reward": (4, 2, 1), "odd": (3, 0, 3), "is_first": (1, 0, 1)}
    first = 0
    for e, (key, (row_bytes, shift, chunks)) in enumerate(want.items()):
        assert (c.row_bytes[e], c.shift[e], c.first[e], c.next[e]) == (row_bytes, shift, first, 0)
        assert c.src[e] == bufs[key].data_ptr()
        first += chunks
    assert c.first[c.n] == first and (c.n, c.cap, c.n_envs) == (5, 11, 3)


@pytest.mark.parametrize("n_samples,seq_len,batch", [(0, 4, 2), (1, 1, 1), (2, 5, 3), (3, 64, 16)])
def test_window_views_are_contiguous_aligned_and_disjoint(n_samples, seq_len, batch):
    bufs = _rings()
    plan = gather.gather_plan(bufs)
    layout = plan.layout(n_samples, seq_len, batch)
    assert plan.layout(n_samples, seq_len, batch) is layout
    block, outs = plan.outputs(layout, torch.empty(0))
    assert block.dtype == torch.uint8 and block.numel() == layout.nbytes
    spans = []
    for out, (feat, dtype) in zip(outs, plan.specs):
        assert out.dtype == dtype and out.shape == (n_samples, seq_len, batch, *feat) and out.is_contiguous()
        start = out.data_ptr() - block.data_ptr()
        assert start % 16 == 0
        spans.append((start, start + out.numel() * out.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= layout.nbytes


@pytest.mark.parametrize("n_samples,seq_len,batch", [(1, 1, 1), (2, 5, 3), (1, 11, 4), (3, 7, 16)])
def test_emulated_kernel_matches_plain_and_pallas(n_samples, seq_len, batch):
    """Windows that wrap the ring, a window as long as the ring, one row,
    and a block of many rows, beside a ring sliced 3 bytes into its
    allocation: bytes equal to the plain version and to the Pallas kernel
    (in interpret mode) after the cache's swap of its (flat, L) layout."""
    cap, n_envs = 11, 3
    bufs = _rings(cap, n_envs, seed=batch)
    raw = torch.randint(0, 256, (cap * n_envs * 24 + 3,), generator=torch.Generator().manual_seed(7), dtype=torch.uint8)
    bufs["sliced"] = raw[3:].view(cap, n_envs, 24)
    starts, envs = _draw(cap, n_envs, n_samples, batch, seq_len, seed=seq_len)
    plan = gather.gather_plan(bufs)
    got = emulate(plan, bufs, starts, envs, seq_len, batch)
    ref = gather.gather_windows_plain(bufs, starts, envs, seq_len=seq_len, batch_size=batch)
    pallas = gather_windows_fused({k: jnp.asarray(v.numpy()) for k, v in bufs.items()}, jnp.asarray(starts.numpy()),
                                  jnp.asarray(envs.numpy()), seq_len=seq_len, interpret=True)
    assert list(got) == list(ref) == list(pallas)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
        jax_out = np.asarray(pallas[k]).reshape(n_samples, batch, seq_len, *bufs[k].shape[2:]).swapaxes(1, 2)
        np.testing.assert_array_equal(got[k].numpy(), jax_out, err_msg=k)


def test_window_gather_refuses_what_the_kernel_does_not_take():
    """The rings' checks (made once, with the plan) and a call's checks of
    its indices; on the CPU the wrapper takes the plain version and never
    launches."""
    bufs = _rings()
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_plan(dict(bufs, actions=bufs["actions"][:, :, ::2]))
    with pytest.raises(ValueError, match="rings are"):
        gather.gather_plan(dict(bufs, reward=torch.zeros(10, 3, 1)))
    with pytest.raises(ValueError, match="no buffers"):
        gather.gather_plan({})
    plan = gather.gather_plan(bufs)
    starts, envs = _draw(11, 3, 2, 4, 5, seed=1)
    with pytest.raises(TypeError, match="int32"):
        gather._check_indices("gather_windows", plan, starts.long(), envs)
    with pytest.raises(ValueError, match="indices"):
        gather._check_indices("gather_windows", plan, starts, envs[:-1])
    assert not gather._indices_ok(plan, starts[::2], envs[::2])
    before = gather.gather_windows.launches
    out = gather.gather_windows(bufs, starts, envs, seq_len=5, batch_size=4)
    assert gather.gather_windows.launches == before and out["rgb"].shape == (2, 5, 4, 8, 8, 3)
    with pytest.raises(ValueError, match="no kernel"):
        gather.gather_windows({k: v.to("meta") for k, v in bufs.items()}, starts.to("meta"), envs.to("meta"),
                              seq_len=5, batch_size=4)


def test_max_entries_matches_the_kernel():
    assert gather.MAX_ENTRIES == _constant("kMaxEntries")

"""The sum-tree write kernels' arithmetic (#6 ``sum_tree_write``, #7
``sum_tree_update`` and #9 ``sum_tree_scatter``, all ``launch_write`` in
``csrc/sum_tree.cu``), emulated in numpy on the CPU, against the plain
versions and JAX's Pallas kernels in interpret mode, bit for bit.

The emulations follow the two methods the launch chooses from the lane count:

- ``write_block_kernel`` (up to ``kBlockLanes`` lanes): the on lanes'
  (leaf, lane) keys through the kernel's bitonic network, the last lane of a
  leaf the winner, the winners' stored siblings loaded from the tree as it
  was on entry, then the runs of positions that share a node at each level,
  each carried by its first position: a left child's run takes its right
  sibling's run sum (handed over at the run's end) when that sibling is
  touched, else the stored sibling;
- ``write_grid_kernel`` (more lanes): the claim (the largest lane index a
  leaf), the winners' leaves, every on lane's node rebuilt level by level up
  to level S (the first of at most 2^kTopLevels nodes), whose nodes are
  marked in the owner scratch, then the top rebuilt from the marks alone
  (a node is touched when a child is), the marks reset.

Both run on every case, whatever its lane count, so each is checked on
duplicates (equal and unequal values), inactive lanes, other shards' lanes,
and a tree whose internal nodes are not the sums of their children (a node
no lane touches keeps its bits).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_per
from sheeprl_tpu_torch.ops import per

torch.set_num_threads(1)

SOURCE = Path(per.__file__).resolve().parent.parent / "csrc" / "sum_tree.cu"


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (-?\d+);", SOURCE.read_text()).group(1))


BLOCK_LANES = _constant("kBlockLanes")
TOP_LEVELS = _constant("kTopLevels")
MARK = _constant("kMark")


def _f32(x):
    return np.float32(x)


def bitonic(keys):
    """The kernel's sort: a bitonic network over N = max(32, the next power of
    two) elements, element t keeping the smaller of itself and its partner
    t ^ j when (t & j == 0) == (t & k == 0), else the larger."""
    n = 32
    while n < keys.size:
        n <<= 1
    x = np.full(n, IDLE, np.uint64)
    x[: keys.size] = keys
    t = np.arange(n)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            y = x[t ^ j]
            keep_min = ((t & j) == 0) == ((t & k) == 0)
            x = np.where(keep_min, np.minimum(x, y), np.maximum(x, y))
            j >>= 1
        k <<= 1
    return x


IDLE = np.uint64(0xFFFFFFFFFFFFFFFF)


def block_write(tree, depth, leaf, vals, on):
    """``write_block_kernel``: the on lanes' (leaf << 32 | lane) keys sorted by
    the bitonic network, the last lane of a leaf its winner, then each
    winner's walk up from its leaf, in level order (one schedule the kernel's
    waits allow): a right run whose left sibling is touched hands its sum
    and end over at that level and stops; the left run takes them."""
    out = tree.copy()
    p = 1 << depth
    lanes = np.nonzero(on)[0]
    if lanes.size == 0:
        return out
    keys = (leaf[lanes].astype(np.uint64) << np.uint64(32)) | lanes.astype(np.uint64)
    x = bitonic(keys)
    assert (x[:-1] <= x[1:]).all()
    nxt = np.append(x[1:], IDLE)
    win = (x != IDLE) & ((nxt >> np.uint64(32)) != (x >> np.uint64(32)))
    won = (x[win] >> np.uint64(32)).astype(np.int64)
    cur = vals[(x[win] & np.uint64(0xFFFFFFFF)).astype(np.int64)].astype(np.float32)
    m = won.size
    node = won + p
    sib = tree[(node[:, None] >> np.arange(depth)[None, :]) ^ 1]  # loaded before any write
    out[node] = cur
    walking = np.ones(m, bool)
    end = np.arange(1, m + 1)
    handed = {}  # position -> (level, sum, end)
    for k in range(depth):
        for q in np.nonzero(walking)[0]:  # right runs first would do as well: a hand-over is read at its own level
            v = node[q] >> k
            if v % 2 == 1 and q > 0 and ((won[q - 1] + p) >> k) == v - 1:
                handed[q] = (k, cur[q], end[q])
                walking[q] = False
        for q in np.nonzero(walking)[0]:
            v = node[q] >> k
            if v % 2 == 0:
                right = sib[q, k]
                e = end[q]
                if e < m and ((won[e] + p) >> k) == v + 1:
                    lvl, right, end[q] = handed.pop(e)
                    assert lvl == k, "the right run hands over at the level the left run waits on"
                cur[q] = _f32(cur[q] + right)
            else:
                cur[q] = _f32(sib[q, k] + cur[q])
            out[v >> 1] = cur[q]
    assert not handed, "every hand-over is taken"
    return out


def grid_write(tree, depth, leaf, vals, on, owner):
    """``write_grid_kernel``, phase by phase (lanes of a phase in any order:
    they write the same values); ``owner`` is updated in place."""
    out = tree.copy()
    p = 1 << depth
    top = max(0, depth - TOP_LEVELS)
    lanes = np.nonzero(on)[0]
    for i in lanes:
        owner[leaf[i]] = max(owner[leaf[i]], i)
    for i in lanes:
        if owner[leaf[i]] == i:
            out[p + leaf[i]] = vals[i]
            owner[leaf[i]] = MARK if top == 0 else -1
    for k in range(1, top + 1):
        v = np.unique((leaf[lanes].astype(np.int64) + p) >> k)
        out[v] = out[2 * v] + out[2 * v + 1]
        if k == top:
            owner[v - (p >> top)] = MARK
    base = p >> top
    s_top = out[: 2 * base].copy()
    touched = np.zeros(2 * base, bool)
    touched[base:] = owner[:base] == MARK
    owner[:base] = -1
    half = base >> 1
    while half >= 1:
        for v in range(half, 2 * half):
            touched[v] = touched[2 * v] | touched[2 * v + 1]
            if touched[v]:
                s_top[v] = _f32(s_top[2 * v] + s_top[2 * v + 1])
                out[v] = s_top[v]
        half >>= 1
    return out


def _tree(depth, leaves, rng, invariant):
    """A heap over ``leaves``; with ``invariant`` False its internal nodes are
    random numbers, not the sums of their children."""
    p = 1 << depth
    tree = np.zeros(2 * p, np.float32)
    tree[p : p + leaves.size] = leaves
    for v in range(p - 1, 0, -1):
        tree[v] = tree[2 * v] + tree[2 * v + 1]
    if not invariant:
        tree[1:p] = rng.integers(0, 1000, p - 1).astype(np.float32) * 0.37
    tree[0] = 7.0
    return tree


def _lanes(rng, n, n_leaves, integer):
    leaf = rng.integers(0, n_leaves, n).astype(np.int32)
    if n > 4:
        leaf[n // 2 : n // 2 + n // 4] = leaf[: n // 4]  # duplicates ...
    vals = (rng.integers(0, 40, n) * 0.25 if integer else rng.random(n) * 3).astype(np.float32)
    if n > 8:
        vals[n // 2 : n // 2 + n // 8] = vals[: n // 8]  # ... some of them with equal values
    active = rng.random(n) < 0.7
    shard = rng.integers(0, 4, n).astype(np.int32)
    return leaf, vals, active, shard


def _bits(x):
    return np.asarray(x, np.float32)[1:].view(np.uint32)


CASES = [
    # (depth, leaves, lanes)
    (1, 2, 1),
    (3, 6, 255),
    (5, 32, 256),
    (11, 2000, 1024),
    (12, 4000, 1025),
    (12, 3000, 255),
    (14, 16384, 3000),
    (16, 50000, 1024),
]


@pytest.mark.parametrize("depth,n_leaves,lanes", CASES)
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("invariant", [True, False])
def test_write_emulations_match_plain_and_pallas(depth, n_leaves, lanes, integer, invariant):
    """The block and the grid write on the same lanes: equal to
    ``sum_tree_write_plain`` and JAX's ``sum_tree_write`` (interpret) from
    slot 1, bit for bit; the owner scratch back at -1."""
    rng = np.random.default_rng(depth * 1000 + lanes + 2 * integer + invariant)
    leaves = (rng.integers(0, 9, n_leaves) if integer else rng.random(n_leaves) + 0.01).astype(np.float32)
    tree = _tree(depth, leaves, rng, invariant)
    leaf, vals, active, _ = _lanes(rng, lanes, n_leaves, integer)
    plain = per.sum_tree_write_plain(torch.from_numpy(tree.copy()), leaf, vals, active, depth=depth).numpy()
    jax_out = np.asarray(
        pallas_per.sum_tree_write(jnp.asarray(tree), leaf, vals, active, depth=depth, interpret=True)
    )
    owner = np.full(1 << depth, -1, np.int64)
    for got in (block_write(tree, depth, leaf, vals, active), grid_write(tree, depth, leaf, vals, active, owner)):
        assert np.array_equal(_bits(got), _bits(plain))
        assert np.array_equal(_bits(got), _bits(jax_out))
    assert (owner == -1).all()
    # the nodes no active lane's path touches keep their bits (and on the
    # non-invariant tree they are not the sums of their children)
    p = 1 << depth
    touched = np.unique(np.concatenate([(leaf[active].astype(np.int64) + p) >> k for k in range(depth + 1)]))
    kept = np.setdiff1d(np.arange(1, p), touched)
    assert np.array_equal(plain[kept].view(np.uint32), tree[kept].view(np.uint32))


@pytest.mark.parametrize("depth,n_leaves,lanes", CASES[2:])
@pytest.mark.parametrize("invariant", [True, False])
def test_scatter_emulations_match_plain_and_pallas(depth, n_leaves, lanes, invariant):
    """A shard's scatter (the lanes that are active and of ``rank``), f32
    values: both methods equal ``sum_tree_scatter_plain`` and JAX's raw
    ``sum_tree_scatter`` (interpret) on the shard's lanes, for each of 4
    ranks; the candidate max is the fold from -inf."""
    rng = np.random.default_rng(depth + lanes + invariant)
    tree = _tree(depth, (rng.random(n_leaves) + 0.01).astype(np.float32), rng, invariant)
    leaf, vals, active, shard = _lanes(rng, lanes, n_leaves, False)
    for rank in range(4):
        on = active & (shard == rank)
        plain, cand = per.sum_tree_scatter_plain(
            torch.from_numpy(tree.copy()), leaf, vals, active, shard, rank, depth=depth
        )
        jax_out = np.asarray(pallas_per.sum_tree_scatter(jnp.asarray(tree), leaf, vals, on, depth=depth, interpret=True))
        owner = np.full(1 << depth, -1, np.int64)
        for got in (block_write(tree, depth, leaf, vals, on), grid_write(tree, depth, leaf, vals, on, owner)):
            assert np.array_equal(_bits(got), _bits(plain.numpy()))
            assert np.array_equal(_bits(got), _bits(jax_out))
        assert (owner == -1).all()
        assert float(cand) == max(float("-inf"), float(np.where(on, vals, 0.0).max()))


@pytest.mark.parametrize("lanes", [1, 256, 1025])
def test_update_emulations_match_plain_and_pallas(lanes):
    """An update: both methods' trees and the running max
    ``max(max_p, max(where(active, priorities, 0)))`` equal the plain
    version's and JAX's ``sum_tree_update`` (interpret)."""
    depth, n_leaves = 12, 3000
    rng = np.random.default_rng(lanes)
    tree = _tree(depth, (rng.random(n_leaves) + 0.01).astype(np.float32), rng, False)
    leaf, pri, active, _ = _lanes(rng, lanes, n_leaves, False)
    for max_p in (0.5, 9.0):
        t_plain = torch.from_numpy(tree.copy())
        m_plain = per.sum_tree_update_plain(t_plain, max_p, leaf, pri, active, depth=depth)
        tj, mj = pallas_per.sum_tree_update(jnp.asarray(tree), max_p, leaf, pri, active, depth=depth, interpret=True)
        owner = np.full(1 << depth, -1, np.int64)
        for got in (block_write(tree, depth, leaf, pri, active), grid_write(tree, depth, leaf, pri, active, owner)):
            assert np.array_equal(_bits(got), _bits(t_plain.numpy()))
            assert np.array_equal(_bits(got), _bits(np.asarray(tj)))
        kernel_max = max(max_p, float(np.where(active, pri, 0.0).max()))  # the launch's fold
        assert kernel_max == float(m_plain) == float(mj)


def test_last_lane_wins_in_both_methods():
    """Three lanes on one leaf with different values, the middle one
    inactive: the last active lane's value is written, by both methods."""
    depth = 4
    tree = _tree(depth, np.arange(16, dtype=np.float32), np.random.default_rng(0), True)
    leaf = np.array([5, 5, 5, 2], np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    active = np.array([True, True, False, True])
    owner = np.full(16, -1, np.int64)
    for got in (block_write(tree, depth, leaf, vals, active), grid_write(tree, depth, leaf, vals, active, owner)):
        assert got[16 + 5] == 2.0 and got[16 + 2] == 4.0
        assert got[1] == tree[1] - 5.0 + 2.0 - 2.0 + 4.0


def test_constants_read_from_the_kernel_source():
    """The emulations use the kernel's own boundaries: one block takes up to
    1,024 lanes (a thread each) and the grid write's top is 2^11 nodes."""
    assert BLOCK_LANES == 1024 and TOP_LEVELS == 11 and MARK < -1


@pytest.mark.parametrize("m", [1, 31, 32, 33, 255, 256, 1000, 1024])
def test_bitonic_network_sorts(m):
    """The kernel's network on distinct keys, padded with idle keys."""
    leaves = np.random.default_rng(m).integers(0, 1 << 30, m).astype(np.uint64)
    keys = (leaves << np.uint64(32)) | np.arange(m, dtype=np.uint64)  # (leaf, lane): distinct
    got = bitonic(keys)
    assert np.array_equal(got[:m], np.sort(keys)) and (got[m:] == IDLE).all()

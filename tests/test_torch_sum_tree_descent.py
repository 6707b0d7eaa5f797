"""The draw kernels' arithmetic (#5 ``sum_tree_sample``, #8 ``sum_tree_descend``
in ``csrc/sum_tree.cu``), emulated in torch on the CPU, against the plain
versions and JAX's Pallas kernels in interpret mode, bit for bit.

The emulation follows the kernel's order step by step:

- the corrected top: slots [0, 2^(S+1)) of the heap, every left child (and
  the root) less the masses of the active exclusions under it, summed from
  0 in exclusion-index order, as the pre-pass builds it slot by slot;
- the exclusions sorted stably by their level-S ancestor (their bucket),
  a draw's bucket found by binary search;
- S levels decided from the top, then rounds of two levels resolved from
  one set of loads (a float2 and a float4 of the slots under the round's
  node), each left child corrected by the draw's bucket; the leaf's stored
  mass taken from the last round's loads.

The kernel decides up to S = 10 levels from shared memory (``top_levels``);
the emulation also runs with S capped lower, so that trees of a few levels
go through several rounds.  With integer-valued priorities every sum is exact,
so the plain version's sums (in torch's order) and JAX's agree with the
kernel's index-order sums; on f32 priorities they agree without exclusions,
and with exclusions the emulation equals the per-draw scan of every
exclusion at every level, in index order, that the design replaces.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_per
from sheeprl_tpu_torch.data import device_buffer
from sheeprl_tpu_torch.ops import per

torch.set_num_threads(1)

W_RTOL = 1e-6


ROUND = 2  # csrc/sum_tree.cu: kRound, the levels a draw resolves from one set of loads
TOP_MAX = 10  # csrc/sum_tree.cu: kTopMax, the most levels a draw decides from shared memory
SOURCE = Path(per.__file__).resolve().parent.parent / "csrc" / "sum_tree.cu"


def _top_levels(depth, top_max):
    if depth <= top_max:
        return depth
    return depth - ROUND * ((depth - top_max + ROUND - 1) // ROUND)


def _exclusions(tree, depth, excl, eact):
    """Heap nodes and masses as the kernel stages them (0 and 0 where inactive)."""
    p = 1 << depth
    if excl is None:
        return torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.float32)
    en = torch.as_tensor(np.asarray(excl), dtype=torch.int64) + p
    act = torch.ones(en.shape, dtype=torch.bool) if eact is None else torch.as_tensor(np.asarray(eact), dtype=torch.bool)
    enode = torch.where(act, en, torch.zeros((), dtype=torch.int64))
    emass = torch.where(act, tree[en], torch.zeros(()))
    return enode, emass


def corrected_top_prepass(tree, depth, top, enode, emass):
    """The pre-pass: one slot at a time, every exclusion in index order."""
    slots = torch.arange(2 << top)
    level = torch.floor(torch.log2(slots.clamp_min(1).double())).long()
    summed = (slots == 1) | ((slots > 1) & (slots % 2 == 0))
    corr = torch.zeros(slots.shape, dtype=torch.float32)
    for e in range(enode.numel()):
        match = summed & ((enode[e] >> (depth - level)) == slots)
        corr = torch.where(match, corr + emass[e], corr)
    out = tree[: 2 << top] - corr
    out[0] = 0.0
    return out


def per_draw_scan(tree, vals, depth, enode, emass, *, sample):
    """The design the kernel replaces: at every level of every draw, every
    exclusion compared with the left child and its mass summed from 0 in
    index order; the total likewise.  Leaves, and masses or raw weights'
    inputs (the draw's stored mass)."""
    tree = tree.float()
    corr_total = torch.zeros(())
    for e in range(enode.numel()):
        corr_total = corr_total + emass[e]
    total = tree[1] - corr_total
    u = vals.float() * total if sample else vals.float().clone()
    node = torch.ones(u.shape, dtype=torch.int64)
    for lvl in range(depth):
        child = 2 * node
        corr = torch.zeros(u.shape)
        for e in range(enode.numel()):
            corr = torch.where((enode[e] >> (depth - 1 - lvl)) == child, corr + emass[e], corr)
        left = tree[child] - corr
        right = u >= left
        u = torch.where(right, u - left, u)
        node = child + right.long()
    return (node - (1 << depth)).to(torch.int32), tree[node]


def emulate(tree, vals, depth, excl=None, eact=None, *, sample, beta=0.4, count=1.0, top_max=TOP_MAX):
    """The kernel's draws: leaves (int32) and, for a sample, weights, else masses."""
    tree = tree.float()
    top = _top_levels(depth, top_max)
    enode, emass = _exclusions(tree, depth, excl, eact)
    s_top = corrected_top_prepass(tree, depth, top, enode, emass) if enode.numel() else tree[: 2 << top].clone()
    key_shift = depth - top
    order = torch.sort(enode >> key_shift, stable=True).indices
    sn, sm = enode[order], emass[order]
    skey = sn >> key_shift
    total = s_top[1]
    u = vals.float() * total if sample else vals.float().clone()
    node = torch.ones(u.shape, dtype=torch.int64)
    for _ in range(top):
        child = 2 * node
        left = s_top[child]
        right = u >= left
        u = torch.where(right, u - left, u)
        node = child + right.long()
    if depth > top:
        lo = hi = None
        width = 0
        for lvl in range(top, depth, ROUND):
            v = node
            loads = [tree[(v << j)[:, None] + torch.arange(1 << j)[None, :]] for j in range(1, ROUND + 1)]
            if lvl == top and sn.numel():
                lo = torch.searchsorted(skey, v, right=False)
                hi = torch.searchsorted(skey, v, right=True)
                width = int((hi - lo).max())
            for j in range(ROUND):
                child = 2 * node
                left = loads[j].gather(1, (child - (v << (j + 1)))[:, None])[:, 0]
                if width:
                    shift = depth - 1 - (lvl + j)
                    corr = torch.zeros(u.shape)
                    for m in range(width):
                        idx = lo + m
                        ok = idx < hi
                        idx = idx.clamp_max(sn.numel() - 1)
                        match = ok & ((sn[idx] >> shift) == child)
                        corr = torch.where(match, corr + sm[idx], corr)
                    left = torch.where(hi > lo, left - corr, left)
                right = u >= left
                u = torch.where(right, u - left, u)
                node = child + right.long()
            last = loads[-1]
        mass = last.gather(1, (node - (v << ROUND))[:, None])[:, 0]
    else:
        mass = tree[node]
    leaf = (node - (1 << depth)).to(torch.int32)
    if not sample:
        return leaf, mass
    tiny = torch.finfo(torch.float32).tiny
    probs = torch.clamp_min(mass, tiny) / torch.clamp_min(total, tiny)
    w = (max(float(count), 1.0) * probs) ** (-beta)
    return leaf, w / w.max()


def _heap(leaves):
    """The heap over ``leaves`` (a power of two of them), rebuilt as the tree does."""
    t = per.sum_tree_write_plain(
        torch.zeros(2 * leaves.numel()), torch.arange(leaves.numel()), leaves, torch.ones(leaves.numel(), dtype=torch.bool),
        depth=leaves.numel().bit_length() - 1,
    )
    return t


def _int_heap(rng, depth, hi=9):
    return _heap(torch.from_numpy(rng.integers(0, hi, 1 << depth).astype(np.float32)))


def _u(rng, tree, depth, excl, n):
    """Uniforms placed in the tree's mass less the excluded mass (exact on integers)."""
    m = float(tree[1]) - (float(tree[torch.as_tensor(excl, dtype=torch.int64) + (1 << depth)].sum()) if excl is not None else 0.0)
    return torch.from_numpy((rng.random(n) * m * (1 - 1e-7)).astype(np.float32))


CASES = [(d, e) for d in range(1, 16) for e in (0, 1, 4, 63, 252, 1025) if e < (1 << d)]


@pytest.mark.parametrize("depth,n_excl", CASES)
def test_emulated_descent_matches_plain(depth, n_excl):
    """Depths 1 to 15 (under, at and above the 10 levels from shared memory),
    E = 0 to 1025 exclusions, integer priorities: the emulated kernel's
    leaves and masses equal the plain version's, for S capped at 10 and at
    3 and 5 (several rounds)."""
    rng = np.random.default_rng(depth * 1000 + n_excl)
    tree = _int_heap(rng, depth)
    excl = rng.choice(1 << depth, n_excl, replace=False).astype(np.int32) if n_excl else None
    u = _u(rng, tree, depth, excl, 300)
    lp, mp = per.sum_tree_descend_plain(tree, u, depth=depth, exclude_idx=excl)
    for top_max in (TOP_MAX, 5, 3):
        le, me = emulate(tree, u, depth, excl, sample=False, top_max=top_max)
        assert torch.equal(le, lp) and torch.equal(me, mp), top_max
    if excl is not None:
        assert not np.isin(lp.numpy(), excl).any()


@pytest.mark.parametrize("depth", [1, 4, 10, 11, 13])
@pytest.mark.parametrize("n_excl", [0, 4, 63, 1025])
def test_emulated_descent_matches_jax_interpret(depth, n_excl):
    """The emulation against JAX's ``sum_tree_descend`` (interpret mode) on
    integer priorities, half the exclusions inactive."""
    if n_excl >= 1 << depth:
        n_excl = (1 << depth) - 1
    rng = np.random.default_rng(7 * depth + n_excl)
    tree = _int_heap(rng, depth)
    excl = eact = None
    if n_excl:
        excl = rng.choice(1 << depth, n_excl, replace=False).astype(np.int32)
        eact = rng.random(n_excl) < 0.5
    u = _u(rng, tree, depth, None if excl is None else excl[eact], 256)
    lj, mj = pallas_per.sum_tree_descend(
        jnp.asarray(tree.numpy()), jnp.asarray(u.numpy()), depth=depth, exclude_idx=excl, exclude_active=eact,
        interpret=True,
    )
    for top_max in (TOP_MAX, 3):
        le, me = emulate(tree, u, depth, excl, eact, sample=False, top_max=top_max)
        np.testing.assert_array_equal(le.numpy(), np.asarray(lj))
        np.testing.assert_array_equal(me.numpy(), np.asarray(mj))


@pytest.mark.parametrize("depth", [2, 12, 14])
@pytest.mark.parametrize("n_excl", [0, 1, 63, 252])
def test_emulated_sample_matches_plain_and_jax(depth, n_excl):
    """Draws with IS weights: the emulation's leaves equal JAX's
    ``sum_tree_sample`` (interpret mode, JAX's own uniforms) and the plain
    version's; weights to 1e-6 relative (``pow`` in two libraries)."""
    n_excl = min(n_excl, (1 << depth) - 1)
    rng = np.random.default_rng(depth + 31 * n_excl)
    tree = _int_heap(rng, depth)
    excl = rng.choice(1 << depth, n_excl, replace=False).astype(np.int32) if n_excl else None
    n = 512
    lj, wj = pallas_per.sum_tree_sample(
        jnp.asarray(tree.numpy()), jax.random.PRNGKey(depth), 0.4, float(1 << depth), n=n, depth=depth,
        exclude_idx=excl, interpret=True,
    )
    r01 = torch.from_numpy(np.asarray(jax.random.uniform(jax.random.PRNGKey(depth), (n,))))
    lp, wp = per.sum_tree_sample_plain(tree, r01, 0.4, float(1 << depth), depth=depth, exclude_idx=excl)
    for top_max in (TOP_MAX, 3):
        le, we = emulate(tree, r01, depth, excl, sample=True, beta=0.4, count=float(1 << depth), top_max=top_max)
        np.testing.assert_array_equal(le.numpy(), np.asarray(lj))
        assert torch.equal(le, lp)
        np.testing.assert_allclose(we.numpy(), np.asarray(wj), rtol=W_RTOL)
        np.testing.assert_allclose(we.numpy(), wp.numpy(), rtol=W_RTOL)


@pytest.mark.parametrize("depth", [3, 12, 15])
def test_emulated_f32_without_exclusions_is_exact(depth):
    """Random f32 priorities, no exclusions: the kernel's order is the plain
    descent's op for op, so leaves and masses are equal, and equal JAX's."""
    rng = np.random.default_rng(depth)
    tree = _heap(torch.from_numpy((rng.random(1 << depth) + 0.01).astype(np.float32)))
    u = torch.from_numpy((rng.random(400) * float(tree[1]) * (1 - 1e-7)).astype(np.float32))
    lp, mp = per.sum_tree_descend_plain(tree, u, depth=depth)
    lj, mj = pallas_per.sum_tree_descend(jnp.asarray(tree.numpy()), jnp.asarray(u.numpy()), depth=depth, interpret=True)
    for top_max in (TOP_MAX, 3):
        le, me = emulate(tree, u, depth, sample=False, top_max=top_max)
        assert torch.equal(le, lp) and torch.equal(me, mp)
        np.testing.assert_array_equal(le.numpy(), np.asarray(lj))


def _special_sets(depth):
    p = 1 << depth
    return {
        # adjacent leaves: one bucket holds them all (16 under a level-(d-4) node)
        "one_bucket": np.arange(p // 2, p // 2 + 16, dtype=np.int32),
        # a whole subtree emptied: every leaf under the node of leaves [p/4, p/4 + 64)
        "empty_subtree": np.arange(p // 4, p // 4 + 64, dtype=np.int32)[::-1].copy(),
        # shared buckets in shuffled index order, with a zero-mass leaf among them
        "shuffled": np.random.default_rng(depth).permutation(np.arange(3, 3 + 40, dtype=np.int32) * 3),
    }


@pytest.mark.parametrize("depth", [13, 16])
@pytest.mark.parametrize("name", ["one_bucket", "empty_subtree", "shuffled"])
def test_emulated_descent_special_exclusion_sets(depth, name):
    """Exclusions that share a bucket, adjacent leaves, and a set that
    empties a whole subtree (no draw may land there): the emulation equals
    the plain version and JAX's interpret-mode kernel."""
    rng = np.random.default_rng(depth)
    leaves = rng.integers(1, 9, 1 << depth).astype(np.float32)
    leaves[np.arange(3, 123, 3)[::7]] = 0.0
    tree = _heap(torch.from_numpy(leaves))
    excl = _special_sets(depth)[name]
    u = _u(rng, tree, depth, excl, 512)
    lp, mp = per.sum_tree_descend_plain(tree, u, depth=depth, exclude_idx=excl)
    lj, _ = pallas_per.sum_tree_descend(jnp.asarray(tree.numpy()), jnp.asarray(u.numpy()), depth=depth, exclude_idx=excl, interpret=True)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    for top_max in (TOP_MAX, 5):
        le, me = emulate(tree, u, depth, excl, sample=False, top_max=top_max)
        assert torch.equal(le, lp) and torch.equal(me, mp)
    assert not np.isin(lp.numpy(), excl).any()


@pytest.mark.parametrize("n_excl", [1, 5, 40])
def test_corrected_descent_equals_the_per_draw_scan_on_f32(n_excl):
    """On random f32 masses, where the order of the sums shows: the corrected
    top and the bucketed exclusions give every draw the leaf (and mass) that
    scanning every exclusion at every level, in index order, gives; for the
    descent and for the sample's leaves.  Shared buckets, shuffled index
    order, some exclusions inactive."""
    rng = np.random.default_rng(n_excl)
    depth = 14
    tree = _heap(torch.from_numpy((rng.random(1 << depth) + 0.01).astype(np.float32)))
    excl = np.concatenate([np.arange(100, 100 + n_excl // 2), rng.choice(1 << depth, n_excl - n_excl // 2, replace=False) | 1]).astype(np.int32)
    excl = np.unique(excl)[: n_excl]
    rng.shuffle(excl)
    eact = rng.random(excl.size) < 0.8
    enode, emass = _exclusions(tree, depth, excl, eact)
    r01 = torch.from_numpy(rng.random(2000).astype(np.float32))
    m = float(tree[1]) - float(emass.double().sum())
    u = r01 * np.float32(m * (1 - 1e-6))
    lw, mw = per_draw_scan(tree, u, depth, enode, emass, sample=False)
    for top_max in (TOP_MAX, 5):
        le, me = emulate(tree, u, depth, excl, eact, sample=False, top_max=top_max)
        assert torch.equal(le, lw) and torch.equal(me, mw)
        ls, _ = emulate(tree, r01, depth, excl, eact, sample=True, top_max=top_max)
        assert torch.equal(ls, per_draw_scan(tree, r01, depth, enode, emass, sample=True)[0])
    assert not np.isin(lw.numpy(), excl[eact]).any()


def test_top_levels_match_the_kernel():
    """The emulation's constants and top rule are the kernel's
    (``csrc/sum_tree.cu``: ``kTopMax``, ``kRound``, ``top_levels``): whole
    rounds of two below, at most 10 levels on top."""
    src = SOURCE.read_text()
    const = dict(re.findall(r"constexpr int (kTopMax|kRound) = (\d+);", src))
    assert int(const["kTopMax"]) == TOP_MAX and int(const["kRound"]) == ROUND
    body = re.search(r"int top_levels\(int depth\) \{\s*return ([^;]+);", src).group(1)
    assert " ".join(body.split()) == "depth <= kTopMax ? depth : depth - kRound * ((depth - kTopMax + kRound - 1) / kRound)"
    for depth in range(1, 31):
        s = _top_levels(depth, TOP_MAX)
        assert s <= TOP_MAX and (depth <= TOP_MAX or (depth - s) % ROUND == 0)


# ------------------------------------------------------------------ exclusion uploads
def _old_window_excl(pos, capacity, seq_len):
    n_envs = len(pos)
    offs = np.arange(1, seq_len)
    inv_rows = (pos[None, :] - offs[:, None]) % capacity
    return (inv_rows * n_envs + np.arange(n_envs)[None, :]).reshape(-1)


def _old_head_excl(pos, capacity):
    return ((pos - 1) % capacity) * len(pos) + np.arange(len(pos))


@pytest.mark.parametrize("n_envs", [1, 4, 16])
def test_draw_exclusions_are_the_same_values_in_the_same_order(n_envs):
    """The exclusions the prioritized draws upload (``sample_per``,
    ``sample_transitions_per``, ``_shard_exclusions``) are, value for value
    and in order, what the draws built before they were uploaded
    asynchronously: the L - 1 rows before each head, offset-major, and each
    env's head row; int32 now, on the device the cache names."""
    rng = np.random.default_rng(n_envs)
    capacity = 100
    for _ in range(5):
        pos = rng.integers(0, capacity, n_envs).astype(np.int64)
        for seq_len in (2, 5, 64):
            got = device_buffer.window_exclusions(pos, capacity, seq_len)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, _old_window_excl(pos, capacity, seq_len))
        assert device_buffer.window_exclusions(pos, capacity, 1) is None
        got = device_buffer.head_exclusions(pos, capacity)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, _old_head_excl(pos, capacity))
    up = device_buffer.upload(device_buffer.head_exclusions(pos, capacity), torch.device("cpu"))
    assert up.dtype == torch.int32 and up.device.type == "cpu"
    np.testing.assert_array_equal(up.numpy(), _old_head_excl(pos, capacity))


def test_cache_draws_upload_the_old_exclusions(monkeypatch):
    """Through the caches: the exclusions ``sample_per`` and
    ``sample_transitions_per`` hand to the tree, and each shard's
    ``_shard_exclusions``, equal the old formulas on the caches' heads."""
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayCache, ShardedDeviceReplayCache

    seen = []

    class _Tree:
        depth = 8

        def sample(self, n, *, beta, count, exclude_idx=None, exclude_active=None, generator=None, r01=None):
            seen.append(None if exclude_idx is None else exclude_idx.clone())
            return torch.zeros(n, dtype=torch.int64), torch.ones(n)

        def scale(self, *a, **k):
            pass

    for cls, kw in ((DeviceReplayCache, {}), (ShardedDeviceReplayCache, {"n_shards": 2})):
        cache = _make_cache(cls, **kw)
        if cls is DeviceReplayCache:
            monkeypatch.setattr(cache, "_tree", _Tree())
            monkeypatch.setattr(cache, "_check_tree", lambda: None)
            monkeypatch.setattr(cache, "_windows", lambda *a, **k: [])
            monkeypatch.setattr(cache, "_transitions", lambda *a, **k: {})
            seen.clear()
            cache.sample_per(1, 4, 3)
            cache.sample_transitions_per(1, 4, sample_next_obs=True, obs_keys=("obs",))
            np.testing.assert_array_equal(seen[0].numpy(), _old_window_excl(cache._pos, cache.capacity, 3))
            np.testing.assert_array_equal(seen[1].numpy(), _old_head_excl(cache._pos, cache.capacity))
        else:
            nl = cache.n_local_envs
            for r in range(2):
                pos_l = cache._pos[cache._cols(r)]
                got = cache._shard_exclusions(r, 3, ())
                np.testing.assert_array_equal(got.numpy(), _old_window_excl(pos_l, cache.capacity, 3))
                got = cache._shard_exclusions(r, None, ("obs",))
                np.testing.assert_array_equal(got.numpy(), ((pos_l - 1) % cache.capacity) * nl + np.arange(nl))
                assert got.dtype == torch.int32
                assert cache._shard_exclusions(r, None, ()) is None


def _make_cache(cls, n_shards=None):
    """A prioritized cache on the CPU, 12 rows of 4 envs added, then each
    env's write head moved apart (as envs added on their own leave them)."""
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime

    capacity, n_envs = 16, 4
    if n_shards is None:
        cache = cls(capacity, n_envs, device="cpu", prioritized=True, kernel="pallas")
    else:
        cache = cls(capacity, n_envs, MeshRuntime(devices=n_shards, device="cpu"), prioritized=True, kernel="pallas")
    rng = np.random.default_rng(0)
    cache.add({"obs": rng.normal(size=(12, n_envs, 3)).astype(np.float32),
               "rewards": np.zeros((12, n_envs, 1), np.float32)})
    cache._pos = np.array([3, 11, 0, 7])[:n_envs].astype(cache._pos.dtype)
    return cache

"""The port's sum-tree against the JAX package's.

- The plain versions of the three kernels (``ops/per.py``) against
  ``pallas_per.sum_tree_sample``/``sum_tree_write``/``sum_tree_update`` in
  interpret mode and against ``priority_tree``'s lax functions, which
  compute the same (the port keeps them once), and the lax path's own
  zeroed copy; trees of 6 to 2^12 leaves, counts that are not powers of two
  among them.
- Draws take the uniforms JAX draws from its key (``uniform(key, (n,))``).
  With integer-valued priorities every sum is exact, so leaves are identical
  and the weights agree to 1e-6 relative (``pow`` in two libraries).
- Writes: trees identical on slots ``1..`` (JAX leaves junk in slot 0),
  with equal duplicates, inactive lanes and unequal active duplicates (the
  last active lane wins, as XLA's scatter keeps on the CPU).
- ``PriorityTree``'s API against JAX's for both ``per_kernel`` settings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_per
from sheeprl_tpu.replay import priority_tree as jax_pt
from sheeprl_tpu_torch.ops.per import (
    sum_tree_sample,
    sum_tree_sample_plain,
    sum_tree_update,
    sum_tree_update_plain,
    sum_tree_write,
    sum_tree_write_plain,
)
from sheeprl_tpu_torch.replay import priority_tree as port_pt

KERNELS = ("lax", "pallas")
W_RTOL = 1e-6


def _depth(n_leaves):
    return max(int(n_leaves - 1).bit_length(), 1)


def _int_tree(rng, n_leaves, hi=9):
    """A full heap over integer-valued leaf priorities (exact sums)."""
    depth = _depth(n_leaves)
    pri = rng.integers(0, hi, n_leaves).astype(np.float32)
    t = port_pt.PriorityTree(n_leaves, device="cpu")
    t.set_priorities(np.arange(n_leaves), pri)
    return t.tree.numpy().copy(), depth



def _r01(seed, n):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))


@pytest.mark.parametrize("n_leaves", [8, 100, 4096])
@pytest.mark.parametrize("n_excl", [0, 3, 63])
def test_sample_plain_matches_pallas_interpret(n_leaves, n_excl):
    rng = np.random.default_rng(n_leaves + n_excl)
    tree, depth = _int_tree(rng, n_leaves)
    n = 512
    excl = None
    if n_excl:
        excl = rng.choice(n_leaves, size=min(n_excl, n_leaves - 1), replace=False).astype(np.int32)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        lj, wj = pallas_per.sum_tree_sample(
            jnp.asarray(tree), key, 0.4, float(n_leaves), n=n, depth=depth, exclude_idx=excl, interpret=True
        )
        lp, wp = sum_tree_sample_plain(
            torch.from_numpy(tree), torch.from_numpy(_r01(seed, n)), 0.4, float(n_leaves), depth=depth, exclude_idx=excl
        )
        assert lp.dtype == torch.int32
        np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
        np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=W_RTOL)
        if excl is not None:
            assert not np.isin(lp.numpy(), excl).any()


@pytest.mark.parametrize("n_leaves", [8, 100, 4096])
def test_lax_sample_and_zeroed_copy_match_jax(n_leaves):
    rng = np.random.default_rng(5)
    tree, depth = _int_tree(rng, n_leaves)
    excl = rng.choice(n_leaves, size=min(5, n_leaves - 1), replace=False).astype(np.int32)
    act = np.array([True, False, True, True, True][: len(excl)])
    zj = jax_pt._tree_zeroed(jnp.asarray(tree), jnp.asarray(excl), jnp.asarray(act), depth=depth)
    zp = port_pt._tree_zeroed(torch.from_numpy(tree), torch.from_numpy(excl), torch.from_numpy(act), depth)
    np.testing.assert_array_equal(zp.numpy()[1:], np.asarray(zj)[1:])
    key = jax.random.PRNGKey(3)
    lj, wj = jax_pt._tree_sample(zj, key, jnp.float32(1.0), jnp.float32(50.0), n=300, depth=depth)
    lp, wp = sum_tree_sample_plain(zp, torch.from_numpy(_r01(3, 300)), 1.0, 50.0, depth=depth)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=W_RTOL)


def test_sample_without_exclusions_matches_lax_on_float_priorities():
    """No exclusions: the corrected descent is op for op JAX's lax descent,
    so leaves agree exactly even on random f32 priorities."""
    rng = np.random.default_rng(1)
    pri = (rng.random(1000) + 0.01).astype(np.float32)
    t = port_pt.PriorityTree(1000, device="cpu")
    t.set_priorities(np.arange(1000), pri)
    lj, wj = jax_pt._tree_sample(jnp.asarray(t.tree.numpy()), jax.random.PRNGKey(4), jnp.float32(0.4), jnp.float32(1000.0), n=2048, depth=t.depth)
    lk, wk = sum_tree_sample_plain(t.tree, torch.from_numpy(_r01(4, 2048)), 0.4, 1000, depth=t.depth)
    np.testing.assert_array_equal(lk.numpy(), np.asarray(lj))
    np.testing.assert_allclose(wk.numpy(), np.asarray(wj), rtol=W_RTOL)


def _write_cases():
    rng = np.random.default_rng(7)
    n = 48
    return [
        # equal duplicates and inactive lanes
        (np.array([3, 3, 3, 5, 5, 0], np.int32), np.array([2.0, 2.0, 2.0, 7.0, 7.0, 1.5], np.float32),
         np.array([True, True, False, True, True, True])),
        # an inactive duplicate of an active leaf cannot drop its write
        (np.array([4, 4], np.int32), np.array([9.0, 123.0], np.float32), np.array([True, False])),
        # unequal active duplicates: the last active lane wins
        (rng.integers(0, 6, n).astype(np.int32), rng.random(n).astype(np.float32), rng.random(n) < 0.7),
    ]


@pytest.mark.parametrize("n_leaves", [6, 8, 1000])
@pytest.mark.parametrize("case", range(3))
def test_write_plain_matches_pallas_interpret(n_leaves, case):
    idx, vals, act = _write_cases()[case]
    idx = idx % n_leaves
    rng = np.random.default_rng(case)
    base = rng.random(2 << _depth(n_leaves)).astype(np.float32)
    tree = port_pt.PriorityTree(n_leaves, device="cpu")
    tree.set_priorities(np.arange(n_leaves), base[:n_leaves])
    t0 = tree.tree.numpy().copy()
    depth = tree.depth
    ref = np.asarray(pallas_per.sum_tree_write(jnp.asarray(t0), idx, vals, act, depth=depth, interpret=True))
    lax = np.asarray(jax_pt._tree_write(jnp.asarray(t0), jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(act), depth=depth))
    out = sum_tree_write_plain(torch.from_numpy(t0.copy()), torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(act), depth=depth)
    wrapped = sum_tree_write(torch.from_numpy(t0.copy()), idx, vals, act, depth=depth)
    for got in (out, wrapped):
        np.testing.assert_array_equal(got.numpy()[1:], ref[1:])
        np.testing.assert_array_equal(got.numpy()[1:], lax[1:])
        assert got.numpy()[0] == t0[0]  # slot 0 is never written
    if case == 2:  # the pinned rule, spelled out
        want = t0[(1 << depth) :].copy()
        for i in range(len(idx)):
            if act[i]:
                want[idx[i]] = vals[i]
        np.testing.assert_array_equal(out.numpy()[(1 << depth) :], want)


@pytest.mark.parametrize("n_leaves", [8, 100])
def test_update_plain_matches_pallas_interpret(n_leaves):
    idx, _, act = _write_cases()[2]
    idx = idx % n_leaves
    pri = np.random.default_rng(2).random(len(idx)).astype(np.float32) * 3
    tree, depth = _int_tree(np.random.default_rng(0), n_leaves)
    tj, mj = pallas_per.sum_tree_update(jnp.asarray(tree), 1.5, idx, pri, act, depth=depth, interpret=True)
    tl, ml = jax_pt._tree_update(jnp.asarray(tree), jnp.float32(1.5), jnp.asarray(idx), jnp.asarray(pri), jnp.asarray(act), depth=depth)
    tp = torch.from_numpy(tree.copy())
    mp = sum_tree_update_plain(tp, 1.5, torch.from_numpy(idx), torch.from_numpy(pri), torch.from_numpy(act), depth=depth)
    tw = torch.from_numpy(tree.copy())
    mw = sum_tree_update(tw, torch.tensor(1.5), idx, pri, act, depth=depth)
    for t, m in ((tp, mp), (tw, mw)):
        np.testing.assert_array_equal(t.numpy()[1:], np.asarray(tj)[1:])
        np.testing.assert_array_equal(t.numpy()[1:], np.asarray(tl)[1:])
        assert float(m) == float(mj) == float(ml)


def test_wrappers_take_the_plain_version_on_the_cpu():
    tree, depth = _int_tree(np.random.default_rng(0), 8)
    before = (sum_tree_sample.launches, sum_tree_write.launches, sum_tree_update.launches)
    sum_tree_sample(torch.from_numpy(tree), torch.rand(4), 0.4, 8, depth=depth)
    sum_tree_write(torch.from_numpy(tree), [1], [2.0], [True], depth=depth)
    sum_tree_update(torch.from_numpy(tree), 1.0, [1], [2.0], [True], depth=depth)
    assert (sum_tree_sample.launches, sum_tree_write.launches, sum_tree_update.launches) == before


# ------------------------------------------------------------- PriorityTree
def _tree_pair(kernel, n_leaves, alpha=1.0, eps=0.0):
    j = jax_pt.PriorityTree(n_leaves, alpha=alpha, eps=eps, kernel=kernel)
    p = port_pt.PriorityTree(n_leaves, alpha=alpha, eps=eps, kernel=kernel, device="cpu")
    return j, p


def _assert_trees(j, p, rtol=0.0):
    np.testing.assert_allclose(p.tree.numpy()[1:], np.asarray(j.tree)[1:], rtol=rtol, atol=0)
    np.testing.assert_allclose(float(p.max_priority), float(j.max_priority), rtol=rtol, atol=0)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("alpha,eps,rtol", [(1.0, 0.0, 0.0), (0.6, 1e-6, 1e-6)])
def test_priority_tree_api_matches_jax(kernel, alpha, eps, rtol):
    """Every write agrees bit for bit; with alpha = 0.6 the priorities
    (|delta| + eps)^alpha come from two libraries' ``pow`` (1 ulp)."""
    n = 37
    j, p = _tree_pair(kernel, n, alpha=alpha, eps=eps)
    assert p.depth == j.depth == 6
    for t in (j, p):
        t.seed_max(np.arange(10), np.ones(10, bool))
    _assert_trees(j, p)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 10, 16).astype(np.int32)
    td = rng.random(16).astype(np.float32) * 4
    act = rng.random(16) < 0.8
    j.update(idx, td, act)
    p.update(idx, td, act)
    _assert_trees(j, p, rtol)
    for t in (j, p):
        t.seed_max(np.array([20, 21, 22]), np.array([True, False, True]))
        t.scale(np.array([3, 3, 5, 20]), 0.5)
        t.set_priorities(np.array([30, 31]), np.array([4.0, 5.0], np.float32))
    _assert_trees(j, p, rtol)
    np.testing.assert_allclose(p.priorities(np.arange(n)).numpy(), np.asarray(j.priorities(np.arange(n))), rtol=rtol, atol=0)
    np.testing.assert_allclose(p.total, j.total, rtol=rtol)
    # state round trip, also across packages
    sj, sp = j.state_dict(), p.state_dict()
    np.testing.assert_allclose(sp["leaves"], np.asarray(sj["leaves"]), rtol=rtol, atol=0)
    q = port_pt.PriorityTree(n, kernel=kernel, device="cpu")
    q.load_state_dict(sj)
    _assert_trees(j, q, rtol)
    with pytest.raises(ValueError, match="leaves"):
        port_pt.PriorityTree(n + 1, device="cpu").load_state_dict(sp)


@pytest.mark.parametrize("kernel", KERNELS)
def test_priority_tree_sample_matches_jax(kernel):
    n = 200
    j, p = _tree_pair(kernel, n)
    pri = np.random.default_rng(3).integers(1, 7, n).astype(np.float32)
    j.set_priorities(np.arange(n), pri)
    p.set_priorities(np.arange(n), pri)
    ex = np.array([4, 50, 199], np.int32)
    key = jax.random.PRNGKey(9)
    lj, wj = j.sample(key, 256, beta=0.7, count=n, exclude_idx=ex)
    lp, wp = p.sample(256, beta=0.7, count=n, exclude_idx=ex, r01=torch.from_numpy(_r01(9, 256)))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=W_RTOL)
    # the exclusion is functional: the stored priorities survive
    assert float(p.priorities(4)) == pri[4]
    leaves, w = p.sample(64, beta=0.4, count=n, generator=torch.Generator().manual_seed(0))
    assert leaves.shape == w.shape == (64,) and float(w.max()) == 1.0


def test_helpers_match_jax():
    assert port_pt.resolve_per_kernel("PALLAS") == "pallas"
    with pytest.raises(ValueError, match="per_kernel"):
        port_pt.resolve_per_kernel("triton")
    bj, bp = jax_pt.per_beta_schedule(0.4, 1.0, 1000), port_pt.per_beta_schedule(0.4, 1.0, 1000)
    for step in (0, 10, 500, 2000):
        assert bj(step) == bp(step)
    td = np.array([-2.0, 0.0, 3.5], np.float32)
    np.testing.assert_allclose(
        port_pt.priority_from_td(torch.from_numpy(td), 0.6, 1e-6).numpy(),
        np.asarray(jax_pt.priority_from_td(jnp.asarray(td), 0.6, 1e-6)),
        rtol=W_RTOL,
    )
    # the env-sharded tree and draw are ported (tests/test_torch_sharded_per.py);
    # like every entry point, the tree lives on the card unless told otherwise
    with pytest.raises(RuntimeError, match="CUDA"):
        port_pt.ShardedPriorityTree(8, 2, 2, None)
    t = port_pt.ShardedPriorityTree(8, 2, 2, "cpu")
    assert len(port_pt.shard_proportional_draw(list(t.trees), torch.rand(4), depth=t.depth)) == 2

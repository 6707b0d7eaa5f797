"""The port's env-sharded sum-tree against the JAX package's.

- The plain versions of kernels #8 and #9 (``ops/per.py``
  ``sum_tree_descend_plain``/``sum_tree_scatter_plain``) against
  ``pallas_per.sum_tree_descend``/``sum_tree_scatter`` in interpret mode and
  against the lax ``_descend``/``_write_impl``, at depths 3-10, with 0, 4
  and 63 exclusions, duplicate lanes and lanes of other shards.
- ``shard_proportional_draw`` for meshes of 2, 4 and 8 shards and both
  ``per_kernel`` settings against JAX's inside ``shard_map`` on the
  conftest's 8 host devices, JAX's ``uniform(key, (n,))`` fed as ``r01``:
  every shard's ``(leaf, mass, own, total)``.
- ``ShardedPriorityTree``'s writes and reads against JAX's, its checkpoint
  state both ways, and a load from a single-device tree's state.

Priorities are integer-valued (dyadic after a decay of 0.5), so every sum
is exact: leaves, masses and trees (from slot 1: JAX parks inactive lanes
at slot 0) are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sheeprl_tpu.ops import pallas_per
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu.parallel.sharding import BATCH_AXES
from sheeprl_tpu.replay import priority_tree as jax_pt
from sheeprl_tpu.utils.jax_compat import shard_map
from sheeprl_tpu_torch.ops.per import sum_tree_descend, sum_tree_descend_plain, sum_tree_scatter, sum_tree_scatter_plain
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.parallel.sharding import pmax, psum
from sheeprl_tpu_torch.replay import priority_tree as port_pt

KERNELS = ("lax", "pallas")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} host devices")


def _heap(pri, depth):
    """A full (2P,) f32 heap over ``pri``, internal nodes summed on the host."""
    p = 1 << depth
    full = np.zeros(2 * p, np.float32)
    full[p : p + len(pri)] = pri
    for node in range(p - 1, 0, -1):
        full[node] = full[2 * node] + full[2 * node + 1]
    return full


# ------------------------------------------------------------ kernels #8, #9
@pytest.mark.parametrize("depth", [3, 6, 10])
@pytest.mark.parametrize("n_excl", [0, 4, 63])
def test_descend_plain_matches_pallas_and_lax(depth, n_excl):
    rng = np.random.default_rng(depth * 100 + n_excl)
    n_leaves = (1 << depth) - 3
    pri = rng.integers(0, 9, n_leaves).astype(np.float32)
    tree = _heap(pri, depth)
    n_excl = min(n_excl, n_leaves // 2)
    excl = rng.choice(n_leaves, n_excl, replace=False).astype(np.int32) if n_excl else None
    eact = (rng.random(n_excl) < 0.8) if n_excl else None
    m = tree[1] - (float(pri[excl][eact].sum()) if n_excl else 0.0)
    u = (np.asarray(jax.random.uniform(jax.random.PRNGKey(depth), (300,))) * np.float32(m)).astype(np.float32)
    lj, mj = pallas_per.sum_tree_descend(
        jnp.asarray(tree), jnp.asarray(u), depth=depth, exclude_idx=excl, exclude_active=eact, interpret=True
    )
    lp, mp = sum_tree_descend_plain(torch.from_numpy(tree), torch.from_numpy(u), depth=depth, exclude_idx=excl,
                                    exclude_active=None if eact is None else torch.from_numpy(eact))
    assert lp.dtype == torch.int32 and mp.dtype == torch.float32
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mj))
    # the wrapper takes its plain version for a tree on the CPU
    lw, mw = sum_tree_descend(torch.from_numpy(tree), torch.from_numpy(u), depth=depth, exclude_idx=excl,
                              exclude_active=None if eact is None else torch.from_numpy(eact))
    assert torch.equal(lw, lp) and torch.equal(mw, mp)
    if n_excl:
        assert not np.isin(lp.numpy(), excl[eact]).any()
    else:  # without exclusions: the lax descent, op for op
        ll, ml = jax_pt._descend(jnp.asarray(tree), jnp.asarray(u), depth)
        np.testing.assert_array_equal(lp.numpy(), np.asarray(ll))
        np.testing.assert_array_equal(mp.numpy(), np.asarray(ml))


@pytest.mark.parametrize("depth", [3, 7, 10])
@pytest.mark.parametrize("lanes", [5, 64, 400])
def test_scatter_plain_matches_pallas_and_lax(depth, lanes):
    """One shard's masked write, as ``ShardedPriorityTree._build_write``'s
    body computes it: duplicate leaves within the shard (equal and unequal
    values), inactive lanes, and lanes of other shards on the same local
    leaves; the tree from slot 1 and the candidate max exact."""
    rng = np.random.default_rng(depth * 1000 + lanes)
    p = 1 << depth
    tree = _heap(rng.integers(0, 9, p).astype(np.float32), depth)
    leaf = rng.integers(0, p, lanes).astype(np.int32)
    leaf[lanes // 2 :] = leaf[: lanes - lanes // 2]  # every leaf twice: duplicates and other shards' lanes
    vals = rng.integers(1, 20, lanes).astype(np.float32)
    active = rng.random(lanes) < 0.8
    shard_ids = rng.integers(0, 3, lanes).astype(np.int32)
    for rank in range(3):
        act = active & (shard_ids == rank)
        tj = pallas_per.sum_tree_scatter(jnp.asarray(tree), leaf, vals, act, depth=depth, interpret=True)
        tl = jax_pt._write_impl(jnp.asarray(tree), jnp.asarray(leaf), jnp.asarray(vals), jnp.asarray(act), depth)
        cand_j = float(jnp.max(jnp.where(act, vals, 0.0)))
        tp = torch.from_numpy(tree.copy())
        out, cand = sum_tree_scatter_plain(tp, leaf, vals, active, shard_ids, rank, depth=depth)
        assert out is tp  # in place
        np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(tj)[1:])
        np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(tl)[1:])
        assert float(cand) == cand_j
        tw = torch.from_numpy(tree.copy())
        _, cand_w = sum_tree_scatter(tw, torch.from_numpy(leaf), torch.from_numpy(vals), torch.from_numpy(active),
                                     torch.from_numpy(shard_ids), rank, depth=depth)
        assert torch.equal(tw, tp) and float(cand_w) == cand_j


def test_collectives_and_rank():
    parts = [torch.tensor([1.0, -2.0]), torch.tensor([3.0, 5.0]), torch.tensor([-4.0, 0.5])]
    assert torch.equal(psum(parts), torch.tensor([0.0, 3.5]))
    assert torch.equal(pmax(parts), torch.tensor([3.0, 5.0]))
    # added in shard order: f32 addition does not associate
    big = [torch.tensor([1.0]), torch.tensor([1e8]), torch.tensor([-1e8])]
    assert float(psum(big)) == 0.0 and float(big[0] + (big[1] + big[2])) == 1.0


# ------------------------------------------------------- shard_proportional_draw
def _jax_draw(rt, trees, key, n, depth, kernel, excl):
    """JAX's per-shard draw inside shard_map; per-shard outputs stacked."""
    mesh = rt.mesh
    n_shards = trees.shape[0]

    def body(t, ex, key):
        r = jax.lax.axis_index(BATCH_AXES[0]) * int(mesh.shape[BATCH_AXES[1]]) + jax.lax.axis_index(BATCH_AXES[1])
        tree = t[0]
        if kernel == "pallas":
            leaf, mass, own, total = jax_pt.shard_proportional_draw(
                tree, key, r, n_shards, BATCH_AXES, n=n, depth=depth, kernel="pallas",
                exclude_idx=None if ex is None else ex[0],
            )
        else:
            if ex is not None:
                tree = jax_pt._tree_zeroed_local(tree, ex[0], depth)
            leaf, mass, own, total = jax_pt.shard_proportional_draw(tree, key, r, n_shards, BATCH_AXES, n=n, depth=depth)
        return leaf[None], mass[None], own[None], total.reshape(1)

    in_specs = (P(BATCH_AXES, None), None if excl is None else P(BATCH_AXES, None), P())
    if excl is None:
        fn = shard_map(lambda t, key: body(t, None, key), mesh=mesh, in_specs=(in_specs[0], P()),
                       out_specs=(P(BATCH_AXES),) * 4, check_vma=False)
        out = jax.jit(fn)(jnp.asarray(trees), key)
    else:
        fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=(P(BATCH_AXES),) * 4, check_vma=False)
        out = jax.jit(fn)(jnp.asarray(trees), jnp.asarray(excl), key)
    return [np.asarray(o).reshape(n_shards, -1) for o in out]


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("with_excl", [False, True])
def test_shard_proportional_draw_matches_jax(n_shards, kernel, with_excl):
    _need(n_shards)
    rt = JaxRuntime(devices=n_shards, strategy="dp", accelerator="cpu").launch()
    rng = np.random.default_rng(n_shards * 10 + len(kernel))
    cap, n_local, n = 16, 2, 512
    depth = max(int(cap * n_local - 1).bit_length(), 1)
    pri = rng.integers(0, 9, (n_shards, cap * n_local)).astype(np.float32)
    pri[1] = 0.0  # a shard without mass: its interval is empty
    trees = np.stack([_heap(p_, depth) for p_ in pri])
    excl = None
    if with_excl:  # each env's head row, or the L - 1 rows before it: distinct per shard
        excl = np.stack([rng.choice(cap * n_local, 5, replace=False) for _ in range(n_shards)]).astype(np.int32)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        lj, mj, oj, tj = _jax_draw(rt, trees, key, n, depth, kernel, excl)
        r01 = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
        t_trees = [torch.from_numpy(t.copy()) for t in trees]
        if kernel == "lax" and excl is not None:
            t_trees = [port_pt._tree_zeroed_local(t, torch.from_numpy(e), depth) for t, e in zip(t_trees, excl)]
        got = port_pt.shard_proportional_draw(
            t_trees, r01, depth=depth, kernel=kernel,
            exclude_idx=None if kernel == "lax" or excl is None else [torch.from_numpy(e) for e in excl],
        )
        owners = np.zeros(n, np.int64)
        for r, (leaf, mass, own, total) in enumerate(got):
            np.testing.assert_array_equal(leaf.numpy(), lj[r], err_msg=f"shard {r} leaves")
            np.testing.assert_array_equal(mass.numpy(), mj[r], err_msg=f"shard {r} masses")
            np.testing.assert_array_equal(own.numpy(), oj[r], err_msg=f"shard {r} ownership")
            assert float(total) == float(tj[r, 0])
            owners += own.numpy()
        assert (owners == 1).all()  # each draw has exactly one owner
        assert not got[1][2].any()  # the empty shard owns nothing


def test_lax_draw_refuses_exclusions():
    t = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="lax path"):
        port_pt.shard_proportional_draw(list(t), torch.rand(4), depth=3, exclude_idx=[torch.tensor([0])] * 2)


# ------------------------------------------------------- ShardedPriorityTree
def _tree_pair(n_shards, kernel, cap=16, n_envs=8):
    rt = JaxRuntime(devices=n_shards, strategy="dp", accelerator="cpu").launch()
    j = jax_pt.ShardedPriorityTree(cap, n_envs, n_shards, rt.mesh, alpha=1.0, eps=0.0, kernel=kernel)
    t = port_pt.ShardedPriorityTree(cap, n_envs, n_shards, "cpu", alpha=1.0, eps=0.0, kernel=kernel)
    return j, t


def _same_trees(j, t):
    np.testing.assert_array_equal(t.trees.numpy()[:, 1:], np.asarray(j.trees)[:, 1:])
    assert float(t.max_priority) == float(j.max_priority)
    assert t.total == float(j.total)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_tree_matches_jax(n_shards, kernel):
    _need(n_shards)
    j, t = _tree_pair(n_shards, kernel)
    n = j.n_leaves
    assert (t.depth, t.n_leaves_local, t.n_local_envs) == (j.depth, j.n_leaves_local, j.n_local_envs)
    rng = np.random.default_rng(n_shards)
    pri = rng.integers(0, 9, n).astype(np.float32)
    for tree in (j, t):
        tree.set_priorities(np.arange(n), pri)
    _same_trees(j, t)
    # seeding at the running max (no max tracking), duplicates included
    idx = rng.integers(0, n, 40).astype(np.int32)
    act = rng.random(40) < 0.7
    for tree in (j, t):
        tree.seed_max(idx, act)
    _same_trees(j, t)
    # TD feedback: alpha 1, eps 0 on integer |delta|; the max goes global
    idx = rng.choice(n, 30, replace=False).astype(np.int32)
    td = rng.integers(1, 40, 30).astype(np.float32)
    for tree in (j, t):
        tree.update(idx, td)
    _same_trees(j, t)
    assert float(t.max_priority) == float(td.max())
    for tree in (j, t):
        tree.scale(np.concatenate([idx[:10], idx[:3]]), 0.5)  # duplicates scale once
    _same_trees(j, t)
    q = rng.integers(0, n, 50).astype(np.int32)
    np.testing.assert_array_equal(t.priorities(q).numpy(), np.asarray(j.priorities(q)))
    sd_j, sd_t = j.state_dict(), t.state_dict()
    np.testing.assert_array_equal(sd_t["leaves"], sd_j["leaves"])
    assert float(sd_t["max_priority"]) == float(sd_j["max_priority"])
    # each side loads the other's state
    t2 = port_pt.ShardedPriorityTree(16, 8, n_shards, "cpu", alpha=1.0, eps=0.0, kernel=kernel)
    t2.load_state_dict(sd_j)
    np.testing.assert_array_equal(t2.trees.numpy()[:, 1:], np.asarray(j.trees)[:, 1:])
    j.load_state_dict(sd_t)
    _same_trees(j, t)


@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_tree_loads_a_single_device_state(kernel):
    """Global leaf order: a sharded run resumes from a single-device tree's
    state and its own state loads back into a single-device tree."""
    rng = np.random.default_rng(7)
    cap, n_envs = 16, 8
    single = port_pt.PriorityTree(cap * n_envs, device="cpu", kernel=kernel)
    single.set_priorities(np.arange(cap * n_envs), rng.integers(0, 9, cap * n_envs).astype(np.float32))
    single.update(np.arange(5), np.full(5, 3.0, np.float32))
    sharded = port_pt.ShardedPriorityTree(cap, n_envs, 4, "cpu", kernel=kernel)
    sharded.load_state_dict(single.state_dict())
    q = np.arange(cap * n_envs)
    np.testing.assert_array_equal(sharded.priorities(q).numpy(), single.priorities(q).numpy())
    assert sharded.total == single.total and float(sharded.max_priority) == float(single.max_priority)
    back = port_pt.PriorityTree(cap * n_envs, device="cpu")
    back.load_state_dict(sharded.state_dict())
    assert torch.equal(back.tree, single.tree)


def test_sharded_tree_refuses_uneven_envs():
    with pytest.raises(ValueError, match="divide"):
        port_pt.ShardedPriorityTree(16, 6, 4, "cpu")


def test_mesh_runtime_shards_one_device():
    rt = MeshRuntime(devices=4, device="cpu").launch()
    assert (rt.device_count, rt.world_size, rt.device) == (4, 4, torch.device("cpu"))
    batch = {"x": torch.zeros(3, 8, 2)}
    assert rt.shard_batch(batch, axis=1) is batch
    with pytest.raises(ValueError, match="divide"):
        rt.shard_batch({"x": torch.zeros(3, 6)}, axis=1)
    assert MeshRuntime(device=["cpu", "cpu"], devices=2).device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="2 devices"):
        MeshRuntime(device=["cpu", "meta"], devices=2)
    assert MeshRuntime(device="cpu").device_count == 1

"""The port's env-sharded replay cache against the JAX package's.

JAX's ``ShardedDeviceReplayCache`` runs on a ``MeshRuntime(devices=N,
strategy="dp", accelerator="cpu")`` over the conftest's 8 host devices, the
port's on ``MeshRuntime(devices=N, device="cpu")``, both on a 16-row ring of
8 envs (as ``tests/test_parallel/test_sharding.py``).  The same adds go into
both; every draw takes JAX's uniforms: per shard ``fold_in(key, rank)``
split into the env and row draws of the stratified uniform samplers, and
``uniform(key, (n,))`` for a prioritized draw.  Priorities stay
integer-valued (alpha 1, eps 0, integer |delta|, decay 0.5), so rings,
batches, leaves and trees (from slot 1) are compared bit for bit and the IS
weights to 1e-6 relative (``pow`` in two libraries).

Also: the sharded draw's per-cell marginals against the analytic ones
(JAX's bound of 0.008), the gating of ``_maybe_create_sharded``, two SAC
``train_dispatch`` calls on a 4-shard mesh against the single-shard port on
the same draws, and a CPU rehearsal of ``chip_smoke.py``'s ``sac_sharded``
phase.
"""

import copy
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.data import device_buffer as jax_db
from sheeprl_tpu.parallel.mesh import MeshRuntime as JaxRuntime
from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import make_train_state, train_dispatch
from sheeprl_tpu_torch.config import compose as port_compose
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import (
    DeviceReplayCache,
    ShardedDeviceReplayCache,
    maybe_create_for,
    maybe_create_for_transitions,
)
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.replay import per_beta_schedule

from test_torch_replay import JaxCache

KERNELS = ("lax", "pallas")
W_RTOL = 1e-6
CAP, N_ENVS = 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxSharded(jax_db.ShardedDeviceReplayCache):
    """JAX's sharded cache with int64 write heads and fill counts, for the
    reason ``JaxCache`` gives."""

    _pos = JaxCache._pos
    _filled = JaxCache._filled


def _need(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} host devices")


def _rows(rng, t_len, n_envs, t0):
    """The row's time in the first observation feature and in the reward,
    so that a window can be read back."""
    obs = rng.normal(size=(t_len, n_envs, 3)).astype(np.float32)
    obs[..., 0] = np.arange(t0, t0 + t_len, dtype=np.float32)[:, None]
    return {
        "obs": obs,
        "rewards": np.broadcast_to(np.arange(t0, t0 + t_len, dtype=np.float32)[:, None, None], (t_len, n_envs, 1)).copy(),
        "terminated": (rng.uniform(size=(t_len, n_envs, 1)) < 0.1).astype(np.uint8),
    }


def _pair(n_shards, kernel, steps=21, prioritized=True):
    _need(n_shards)
    rt = JaxRuntime(devices=n_shards, strategy="dp", accelerator="cpu").launch()
    kw = {"prioritized": prioritized, "per_alpha": 1.0, "per_eps": 0.0, "per_decay": 0.5, "kernel": kernel}
    j = JaxSharded(CAP, N_ENVS, rt, **kw)
    p = ShardedDeviceReplayCache(CAP, N_ENVS, MeshRuntime(devices=n_shards, device="cpu"), **kw)
    rng = np.random.default_rng(n_shards)
    for t0, t_len in ((0, 5), (5, 1), (6, steps - 6)):  # the last add wraps the ring
        data = _rows(rng, t_len, N_ENVS, t0)
        j.add(data)
        p.add(data)
    return j, p, rng


def _jax_local_draws(key, n_shards, flat_local):
    """The stratified samplers' per-shard draws: ``fold_in(key, rank)``,
    split into the env and the row/start draws."""
    n_local = N_ENVS // n_shards
    envs, u = [], []
    for r in range(n_shards):
        k_env, k_u = jax.random.split(jax.random.fold_in(key, r))
        envs.append(np.asarray(jax.random.randint(k_env, (flat_local,), 0, n_local)))
        u.append(np.asarray(jax.random.uniform(k_u, (flat_local,))))
    return torch.from_numpy(np.stack(envs).astype(np.int32)), torch.from_numpy(np.stack(u))


def _r01(key, n):
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))


def _same_bytes(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=f"{what} '{k}'")


def _same_trees(j, p):
    np.testing.assert_array_equal(p.tree.trees.numpy()[:, 1:], np.asarray(j._tree.trees)[:, 1:])
    assert float(p.tree.max_priority) == float(j._tree.max_priority)


def _set_integer_priorities(j, p, rng):
    n = CAP * N_ENVS
    written = np.zeros((CAP, N_ENVS), np.float32)
    written[: int(p._filled.min())] = 1.0
    pri = (rng.integers(1, 9, (CAP, N_ENVS)).astype(np.float32) * written).reshape(-1)
    j._tree.set_priorities(np.arange(n), pri)
    p.tree.set_priorities(np.arange(n), pri)
    return pri


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_adds_and_uniform_draws_match_jax(n_shards, kernel):
    j, p, _ = _pair(n_shards, kernel)
    for k, ring in p.buffers.items():
        np.testing.assert_array_equal(ring.numpy(), np.asarray(j._bufs[k]), err_msg=k)
        for r in range(n_shards):  # a shard's rings are its env columns
            nl = N_ENVS // n_shards
            assert torch.equal(p.shard_buffers(r)[k], ring[:, r * nl : (r + 1) * nl])
    assert np.array_equal(p._pos, j._pos) and np.array_equal(p._filled, j._filled)
    _same_trees(j, p)
    n_samples, batch, seq_len = 2, 16, 4
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = j.sample(n_samples, batch, seq_len, key)
        envs, u = _jax_local_draws(key, n_shards, n_samples * batch // n_shards)
        got = p.sample(n_samples, batch, seq_len, envs=envs, u=u)
        for i in range(n_samples):
            _same_bytes(got[i], want[i], f"window batch {i}")
        rw = got[0]["rewards"].numpy()[:, :, 0]
        assert set(np.unique(rw[1:] - rw[:-1])) <= {1.0}  # windows advance a row a step
        for next_obs in (False, True):
            want = j.sample_transitions(n_samples, batch, key, sample_next_obs=next_obs, obs_keys=("obs",))
            got = p.sample_transitions(n_samples, batch, sample_next_obs=next_obs, obs_keys=("obs",), envs=envs, u=u)
            _same_bytes(got, want, f"transitions next_obs={next_obs}")


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_prioritized_draws_and_feedback_match_jax(n_shards, kernel):
    j, p, rng = _pair(n_shards, kernel)
    _set_integer_priorities(j, p, rng)
    _same_trees(j, p)
    n_samples, batch = 3, 16
    for seed, next_obs in ((0, False), (1, True), (2, True)):
        key = jax.random.PRNGKey(seed)
        out_j, lv_j = j.sample_transitions_per(n_samples, batch, key, 0.4, sample_next_obs=next_obs, obs_keys=("obs",))
        out_p, lv_p = p.sample_transitions_per(
            n_samples, batch, None, 0.4, sample_next_obs=next_obs, obs_keys=("obs",), r01=_r01(key, n_samples * batch)
        )
        assert lv_p.dtype == torch.int32
        np.testing.assert_array_equal(lv_p.numpy(), np.asarray(lv_j))
        wj = np.asarray(out_j.pop("is_weights"))
        np.testing.assert_allclose(out_p.pop("is_weights").numpy(), wj, rtol=W_RTOL)
        _same_bytes(out_p, out_j, f"prioritized transitions next_obs={next_obs}")
        if next_obs:  # the head rows are never drawn
            head = (p._pos - 1) % CAP
            assert not np.isin(lv_p.numpy(), head * N_ENVS + np.arange(N_ENVS)).any()
        td = rng.integers(0, 12, lv_p.shape).astype(np.float32)
        j.update_priorities(lv_j, td)
        p.update_priorities(lv_p, td)
        _same_trees(j, p)
    # prioritized window starts, decayed by 0.5 after the draw
    for seed in (3, 4):
        key = jax.random.PRNGKey(seed)
        want = j.sample_per(2, 16, 4, key, beta=0.0)
        got = p.sample_per(2, 16, 4, r01=_r01(key, 32))
        for i in range(2):
            _same_bytes(got[i], want[i], f"prioritized windows {i}")
        rw = got[0]["rewards"].numpy()[:, :, 0]
        assert set(np.unique(rw[1:] - rw[:-1])) <= {1.0}
        _same_trees(j, p)
    np.testing.assert_array_equal(p.priority_state()["leaves"], j.priority_state()["leaves"])


def test_sharded_marginals_match_the_analytic_ones():
    """The parity property the sharded design rests on, through the port's
    own draws: the per-cell marginals of 25 draws of 4 x 64 on the 16 x 8
    ring within JAX's 0.008 of the proportional ones, head rows excluded."""
    p = ShardedDeviceReplayCache(CAP, N_ENVS, MeshRuntime(devices=8, device="cpu"), prioritized=True,
                                 per_alpha=1.0, per_eps=0.0, kernel="pallas")
    rng = np.random.default_rng(1)
    for t in range(12):
        p.add(_rows(rng, 1, N_ENVS, t))
    n = CAP * N_ENVS
    written = np.zeros((CAP, N_ENVS), np.float32)
    written[:12] = 1.0
    pri = (rng.uniform(0.1, 3.0, size=(CAP, N_ENVS)).astype(np.float32) * written).reshape(-1)
    p.tree.set_priorities(np.arange(n), pri)
    gen = torch.Generator().manual_seed(0)
    draws = [p.sample_transitions_per(4, 64, gen, 0.0, sample_next_obs=True, obs_keys=("obs",))[1].reshape(-1).numpy()
             for _ in range(25)]
    emp = np.bincount(np.concatenate(draws), minlength=n).astype(np.float64)
    emp /= emp.sum()
    pw = pri.copy().reshape(CAP, N_ENVS)
    pw[(p._pos - 1) % CAP, np.arange(N_ENVS)] = 0.0
    pw = pw.reshape(-1) / pw.sum()
    assert np.abs(emp - pw).max() < 0.008


# ------------------------------------------------------------------ gating
def _cfg(**buffer):
    return dotdict({"buffer": {"device_cache": "auto", "per_kernel": "pallas", "prioritized": False, **buffer}})


def _host(n_envs, rows=6):
    rb = ReplayBuffer(CAP, n_envs, obs_keys=("obs",))
    rb.add(_rows(np.random.default_rng(0), rows, n_envs, 0))
    return rb


def test_gating_of_the_sharded_cache(capsys):
    _need(4)
    rt4 = MeshRuntime(devices=4, device="cpu")
    # prioritized on a 4-shard mesh: the sharded cache and JAX's line
    cache = maybe_create_for_transitions(_cfg(prioritized=True), rt4, _host(8))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert type(cache) is ShardedDeviceReplayCache and cache.tree.n_shards == 4 and cache.tree.total == 48.0
    jax_db._maybe_create_sharded(_cfg(prioritized=True), JaxRuntime(devices=4, strategy="dp", accelerator="cpu").launch(), CAP, 8)
    assert line == capsys.readouterr().out.strip().splitlines()[-1]
    assert "env-sharded replay window enabled" in line and "prioritized per-shard sum-trees" in line
    assert DeviceReplayCache.maybe_create(_cfg(prioritized=True), rt4, CAP, 8) is None
    # uniform with device_cache on; auto without PER stays on the host
    assert type(maybe_create_for_transitions(_cfg(device_cache=True), rt4, _host(8))) is ShardedDeviceReplayCache
    assert maybe_create_for_transitions(_cfg(), rt4, _host(8)) is None
    # envs that do not divide over the shards: PER raises, uniform keeps the host feed
    with pytest.raises(ValueError, match="not divisible by 4 devices"):
        maybe_create_for_transitions(_cfg(prioritized=True), rt4, _host(6))
    capsys.readouterr()
    assert maybe_create_for_transitions(_cfg(device_cache=True), rt4, _host(6)) is None
    assert "device_cache=True ignored" in capsys.readouterr().out
    # one shard keeps the single-device cache
    assert type(maybe_create_for_transitions(_cfg(prioritized=True), MeshRuntime(device="cpu"), _host(8))) is DeviceReplayCache
    # the sequence family routes the same way
    seq = EnvIndependentReplayBuffer(CAP, n_envs=4, buffer_cls=SequentialReplayBuffer)
    seq.add({k: v[:, :4] for k, v in _rows(np.random.default_rng(1), 8, 8, 0).items()})
    got = maybe_create_for(_cfg(prioritized=True), rt4, seq)
    assert type(got) is ShardedDeviceReplayCache
    np.testing.assert_array_equal(got.buffers["obs"].numpy()[:8], np.concatenate([b.buffer["obs"][:8] for b in seq.buffer], 1))


# ------------------------------------------------------------------ SAC dispatch
OBS, ACT = 5, 2
G, B = 3, 8
SAC_OVERRIDES = [
    "exp=sac_dmc_walker_walk", "algo.hidden_size=16", f"algo.per_rank_batch_size={B}",
    "buffer.memmap=False", "buffer.device_cache=True", "buffer.prioritized=True", "buffer.per_kernel=pallas",
]


def _sac_rows(rng, t_len, n_envs):
    obs = rng.normal(size=(t_len, n_envs, OBS)).astype(np.float32)
    return {
        "terminated": (rng.uniform(size=(t_len, n_envs, 1)) < 0.05).astype(np.uint8),
        "truncated": np.zeros((t_len, n_envs, 1), np.uint8),
        "actions": rng.uniform(-1, 1, size=(t_len, n_envs, ACT)).astype(np.float32),
        "observations": obs,
        "next_observations": (obs + 0.1).astype(np.float32),
        "rewards": rng.normal(size=(t_len, n_envs, 1)).astype(np.float32),
    }


def _r01_for(tree, leaves):
    """Uniforms that draw ``leaves`` from a single-device tree: the middle of
    each leaf's interval of the CDF (integer priorities: exact sums)."""
    p = 1 << tree.depth
    pri = tree.tree[p : p + tree.n_leaves].double()
    start = torch.cumsum(pri, 0) - pri
    lv = leaves.reshape(-1).long()
    return ((start[lv] + pri[lv] / 2) / pri.sum()).float()


def test_train_dispatch_on_four_shards_matches_one_shard():
    """Two dispatches on a 4-shard CPU mesh and on one shard, from the same
    leaves and weights: the 4-shard run takes ``per_rank_batch_size`` rows
    a shard, so it trains on the batch of one shard with four times that
    (JAX's ``main`` scales the batch by the world size).  The one-shard
    cache is fed the uniforms that draw the sharded draw's cells (the two
    trees order the cells differently), so both train on the same batch
    with the same noise.  Leaves, batches,
    IS weights and trees are equal; losses within 1e-5 relative and
    parameters within 1e-6, chip_smoke.py's SAC tolerances (the two batches
    are the same bytes, so only memory layout could part them)."""
    cfgs = {4: port_compose(overrides=SAC_OVERRIDES),
            1: port_compose(overrides=SAC_OVERRIDES + [f"algo.per_rank_batch_size={4 * B}"])}
    n_envs, cap = 4, 64
    rng = np.random.default_rng(5)
    rb = ReplayBuffer(cap, n_envs, obs_keys=("observations",))
    rb.add(_sac_rows(rng, 40, n_envs))
    space = {"state": SimpleNamespace(shape=(OBS,))}
    act_space = SimpleNamespace(shape=(ACT,), low=-np.ones(ACT, np.float32), high=np.ones(ACT, np.float32))
    runs = {}
    for shards in (4, 1):
        rt = MeshRuntime(devices=shards, device="cpu", seed=0).launch()
        cfg = cfgs[shards]
        cache = maybe_create_for_transitions(cfg, rt, rb)
        agent, te = build_agent(rt, cfg, space, act_space)
        runs[shards] = {"rt": rt, "cache": cache, "agent": agent, "state": make_train_state(rt, agent, cfg, te, True)}
    assert type(runs[4]["cache"]) is ShardedDeviceReplayCache and type(runs[1]["cache"]) is DeviceReplayCache
    runs[4]["agent"].load_state_dict(runs[1]["agent"].state_dict())
    pri = rng.integers(1, 6, (cap, n_envs)).astype(np.float32)
    pri[40:] = 0.0  # the host buffer's rows past its head hold no data
    pri = pri.reshape(-1)
    for r in runs.values():
        r["cache"].tree.set_priorities(np.arange(cap * n_envs), pri)
    beta_fn = per_beta_schedule(0.4, 1.0, 1000)
    ema = [True, False, True]
    for d in range(2):
        pending = [_sac_rows(rng, 1, n_envs) for _ in range(G)]
        r01 = torch.rand(G * 4 * B, generator=torch.Generator().manual_seed(d))
        noise = torch.randn((G, 2, 4 * B, ACT), generator=torch.Generator().manual_seed(10 + d))
        seen = {}
        for shards, r in runs.items():
            inner = r["cache"].sample_transitions_per

            def draw(*a, _inner=inner, _shards=shards, **kw):
                if _shards == 1:  # the cells the sharded draw took
                    kw["r01"] = _r01_for(runs[1]["cache"].tree, seen[4][1])
                out = _inner(*a, **kw)
                seen[_shards] = ({k: v.clone() for k, v in out[0].items()}, out[1].clone())
                return out

            r["cache"].sample_transitions_per = draw
            try:
                r["metrics"] = train_dispatch(
                    r["state"], rb, r["cache"], cfgs[shards], ema, 100 + d, beta_fn, copy.deepcopy(pending),
                    draws={"r01": r01} if shards == 4 else None, noise=noise,
                )
            finally:
                del r["cache"].sample_transitions_per
        assert seen[4][1].shape == (G, 4 * B) and torch.equal(seen[4][1], seen[1][1])
        for k in seen[1][0]:
            rtol = W_RTOL if k == "is_weights" else 0
            np.testing.assert_allclose(seen[4][0][k].numpy(), seen[1][0][k].numpy(), rtol=rtol, atol=0, err_msg=k)
        for k, v in runs[1]["metrics"].items():
            np.testing.assert_allclose(float(runs[4]["metrics"][k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
        want = runs[1]["agent"].state_dict()
        for k, v in runs[4]["agent"].state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(runs[4]["cache"].priority_state()["leaves"], runs[1]["cache"].priority_state()["leaves"])
        assert float(runs[4]["cache"].tree.max_priority) == float(runs[1]["cache"].tree.max_priority)
    for r in runs.values():
        assert r["state"].gradient_steps == 2 * G


# ------------------------------------------------------------------ chip_smoke
def test_chip_smoke_sharded_config_matches_the_composed_one():
    """chip_smoke.py's sharded SAC dict is what the port composes for
    ``exp=sac_dmc_walker_walk fabric.devices=4`` and the slice's buffer
    overrides, on every key it holds."""
    from chip_smoke import SAC_WALKER_SHARDED

    cfg = port_compose(overrides=[
        "exp=sac_dmc_walker_walk", "fabric.devices=4", "buffer.prioritized=True", "buffer.per_kernel=pallas",
        "buffer.device_cache=True", "buffer.memmap=False", "fabric.precision=32-true",
    ])

    def leaves(node, prefix=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, node

    for path, value in leaves(SAC_WALKER_SHARDED):
        node = cfg
        for k in path:
            node = node[k]
        assert node == value, path
    # JAX's main runs num_envs envs a shard over buffer.size // total_envs rows:
    # each shard's sub-tree is the one the kernel checks time
    from chip_smoke import SHARD_LEAVES

    envs = SAC_WALKER_SHARDED["env"]["num_envs"]
    assert SAC_WALKER_SHARDED["buffer"]["size"] // (envs * SAC_WALKER_SHARDED["fabric"]["devices"]) * envs == SHARD_LEAVES


def test_chip_smoke_sharded_phase_runs_on_cpu():
    """chip_smoke.py's ``sac_sharded`` phase at a small ring on the CPU: the
    fill through the sharded cache, the check against a single-device tree,
    the uniform transition and window draws, both runs of
    ``train_dispatch``, the prioritized window draw."""
    import chip_smoke

    cfg = copy.deepcopy(chip_smoke.SAC_WALKER_SHARDED)
    cfg["algo"].update(per_rank_batch_size=8, dispatch_batch=4)
    for k in ("actor", "critic"):
        cfg["algo"][k]["hidden_size"] = 16
    res = chip_smoke.run_sac_sharded(dotdict(cfg), "cpu", dispatches=2, capacity=300, profile=False)
    assert res["shards"] == 4 and len(res["losses_kernels"]) == 2 and res["leaves_identical"]
    assert res["envs"] == 16 and res["batch"] == 4 * 8  # JAX's total_envs and batch_unit
    assert res["max_abs_param_diff"] == 0.0 and res["max_rel_tree_diff"] == 0.0  # both runs are plain on the CPU
    assert all(v == 0 for v in res["launches"].values())  # CPU tensors never reach a kernel
    assert res["state_check"]["leaves_equal"] and res["state_check"]["max_std_errors"] < chip_smoke.SHARE_SIGMAS
    assert res["window_draw"]["starts_identical"] and res["window_draw"]["exclusions_per_shard"] == 63 * 4

"""The port's prioritized device cache against the JAX package's, for
``per_kernel`` lax and pallas on both sides (the Pallas kernels in interpret
mode on the JAX side, the kernels' plain versions on the port's CPU side).

Mirrors ``tests/test_data/test_replay_prioritized.py``: the same adds go into
both caches, and every draw takes the uniforms JAX draws from its key
(``uniform(key, (n,))`` for a prioritized draw, ``randint``/``uniform`` of
``split(key)`` for a uniform one).  Priorities stay integer-valued (seeded at
1, TD feedback with alpha = 1 and eps = 0 on integer |delta|), so every sum
is exact: rings, batches, leaves and trees (slots ``1..``) are compared
bit for bit, the IS weights to 1e-6 relative (``pow`` in two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data import buffers as jax_buffers
from sheeprl_tpu.ops.pallas_gather import gather_transitions_fused
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.data import buffers as port_buffers
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayCache, maybe_create_for_transitions
from sheeprl_tpu_torch.ops.gather import gather_transitions, gather_transitions_plain
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime

from test_torch_replay import JaxCache

KERNELS = ("lax", "pallas")
W_RTOL = 1e-6
CAP, N_ENVS = 16, 2


def _rows(rng, t_len, n_envs, t0=0):
    """SAC-shaped keys: f32 observations (the row index in the first
    feature, so that a draw can be read back), f32 actions and rewards,
    uint8 flags."""
    obs = rng.normal(size=(t_len, n_envs, 3)).astype(np.float32)
    obs[..., 0] = np.arange(t0, t0 + t_len, dtype=np.float32)[:, None]
    return {
        "observations": obs,
        "next_observations": obs + 1,
        "actions": rng.uniform(-1, 1, size=(t_len, n_envs, 2)).astype(np.float32),
        "rewards": rng.normal(size=(t_len, n_envs, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(t_len, n_envs, 1)) < 0.1).astype(np.uint8),
    }


def _pair(kernel, adds, cap=CAP, n_envs=N_ENVS, **kw):
    kw = {"per_alpha": 1.0, "per_eps": 0.0, **kw}
    j = JaxCache(cap, n_envs, prioritized=True, kernel=kernel, **kw)
    p = DeviceReplayCache(cap, n_envs, device="cpu", prioritized=True, kernel=kernel, **kw)
    rng = np.random.default_rng(0)
    t = 0
    for t_len, idx in adds:
        data = _rows(rng, t_len, n_envs if idx is None else len(idx), t)
        t += t_len
        j.add(data, idx)
        p.add(data, idx)
    return j, p


def _assert_trees(j, p):
    np.testing.assert_array_equal(p.tree.tree.numpy()[1:], np.asarray(j._tree.tree)[1:])
    assert float(p.tree.max_priority) == float(j._tree.max_priority)


def _assert_batch(out, ref, skip=()):
    assert set(out) == set(ref)
    for k in ref:
        if k in skip:
            continue
        assert out[k].dtype == torch.from_numpy(np.asarray(ref[k])).dtype, k
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


def _r01(key, n):
    return torch.from_numpy(np.asarray(jax.random.uniform(key, (n,))))


# single rows, windows longer than one row, routed env columns, wrap-around
ADDS = [(1, None), (5, None), (1, [1]), (3, [0]), (12, None), (1, None)]
# every env in lockstep, as SAC adds (the ring wraps): obs[..., 0] is a row's time
LOCKSTEP = [(1, None), (5, None), (3, None), (12, None), (1, None)]


@pytest.mark.parametrize("kernel", KERNELS)
def test_seeded_cells_match_after_adds(kernel):
    j, p = _pair(kernel, ADDS[:3])
    _assert_trees(j, p)
    assert p.tree.total == 13.0  # 6 rows x 2 envs + 1 routed row
    j2, p2 = _pair(kernel, ADDS)
    _assert_trees(j2, p2)
    assert p2.tree.total == CAP * N_ENVS  # the ring wrapped: overwrites reseed, never double-count
    for k, ring in p2.buffers.items():
        np.testing.assert_array_equal(ring.numpy(), np.asarray(j2._bufs[k]), err_msg=k)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("next_obs", [False, True])
def test_sample_transitions_per_with_jax_draws(kernel, next_obs):
    j, p = _pair(kernel, LOCKSTEP)
    # unequal integer priorities, so that the draw is not uniform
    idx = np.arange(CAP * N_ENVS)
    td = (idx % 5).astype(np.float32)
    j.update_priorities(idx, td)
    p.update_priorities(idx, td)
    _assert_trees(j, p)
    obs_keys = ("observations",)
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        ref, ref_idx = j.sample_transitions_per(3, 4, key, beta=0.4, sample_next_obs=next_obs, obs_keys=obs_keys)
        out, leaves = p.sample_transitions_per(
            3, 4, beta=0.4, sample_next_obs=next_obs, obs_keys=obs_keys, r01=_r01(key, 12)
        )
        assert leaves.shape == (3, 4) and out["is_weights"].shape == (3, 4, 1)
        np.testing.assert_array_equal(leaves.numpy(), np.asarray(ref_idx))
        _assert_batch(out, ref, skip=("is_weights",))
        np.testing.assert_allclose(out["is_weights"].numpy(), np.asarray(ref["is_weights"]), rtol=W_RTOL)
        if next_obs:
            head = (p._pos[0] - 1) % CAP  # the newest row's successor is stale
            assert not (leaves.numpy() // N_ENVS == head).any()
            assert float(p.tree.priorities(int(head * N_ENVS))) == td[head * N_ENVS]  # the exclusion did not write


@pytest.mark.parametrize("kernel", KERNELS)
def test_update_priorities_matches_and_shifts_the_draw(kernel):
    j, p = _pair(kernel, ADDS)
    key = jax.random.PRNGKey(1)
    _, ref_idx = j.sample_transitions_per(2, 8, key, beta=1.0)
    _, leaves = p.sample_transitions_per(2, 8, beta=1.0, r01=_r01(key, 16))
    td = np.arange(16, dtype=np.float32).reshape(2, 8) % 7 + 1  # duplicates of a leaf may differ
    j.update_priorities(np.asarray(ref_idx), td)
    p.update_priorities(leaves, torch.from_numpy(td))
    _assert_trees(j, p)
    # crush everything but leaf 5: nearly every draw lands there
    p.update_priorities(np.arange(CAP * N_ENVS), np.zeros(CAP * N_ENVS, np.float32))
    p.update_priorities(np.array([5]), np.array([100.0], np.float32))
    _, leaves = p.sample_transitions_per(1, 64, torch.Generator().manual_seed(0), beta=1.0)
    assert (leaves == 5).all()


@pytest.mark.parametrize("kernel", KERNELS)
def test_sample_per_with_exclusions_and_decay(kernel):
    """Sequence starts drawn proportional to priority, the L - 1 rows before
    each write head excluded, the drawn starts decayed after each draw."""
    j, p = _pair(kernel, LOCKSTEP, per_decay=0.5)
    seq_len = 4
    for i in range(3):
        key = jax.random.PRNGKey(40 + i)
        ref = j.sample_per(2, 6, seq_len, key, beta=0.0)
        out = p.sample_per(2, 6, seq_len, beta=0.0, r01=_r01(key, 12))
        assert len(out) == len(ref) == 2
        for a, b in zip(out, ref):
            assert a["observations"].shape == (seq_len, 6, 3)
            _assert_batch(a, b)
            rows = a["observations"].numpy()[..., 0].astype(int) % CAP  # (L, B)
            steps = (rows[1:] - rows[:-1]) % CAP
            assert (steps == 1).all()  # contiguous windows
            for s in rows[0]:
                dist = (p._pos[0] - s) % CAP
                assert dist == 0 or dist >= seq_len  # never crossing the write head
        _assert_trees(j, p)  # the decay wrote the same priorities


@pytest.mark.parametrize("kernel", KERNELS)
def test_uniform_sample_transitions_with_jax_draws(kernel):
    j = JaxCache(CAP, N_ENVS, kernel=kernel)
    p = DeviceReplayCache(CAP, N_ENVS, device="cpu", kernel=kernel)
    rng = np.random.default_rng(3)
    for t_len in (5, 1, 14):
        data = _rows(rng, t_len, N_ENVS)
        j.add(data)
        p.add(data)
    assert p.tree is None
    for next_obs in (False, True):
        key = jax.random.PRNGKey(7)
        ref = j.sample_transitions(2, 5, key, sample_next_obs=next_obs, obs_keys=("observations",))
        k_env, k_row = jax.random.split(key)
        envs = torch.from_numpy(np.asarray(jax.random.randint(k_env, (10,), 0, N_ENVS)).astype(np.int32))
        u = torch.from_numpy(np.asarray(jax.random.uniform(k_row, (10,))))
        out = p.sample_transitions(2, 5, sample_next_obs=next_obs, obs_keys=("observations",), envs=envs, u=u)
        _assert_batch(out, ref)
    p.update_priorities(np.array([0]), np.array([1.0]))  # a no-op without a tree
    with pytest.raises(RuntimeError, match="prioritized"):
        p.sample_transitions_per(1, 2, beta=0.4)
    with pytest.raises(RuntimeError, match="prioritized"):
        p.sample_per(1, 2, 2, beta=0.4)


def _host_pair(steps=11):
    rng = np.random.default_rng(5)
    hj = jax_buffers.ReplayBuffer(8, 2, obs_keys=("observations",))
    hp = port_buffers.ReplayBuffer(8, 2, obs_keys=("observations",))
    for t in range(steps):
        data = _rows(rng, 1, 2, t)
        hj.add(data)
        hp.add(data)
    return hj, hp


@pytest.mark.parametrize("kernel", KERNELS)
def test_load_from_replay_and_priority_state(kernel):
    hj, hp = _host_pair()
    j = JaxCache(8, 2, prioritized=True, per_alpha=1.0, per_eps=0.0, kernel=kernel)
    p = DeviceReplayCache(8, 2, device="cpu", prioritized=True, per_alpha=1.0, per_eps=0.0, kernel=kernel)
    j.load_from_replay(hj)
    p.load_from_replay(hp)
    _assert_trees(j, p)
    assert p.tree.total == 16.0
    for k, ring in p.buffers.items():
        np.testing.assert_array_equal(ring.numpy(), np.asarray(j._bufs[k]), err_msg=k)
    np.testing.assert_array_equal(p._pos, j._pos)
    np.testing.assert_array_equal(p._filled, j._filled)
    p.update_priorities(np.array([0, 1]), np.array([9.0, 9.0], np.float32))
    state = p.priority_state()
    # the saved state restores into either package
    for cache in (
        DeviceReplayCache(8, 2, device="cpu", prioritized=True, kernel=kernel),
        JaxCache(8, 2, prioritized=True, kernel=kernel),
    ):
        cache.load_from_replay(hp if isinstance(cache, DeviceReplayCache) else hj)
        cache.load_priority_state(state)
        tree = cache.tree.tree.numpy() if isinstance(cache, DeviceReplayCache) else np.asarray(cache._tree.tree)
        np.testing.assert_array_equal(tree[1:], p.tree.tree.numpy()[1:])
    # no saved state: every stored cell back at 1
    p.load_priority_state(None)
    assert p.tree.total == 16.0


def test_maybe_create_for_transitions_follows_the_config():
    rt = MeshRuntime(device="cpu")
    _, hp = _host_pair(5)

    def cfg(**buffer):
        return dotdict({"buffer": {"device_cache": "auto", "per_kernel": "pallas", "prioritized": False, **buffer}})

    assert maybe_create_for_transitions(cfg(), rt, hp) is None  # auto stays on the host on a CPU run
    cache = maybe_create_for_transitions(cfg(prioritized=True, per_alpha=1.0, per_eps=0.0), rt, hp)
    assert cache.prioritized and cache.kernel == "pallas" and cache.tree.total == 10.0
    assert cache.tree.kernel == "pallas"
    cache.kernel = "lax"  # one setter picks the gathers and the tree's functions
    assert cache.tree.kernel == "lax"
    with pytest.raises(ValueError, match="per_kernel"):
        cache.kernel = "triton"
    state = {"replay_priority": {**cache.priority_state(), "leaves": np.arange(16, dtype=np.float32)}}
    restored = maybe_create_for_transitions(cfg(prioritized=True), rt, hp, state)
    assert restored.tree.total == float(np.arange(16).sum())
    with pytest.raises(ValueError, match="prioritized"):
        maybe_create_for_transitions(cfg(prioritized=True, device_cache=False), rt, hp)
    assert maybe_create_for_transitions(cfg(device_cache=True), rt, port_buffers.SequentialReplayBuffer(4)) is None


@pytest.mark.parametrize("next_keys", [(), ("a",), ("a", "c")])
def test_plain_transition_gather_matches_pallas(next_keys):
    rng = np.random.default_rng(0)
    cap, n_envs = 16, 3
    bufs = {
        "a": rng.standard_normal((cap, n_envs, 4)).astype(np.float32),
        "b": rng.integers(0, 99, (cap, n_envs, 1)).astype(np.uint8),
        "c": rng.standard_normal((cap, n_envs, 24)).astype(np.float32),
    }
    rows = np.array([15, 2, 15, 0, 7], np.int32)  # 15 wraps for the successor
    envs = np.array([0, 2, 1, 1, 0], np.int32)
    ref = gather_transitions_fused(
        {k: jnp.asarray(v) for k, v in bufs.items()}, jnp.asarray(rows), jnp.asarray(envs), next_keys=next_keys, interpret=True
    )
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    before = gather_transitions.launches
    for fn in (gather_transitions_plain, gather_transitions):
        out = fn(tb, torch.from_numpy(rows), torch.from_numpy(envs), next_keys=next_keys)
        _assert_batch(out, ref)
    assert gather_transitions.launches == before  # CPU tensors never reach the kernel

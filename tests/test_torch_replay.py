"""The port's replay (host buffers, device cache, window gather) against the
JAX package's.

- Host buffers: the same adds and the same numpy seed draw the same rows
  in both packages, so samples are equal array for array.
- Device cache: the rings after ``add`` (single rows, windows, routed env
  columns, windows longer than the ring) and after ``load_from`` are
  byte-equal to the JAX cache's.
- Sampling: JAX's ``_sample`` draws ``envs`` and ``u`` from its key; the
  same draws injected into the port's ``sample`` give byte-equal batches,
  for ``per_kernel`` pallas (the Pallas kernel in interpret mode on the
  JAX side) and lax.
- The plain window gather against ``gather_windows_fused`` (interpret),
  windows that wrap the ring included.

Everything here is bytes: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data import buffers as jax_buffers
from sheeprl_tpu.data.device_buffer import DeviceReplayCache as _JaxCache
from sheeprl_tpu.ops.pallas_gather import gather_windows_fused
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.data import buffers as port_buffers
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayCache, maybe_create_for, sequence_batches
from sheeprl_tpu_torch.ops.gather import gather_windows, gather_windows_plain, window_cells
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime

CAP, N_ENVS = 40, 3


class JaxCache(_JaxCache):
    """The JAX package's cache with its write heads and fill counts held as
    int64.  The JAX cache hands its int32 ``_pos`` to the asynchronous
    append jit as a zero-copy array and then advances ``_pos`` in place:
    under load the append can read the advanced heads and write the wrong
    rows (a few fills in a hundred; ROADMAP C).  An int64 array cannot be
    aliased by the int32 argument, so each dispatch gets its own copy."""

    @property
    def _pos(self):
        return self._pos64

    @_pos.setter
    def _pos(self, value):
        self._pos64 = np.asarray(value, np.int64)

    @property
    def _filled(self):
        return self._filled64

    @_filled.setter
    def _filled(self, value):
        self._filled64 = np.asarray(value, np.int64)


def _rows(rng, t_len, n_envs):
    """Crafter-like keys: uint8 frames, f32 one-hot actions and scalars,
    f64 rewards as ``main`` writes them."""
    return {
        "rgb": rng.integers(0, 256, size=(t_len, n_envs, 4, 4, 3)).astype(np.uint8),
        "actions": np.eye(5, dtype=np.float32)[rng.integers(0, 5, (t_len, n_envs))],
        "rewards": rng.normal(size=(t_len, n_envs, 1)),
        "is_first": (rng.uniform(size=(t_len, n_envs, 1)) < 0.1).astype(np.float32),
    }


def _fill_pair(cls_j, cls_p, adds, seed=0, **kw):
    rng = np.random.default_rng(seed)
    j = jax_buffers.EnvIndependentReplayBuffer(CAP, n_envs=N_ENVS, buffer_cls=cls_j, **kw)
    p = port_buffers.EnvIndependentReplayBuffer(CAP, n_envs=N_ENVS, buffer_cls=cls_p, **kw)
    for t_len, idx in adds:
        data = _rows(rng, t_len, N_ENVS if idx is None else len(idx))
        j.add(data, idx)
        p.add(data, idx)
    j.seed(seed)
    p.seed(seed)
    return j, p


# wraps every ring more than once; the device cache also takes a window
# longer than the ring (the host buffer does not: see ReplayBuffer.add)
ADDS = [(7, None), (1, [2]), (30, None), (1, [0, 2]), (12, [1]), (38, None), (3, None)]
CACHE_ADDS = ADDS[:5] + [(45, None), (1, [1]), (3, None)]


@pytest.mark.parametrize("n_samples", [1, 3])
def test_sequential_host_buffers_draw_the_same_rows(n_samples):
    j, p = _fill_pair(jax_buffers.SequentialReplayBuffer, port_buffers.SequentialReplayBuffer, ADDS)
    for _ in range(3):
        a = j.sample(8, sequence_length=6, n_samples=n_samples)
        b = p.sample(8, sequence_length=6, n_samples=n_samples)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("next_obs", [False, True])
def test_flat_host_buffers_draw_the_same_rows(next_obs):
    j, p = _fill_pair(jax_buffers.ReplayBuffer, port_buffers.ReplayBuffer, ADDS[:3], obs_keys=("rgb",))
    a = j.sample(9, sample_next_obs=next_obs, n_samples=2)
    b = p.sample(9, sample_next_obs=next_obs, n_samples=2)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_memmap_and_prioritized_replay_raise_until_ported():
    """Memory-mapped host replay still raises; prioritized device replay is
    ported (``tests/test_torch_replay_prioritized.py``) and builds its tree
    with the rings."""
    with pytest.raises(NotImplementedError, match="memory-mapped"):
        port_buffers.ReplayBuffer(4, memmap=True)
    cache = DeviceReplayCache(4, 1, device="cpu", prioritized=True)
    assert cache.prioritized and cache.tree is None
    cache.add({"x": np.zeros((2, 1, 3), np.float32)})
    assert cache.tree.total == 2.0


def _cache_pair(kernel, adds, seed=1):
    rng = np.random.default_rng(seed)
    j = JaxCache(CAP, N_ENVS, kernel=kernel)
    p = DeviceReplayCache(CAP, N_ENVS, device="cpu", kernel=kernel)
    for t_len, idx in adds:
        data = _rows(rng, t_len, N_ENVS if idx is None else len(idx))
        j.add(data, idx)
        p.add(data, idx)
    return j, p


def _assert_rings_equal(j, p):
    assert set(j._bufs) == set(p.buffers)
    for k, ring in p.buffers.items():
        ref = np.array(j._bufs[k])
        assert ring.dtype == torch.from_numpy(ref).dtype and np.array_equal(ring.numpy(), ref), k
    assert np.array_equal(j._pos, p._pos) and np.array_equal(j._filled, p._filled)


def test_device_cache_rings_match_after_add():
    j, p = _cache_pair("lax", CACHE_ADDS)
    _assert_rings_equal(j, p)


def test_device_cache_rings_match_after_load_from():
    _, host = _fill_pair(jax_buffers.SequentialReplayBuffer, port_buffers.SequentialReplayBuffer, ADDS, seed=2)
    jhost, _ = _fill_pair(jax_buffers.SequentialReplayBuffer, port_buffers.SequentialReplayBuffer, ADDS, seed=2)
    j = JaxCache(CAP, N_ENVS)
    p = DeviceReplayCache(CAP, N_ENVS, device="cpu")
    j.load_from(jhost)
    p.load_from(host)
    _assert_rings_equal(j, p)
    # the rings hold exactly what the host buffer holds
    for k, ring in p.buffers.items():
        ref = np.concatenate([b.buffer[k] for b in host.buffer], axis=1)
        assert np.array_equal(ring.numpy(), ref.astype(ring.numpy().dtype)), k


@pytest.mark.parametrize("kernel", ["pallas", "lax"])
@pytest.mark.parametrize("n_samples,batch,seq_len", [(1, 4, 6), (3, 5, 9)])
def test_sample_with_jax_draws_is_byte_equal(kernel, n_samples, batch, seq_len):
    """JAX's ``_sample`` draws ``envs = randint(k_env)`` and
    ``u = uniform(k_start)`` from ``split(key)``; those draws, injected,
    make the port's sample byte-equal (the ring has wrapped, so windows
    wrap too)."""
    j, p = _cache_pair(kernel, CACHE_ADDS)
    flat = n_samples * batch
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        ref = j.sample(n_samples, batch, seq_len, key)
        k_env, k_start = jax.random.split(key)
        envs = torch.from_numpy(np.asarray(jax.random.randint(k_env, (flat,), 0, N_ENVS)).astype(np.int32))
        u = torch.from_numpy(np.asarray(jax.random.uniform(k_start, (flat,))))
        out = p.sample(n_samples, batch, seq_len, envs=envs, u=u)
        assert len(out) == len(ref) == n_samples
        for a, b in zip(out, ref):
            for k in b:
                assert a[k].shape == (seq_len, batch, *p.buffers[k].shape[2:])
                assert np.array_equal(a[k].numpy(), np.asarray(b[k])), (k, i)


@pytest.mark.parametrize("starts", [[0, 5, 17], [CAP - 1, CAP - 4, 3]])
def test_plain_gather_matches_pallas_windows(starts):
    rng = np.random.default_rng(3)
    bufs = {k: v for k, v in _rows(rng, CAP, N_ENVS).items()}
    bufs["rewards"] = bufs["rewards"].astype(np.float32)
    seq_len, batch = 7, 3
    st = np.asarray(starts, np.int32)
    envs = np.asarray([2, 0, 1], np.int32)
    ref = gather_windows_fused({k: jnp.asarray(v) for k, v in bufs.items()}, jnp.asarray(st), jnp.asarray(envs), seq_len=seq_len, interpret=True)
    tb = {k: torch.from_numpy(v) for k, v in bufs.items()}
    out = gather_windows_plain(tb, torch.from_numpy(st), torch.from_numpy(envs), seq_len=seq_len, batch_size=batch)
    wrapper = gather_windows(tb, torch.from_numpy(st), torch.from_numpy(envs), seq_len=seq_len, batch_size=batch)
    cells = window_cells(torch.from_numpy(st), torch.from_numpy(envs), seq_len=seq_len, batch_size=batch, cap=CAP, n_envs=N_ENVS)
    for k in bufs:
        want = np.swapaxes(np.asarray(ref[k]).reshape(1, batch, seq_len, *bufs[k].shape[2:]), 1, 2)
        assert np.array_equal(out[k].numpy(), want) and np.array_equal(wrapper[k].numpy(), want), k
        flat = tb[k].reshape(CAP * N_ENVS, -1).index_select(0, cells).reshape(want.shape)
        assert np.array_equal(flat.numpy(), want), k
    assert gather_windows.launches == 0  # CPU tensors never reach the kernel


def test_sequence_batches_host_and_cache_paths():
    """Without a cache the feed samples the host buffer and yields each
    gradient step's batch as tensors (uint8 frames kept, the rest f32);
    with one it yields the cache's draw."""
    _, host = _fill_pair(jax_buffers.SequentialReplayBuffer, port_buffers.SequentialReplayBuffer, ADDS, seed=4)
    ref_host = _fill_pair(jax_buffers.SequentialReplayBuffer, port_buffers.SequentialReplayBuffer, ADDS, seed=4)[1]
    want = ref_host.sample(4, sequence_length=5, n_samples=3)
    with sequence_batches(host, None, "cpu", 3, 4, 5) as feed:
        got = list(feed)
    assert len(got) == 3
    for i, batch in enumerate(got):
        assert batch["rgb"].dtype == torch.uint8 and batch["rewards"].dtype == torch.float32
        for k in want:
            assert np.array_equal(batch[k].numpy(), want[k][i].astype(batch[k].numpy().dtype)), k
    cache = DeviceReplayCache(CAP, N_ENVS, device="cpu")
    cache.load_from(host)
    with sequence_batches(host, cache, "cpu", 2, 4, 5, torch.Generator().manual_seed(0)) as feed:
        drawn = list(feed)
    assert len(drawn) == 2 and drawn[0]["rgb"].shape == (5, 4, 4, 4, 3)


def test_maybe_create_for_follows_the_config():
    rt = MeshRuntime(device="cpu")
    rb = port_buffers.EnvIndependentReplayBuffer(CAP, n_envs=2, buffer_cls=port_buffers.SequentialReplayBuffer)

    def cfg(**buffer):
        return dotdict(
            {"buffer": {"device_cache": "auto", "per_kernel": "lax", "prioritized": False, "per_decay_on_sample": 0.5, **buffer}}
        )

    assert maybe_create_for(cfg(), rt, rb) is None  # auto stays on the host on a CPU run
    assert maybe_create_for(cfg(device_cache=False), rt, rb) is None
    cache = maybe_create_for(cfg(device_cache=True, per_kernel="pallas"), rt, rb)
    assert cache is not None and cache.kernel == "pallas" and cache.capacity == CAP and cache.n_envs == 2
    assert maybe_create_for(cfg(device_cache=True), rt, port_buffers.ReplayBuffer(4)) is None
    per = maybe_create_for(cfg(prioritized=True), rt, rb)  # PER keeps the cache on, even on a CPU run
    assert per is not None and per.prioritized and per.per_decay == 0.5
    with pytest.raises(ValueError, match="prioritized"):
        maybe_create_for(cfg(device_cache=False, prioritized=True), rt, rb)


def test_large_ring_stays_on_the_card_where_jax_keeps_it_on_the_host():
    """``_admit`` keeps only the budget gate: a 1M-row DV3 rgb ring (12.3 GB,
    over 2^31 bytes) is admitted with no budget set, where JAX's int32
    gather gate sends it to the host; a budget below it still refuses.
    ``_admit`` only estimates, so nothing large is allocated."""
    row = {"rgb": np.zeros((1, 1, 64, 64, 3), np.uint8), "actions": np.zeros((1, 1, 9), np.float32)}
    cache = DeviceReplayCache(1_000_000, 1, device="cpu")
    assert cache.estimate_bytes(row) > 2**31
    assert cache._admit(row) and cache.active and cache.buffers is None
    jax_cache = JaxCache(1_000_000, 1)
    assert not jax_cache._admit(row) and not jax_cache.active
    small = DeviceReplayCache(1_000_000, 1, device="cpu", budget_bytes=2**31)
    assert not small._admit(row) and not small.active

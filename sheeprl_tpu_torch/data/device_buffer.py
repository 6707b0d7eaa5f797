"""Device-resident replay window with on-device sampling.

Counterpart of the single-device half of ``sheeprl_tpu/data/device_buffer.py``:
:class:`DeviceReplayCache` mirrors a host replay buffer in rings
``(capacity, n_envs, *feat)`` on the card.  Each policy step appends only
its new rows; a draw is one gather on the card instead of a host sample and
a copy of every batch.  Two families share the rings:

- sequences (Dreamer), mirroring an ``EnvIndependentReplayBuffer`` over
  ``SequentialReplayBuffer``s: one ring per env with its own write head, the
  env drawn uniformly per batch row, the window start uniform over the
  ``filled - L + 1`` starts that never cross the write head
  (:meth:`~DeviceReplayCache.sample`);
- flat transitions (SAC), mirroring a ``ReplayBuffer`` whose envs all add in
  lockstep: rows uniform over the stored history, the env uniform per row,
  ``next_<k>`` from the successor row, the write-head row left out when next
  observations are gathered (:meth:`~DeviceReplayCache.sample_transitions`).

``prioritized=True`` (``buffer.prioritized``) keeps a sum-tree over the
cells (``replay/priority_tree.py``, leaf = row * n_envs + env) beside the
rings: new cells enter at the running max priority, transition draws are
proportional with IS weights (:meth:`~DeviceReplayCache.sample_transitions_per`)
and take TD-error feedback (:meth:`~DeviceReplayCache.update_priorities`),
sequence starts are drawn proportional to their cell's priority and
optionally decayed after each draw (:meth:`~DeviceReplayCache.sample_per`).

``buffer.per_kernel`` keeps its JAX meaning: ``pallas`` runs the sum-tree
and every gather through the hand-written kernels (``ops/per.py``,
``ops/gather.py``: one launch per draw), ``lax`` through the plain tree
functions and per-key advanced indexing.  Both give the same bytes.

On a mesh of N shards (``MeshRuntime(devices=N)``, ``fabric.devices=N``)
:class:`ShardedDeviceReplayCache` takes over: shard ``r`` owns the env
columns ``[r * n_envs / N, (r + 1) * n_envs / N)`` of the rings and a
sub-tree of the env-sharded sum-tree over their cells
(``replay/priority_tree.py:ShardedPriorityTree``).  Uniform draws are
stratified (each shard draws its share of the batch from its own envs);
prioritized draws are globally proportional, each shard gathering the draws
it owns, the batch assembled by a masked sum over the shards.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.ops.gather import gather_transitions, gather_transitions_plain, gather_windows, gather_windows_plain
from sheeprl_tpu_torch.parallel.sharding import psum
from sheeprl_tpu_torch.replay.priority_tree import (
    PriorityTree,
    ShardedPriorityTree,
    _tree_zeroed_local,
    resolve_per_kernel,
    shard_proportional_draw,
)
from sheeprl_tpu_torch.utils.utils import resolve_device

__all__ = [
    "DeviceReplayCache",
    "ShardedDeviceReplayCache",
    "device_cache_setting",
    "head_exclusions",
    "maybe_create_for",
    "maybe_create_for_transitions",
    "sample_transition_rows",
    "sample_window_starts",
    "sequence_batches",
    "upload",
    "window_exclusions",
]


def _store_dtype(dt) -> np.dtype:
    dt = np.dtype(dt)
    return np.dtype(np.float32) if dt == np.float64 else dt


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without synchronising the stream: on a card
    it is staged in pinned memory and copied asynchronously (PyTorch's caching
    host allocator keeps the pinned block until the copy has run); a blocking
    copy from pageable memory would wait for every queued kernel."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def window_exclusions(pos: np.ndarray, capacity: int, seq_len: int) -> Optional[np.ndarray]:
    """The cells that cannot start a window of ``seq_len``: the L - 1 rows
    before each env's write head, offset-major ((L - 1) x n_envs), as int32
    leaves ``row * n_envs + env`` of a tree over ``len(pos)`` envs."""
    if seq_len <= 1:
        return None
    n_envs = len(pos)
    inv_rows = (pos[None, :] - np.arange(1, seq_len)[:, None]) % capacity  # (L-1, n_envs)
    return (inv_rows * n_envs + np.arange(n_envs)[None, :]).reshape(-1).astype(np.int32)


def head_exclusions(pos: np.ndarray, capacity: int) -> np.ndarray:
    """Each env's newest row (its successor is stale), as int32 leaves."""
    return (((pos - 1) % capacity) * len(pos) + np.arange(len(pos))).astype(np.int32)


def device_cache_setting(cfg) -> str:
    """``buffer.device_cache`` with its ``SHEEPRL_DEVICE_CACHE`` override, as
    one of "on" / "off" / "auto"."""
    val = cfg.buffer.get("device_cache", "auto")
    env = os.environ.get("SHEEPRL_DEVICE_CACHE")
    if env is not None:
        val = env
    s = str(val).lower()
    if s in ("1", "true", "on", "yes"):
        return "on"
    if s in ("0", "false", "off", "no"):
        return "off"
    return "auto"


def sample_window_starts(
    pos: torch.Tensor,
    filled: torch.Tensor,
    envs: torch.Tensor,
    u: torch.Tensor,
    *,
    seq_len: int,
    cap: int,
) -> torch.Tensor:
    """(flat,) int32 ring starts from drawn ``envs`` and ``u`` in [0, 1),
    in ``_gather_windows``' arithmetic (``device_buffer.py:255-262``)."""
    counts = filled - seq_len + 1  # (n_envs,), >= 1 when can_sample
    base = torch.where(filled >= cap, pos, torch.zeros_like(pos))
    c_e = counts[envs.long()]
    offs = torch.minimum((u.float() * c_e.float()).to(torch.int32), c_e - 1)
    return ((base[envs.long()] + offs) % cap).to(torch.int32)


def sample_transition_rows(u: torch.Tensor, *, base: int, count: int, cap: int) -> torch.Tensor:
    """(flat,) int32 ring rows from ``u`` in [0, 1): uniform over the
    ``count`` sampleable rows from the oldest (``base``), in
    ``_sample_transitions``' arithmetic (``device_buffer.py:189-191``)."""
    offs = torch.clamp_max((u.float() * count).to(torch.int32), count - 1)
    return ((base + offs) % cap).to(torch.int32)


def maybe_create_for(cfg, runtime, rb, state=None) -> Optional["DeviceReplayCache"]:
    """A cache mirroring ``rb`` when it is an ``EnvIndependentReplayBuffer``
    and the config allows one, filled from ``rb`` (empty when ``rb`` is).
    ``state`` is the restored checkpoint's, when ``rb`` was restored: a
    prioritized cache then reloads its priorities from it."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer

    if not isinstance(rb, EnvIndependentReplayBuffer):
        return None
    cache = DeviceReplayCache.maybe_create(cfg, runtime, capacity=rb.buffer_size, n_envs=rb.n_envs)
    if cache is None:
        cache = _maybe_create_sharded(cfg, runtime, rb.buffer_size, rb.n_envs)
    if cache is not None:
        cache.load_from(rb)
        if state is not None and cache.prioritized:
            cache.load_priority_state(state.get("replay_priority"))
    return cache


def maybe_create_for_transitions(cfg, runtime, rb, state=None) -> Optional["DeviceReplayCache"]:
    """SAC-family factory: a cache mirroring a plain ``ReplayBuffer`` when the
    config allows one, filled from ``rb``; ``state`` as for
    :func:`maybe_create_for`."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    if type(rb) is not ReplayBuffer:
        return None
    cache = DeviceReplayCache.maybe_create(cfg, runtime, capacity=rb.buffer_size, n_envs=rb.n_envs)
    if cache is None:
        # a mesh of several shards: the env-sharded cache keeps the rings and
        # the per-shard sum-trees
        cache = _maybe_create_sharded(cfg, runtime, rb.buffer_size, rb.n_envs)
    if cache is not None:
        cache.load_from_replay(rb)
        if state is not None and cache.prioritized:
            cache.load_priority_state(state.get("replay_priority"))
    return cache


def _maybe_create_sharded(cfg, runtime, capacity: int, n_envs: int) -> Optional["ShardedDeviceReplayCache"]:
    """The gating of ``device_buffer.py:409-458`` for both buffer families:
    on a mesh of several shards, the env-sharded cache when
    ``buffer.device_cache`` is on or ``buffer.prioritized`` needs it.  A
    prioritized run that cannot build it raises (there is no host sampler
    to fall back to); otherwise the run keeps the host feed."""
    mode = device_cache_setting(cfg)
    prioritized = bool(cfg.buffer.get("prioritized", False))
    if runtime.device_count <= 1:
        return None
    if mode == "off" or not (mode == "on" or prioritized):
        return None
    if n_envs % runtime.device_count:
        blocker = f"n_envs ({n_envs}) not divisible by {runtime.device_count} devices"
        if prioritized:
            raise ValueError(
                "buffer.prioritized=True needs the env-sharded device cache on a "
                "multi-device mesh, which this run cannot build: " + blocker
            )
        print("DeviceReplayCache: buffer.device_cache=True ignored — " + blocker + "; keeping the host feed path")
        return None
    cache = ShardedDeviceReplayCache(
        capacity,
        n_envs,
        runtime,
        prioritized=prioritized,
        per_alpha=float(cfg.buffer.get("per_alpha", 0.6)),
        per_eps=float(cfg.buffer.get("per_eps", 1e-6)),
        per_decay=cfg.buffer.get("per_decay_on_sample", None),
        kernel=str(cfg.buffer.get("per_kernel", "lax")),
    )
    print(
        f"DeviceReplayCache: env-sharded replay window enabled "
        f"(capacity {capacity} x {n_envs} envs over "
        f"{runtime.device_count} devices"
        + (", prioritized per-shard sum-trees" if prioritized else "")
        + ")"
    )
    return cache


class DeviceReplayCache:
    """Device mirror of a replay buffer (see the module docstring).

    The rings are allocated on the first :meth:`add`, :meth:`load_from` or
    :meth:`load_from_replay`, with the dtypes and shapes of that data (f64 is
    stored as f32), on ``device``: the card unless the caller asks for
    another (``utils.resolve_device``).  Writes go into the rings and the
    tree in place."""

    def __init__(
        self,
        capacity: int,
        n_envs: int,
        device=None,
        budget_bytes: Optional[int] = None,
        prioritized: bool = False,
        per_alpha: float = 0.6,
        per_eps: float = 1e-6,
        per_decay: Optional[float] = None,
        kernel: str = "lax",
    ):
        if capacity <= 0 or n_envs <= 0:
            raise ValueError(f"capacity ({capacity}) and n_envs ({n_envs}) must be positive")
        self.capacity = int(capacity)
        self.n_envs = int(n_envs)
        self.device = resolve_device(device)
        self._tree: Optional[PriorityTree] = None
        self.kernel = kernel
        self.prioritized = bool(prioritized)
        self.per_alpha = float(per_alpha)
        self.per_eps = float(per_eps)
        self.per_decay = None if per_decay is None else float(per_decay)
        self._budget = budget_bytes
        self._bufs: Optional[Dict[str, torch.Tensor]] = None
        self._pos = np.zeros(n_envs, dtype=np.int64)
        self._filled = np.zeros(n_envs, dtype=np.int64)
        self.active = True  # False once the data would bust the budget

    @classmethod
    def maybe_create(cls, cfg, runtime, capacity: int, n_envs: int) -> Optional["DeviceReplayCache"]:
        """Create when the config allows: ``on`` always, ``auto`` on a card
        when the rings fit ``buffer.device_cache_budget_gb``, and wherever
        ``buffer.prioritized`` needs it (the sum-tree lives with the cache)."""
        mode = device_cache_setting(cfg)
        prioritized = bool(cfg.buffer.get("prioritized", False))
        if mode == "off":
            if prioritized:
                raise ValueError(
                    "buffer.prioritized=True requires the device sampler, but buffer.device_cache=False disables it; "
                    "drop one of the two (device_cache=auto enables the cache wherever PER needs it)"
                )
            return None
        if runtime.device_count != 1:
            return None  # a mesh of several shards: the env-sharded cache (_maybe_create_sharded)
        if mode == "auto" and runtime.device.type == "cpu" and not prioritized:
            return None
        budget_gb = float(cfg.buffer.get("device_cache_budget_gb", 6.0))
        return cls(
            capacity,
            n_envs,
            device=runtime.device,
            budget_bytes=int(budget_gb * 1e9) if mode == "auto" else None,
            prioritized=prioritized,
            per_alpha=float(cfg.buffer.get("per_alpha", 0.6)),
            per_eps=float(cfg.buffer.get("per_eps", 1e-6)),
            per_decay=cfg.buffer.get("per_decay_on_sample", None),
            kernel=str(cfg.buffer.get("per_kernel", "lax")),
        )

    @property
    def buffers(self) -> Optional[Dict[str, torch.Tensor]]:
        return self._bufs

    @property
    def tree(self) -> Optional[PriorityTree]:
        return self._tree

    @property
    def kernel(self) -> str:
        """``buffer.per_kernel``: it picks the gathers here and the sum-tree
        functions in :attr:`tree`; setting it sets both."""
        return self._kernel

    @kernel.setter
    def kernel(self, value) -> None:
        self._kernel = resolve_per_kernel(value)
        if self._tree is not None:
            self._tree.kernel = self._kernel

    def estimate_bytes(self, row: Dict[str, np.ndarray]) -> int:
        return sum(
            self.capacity * self.n_envs * int(np.prod(v.shape[2:], dtype=np.int64)) * _store_dtype(v.dtype).itemsize
            for v in row.values()
        )

    def _admit(self, row: Dict[str, np.ndarray]) -> bool:
        """The budget gate (``device_cache=auto``) and nothing else.

        JAX's ``_admit`` also keeps a ring over 2^31 - 2^20 bytes off the
        device, because XLA's TPU gathers address it in int32, and under
        ``auto`` a ring over 1.5 GB, an envelope measured on one TPU setup.
        Neither applies here: the window and transition gathers compute
        64-bit offsets (``csrc/gather.cu``), and the card's 80 GB hold a 1M-row
        DV3 ring (12.3 GB).  So a large ring with ``device_cache=True`` stays
        on the card, where JAX would train from the host buffer."""
        if self._budget is not None and self.estimate_bytes(row) > self._budget:
            self.active = False
            print(
                f"DeviceReplayCache: estimated {self.estimate_bytes(row) / 1e9:.2f} GB exceeds the "
                f"{self._budget / 1e9:.2f} GB budget; staying on the host path"
            )
            return False
        return True

    def _ensure(self, row: Dict[str, np.ndarray]) -> bool:
        if self._bufs is not None:
            return True
        if not self.active or not self._admit(row):
            return False
        self._bufs = {
            k: torch.zeros(
                (self.capacity, self.n_envs, *v.shape[2:]),
                dtype=torch.from_numpy(np.zeros(0, _store_dtype(v.dtype))).dtype,
                device=self.device,
            )
            for k, v in row.items()
        }
        self._ensure_tree()
        return True

    def _ensure_tree(self) -> None:
        if self.prioritized and self._tree is None:
            self._tree = PriorityTree(
                self.capacity * self.n_envs, alpha=self.per_alpha, eps=self.per_eps, device=self.device, kernel=self.kernel
            )

    def _to_device(self, v: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(v, dtype=_store_dtype(v.dtype))).to(self.device)

    # ------------------------------------------------------------- write
    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None) -> None:
        """Mirror of ``EnvIndependentReplayBuffer.add``: ``data`` is
        (T, n_envs_in, *feat); ``indices`` routes its columns to env rings
        (default: all envs in order).  When T exceeds the capacity only the
        last ``capacity`` rows survive, and the write heads still move by T.
        A prioritized cache seeds the written cells at the running max
        priority (one tree write for the whole window), which also retires
        the priority of every overwritten transition."""
        if not self.active:
            return
        first = next(iter(data.values()))
        t_len, n_in = first.shape[:2]
        if indices is None:
            if n_in != self.n_envs:
                raise ValueError(f"data has {n_in} env columns, cache has {self.n_envs}")
            indices = range(self.n_envs)
        idx = np.asarray(list(indices), dtype=np.int64)
        if len(idx) != n_in:
            raise ValueError(f"indices ({len(idx)}) must match data env columns ({n_in})")
        if not self._ensure({k: v[:, :1] for k, v in data.items()}):
            return
        if set(data.keys()) != set(self._bufs.keys()):
            print(
                f"DeviceReplayCache: step keys {sorted(data.keys())} != cached keys {sorted(self._bufs.keys())}; "
                "cache disabled, training continues on the host feed path"
            )
            self.active = False
            self._bufs = None
            return
        advance = t_len
        if t_len > self.capacity:
            data = {k: v[-self.capacity :] for k, v in data.items()}
            t_len = self.capacity
        start = (self._pos[idx] + (advance - t_len)) % self.capacity  # (n_in,)
        rows = (start[None, :] + np.arange(t_len)[:, None]) % self.capacity  # (T, n_in)
        rows_t = torch.from_numpy(rows).to(self.device)
        envs_t = torch.from_numpy(np.broadcast_to(idx[None, :], rows.shape).copy()).to(self.device)
        for k, v in data.items():
            buf = self._bufs[k]
            buf[rows_t, envs_t] = self._to_device(v).to(buf.dtype)
        if self._tree is not None:
            leaves = (rows_t * self.n_envs + envs_t).reshape(-1)
            self._tree.seed_max(leaves, torch.ones(leaves.shape, dtype=torch.bool, device=self.device))
        self._pos[idx] = (self._pos[idx] + advance) % self.capacity
        self._filled[idx] = np.minimum(self._filled[idx] + advance, self.capacity)

    def load_from(self, rb) -> None:
        """Bulk fill from an ``EnvIndependentReplayBuffer``: one host copy
        and one transfer per key.  Adopts the host buffer's write heads; a
        prioritized cache reseeds every stored cell at priority 1."""
        if not self.active:
            return
        subs = rb.buffer
        if len(subs) != self.n_envs or any(b.buffer_size != self.capacity for b in subs):
            raise ValueError(
                f"host buffer ({len(subs)} envs x {subs[0].buffer_size if subs else 0}) does not match the "
                f"cache ({self.n_envs} x {self.capacity})"
            )
        example = next(({k: np.asarray(v[:1]) for k, v in b.buffer.items()} for b in subs if b.buffer), None)
        if example is None:
            return  # nothing stored yet
        if not self._admit(example):
            return
        bufs = {}
        for k, v0 in example.items():
            parts = [
                np.asarray(b.buffer[k]) if b.buffer and k in b.buffer else np.zeros((self.capacity, 1, *v0.shape[2:]), v0.dtype)
                for b in subs
            ]
            bufs[k] = self._to_device(np.concatenate(parts, axis=1))
        self._bufs = bufs
        self._pos = np.asarray([b._pos for b in subs], dtype=np.int64)
        self._filled = np.asarray([b.buffer_size if b.full else b._pos for b in subs], dtype=np.int64)
        self._reseed_tree_filled()

    def load_from_replay(self, rb) -> None:
        """Bulk fill from a plain (flat-transition) ``ReplayBuffer``, whose
        envs share one write head; a prioritized cache reseeds every stored
        cell at priority 1."""
        if not self.active:
            return
        if rb.buffer_size != self.capacity or rb.n_envs != self.n_envs:
            raise ValueError(
                f"host buffer ({rb.n_envs} envs x {rb.buffer_size}) does not match the cache ({self.n_envs} x {self.capacity})"
            )
        if not rb.buffer:
            return  # nothing stored yet
        if not self._admit({k: np.asarray(v[:1]) for k, v in rb.buffer.items()}):
            return
        self._bufs = {k: self._to_device(np.asarray(v)) for k, v in rb.buffer.items()}
        pos = int(rb._pos)
        self._pos = np.full(self.n_envs, pos, dtype=np.int64)
        self._filled = np.full(self.n_envs, self.capacity if rb.full else pos, dtype=np.int64)
        self._reseed_tree_filled()

    # ------------------------------------------------- prioritized replay
    def _reseed_tree_filled(self) -> None:
        """Every stored cell at priority 1, every other at 0 (one write over
        all leaves): the state after a load, until ``load_priority_state``
        brings a saved tree."""
        if not self.prioritized or self._bufs is None:
            return
        self._ensure_tree()
        base = np.where(self._filled >= self.capacity, self._pos, 0)  # (n_envs,)
        offs = (np.arange(self.capacity)[:, None] - base[None, :]) % self.capacity
        stored = offs < self._filled[None, :]  # (cap, n_envs)
        n = self.capacity * self.n_envs
        self._tree.set_priorities(
            torch.arange(n, device=self.device), torch.from_numpy(stored.astype(np.float32).reshape(-1)).to(self.device)
        )

    def priority_state(self) -> Optional[Dict[str, Any]]:
        """The tree's checkpoint payload (None when not prioritized)."""
        return self._tree.state_dict() if self._tree is not None else None

    def load_priority_state(self, state: Optional[Dict[str, Any]]) -> None:
        """Restore a saved tree; ``None`` reseeds every stored cell at 1."""
        if not self.prioritized or not self.active or self._bufs is None:
            return
        self._ensure_tree()
        if state is None:
            self._reseed_tree_filled()
        else:
            self._tree.load_state_dict(state)

    def update_priorities(self, idx, td_abs) -> None:
        """TD-error feedback: ``idx`` are the leaves a prioritized draw
        returned (any shape), ``td_abs`` the matching |delta|.  Stays on the
        device; a no-op without a tree."""
        if self._tree is None:
            return
        idx = torch.as_tensor(idx, device=self.device).reshape(-1)
        self._tree.update(idx, torch.as_tensor(td_abs, device=self.device).reshape(-1))

    # ------------------------------------------------------------- read
    def can_sample(self, seq_len: int) -> bool:
        return self.active and self._bufs is not None and bool(np.all(self._filled >= seq_len))

    def can_sample_transitions(self, sample_next_obs: bool = False) -> bool:
        need = 2 if sample_next_obs else 1
        return self.active and self._bufs is not None and bool(np.all(self._filled >= need))

    def draw(
        self, flat: int, generator: Optional[torch.Generator] = None
    ) -> tuple:
        """(envs int32, u f32) for ``flat`` window starts or transition rows,
        from ``generator`` (on the cache's device)."""
        envs = torch.randint(0, self.n_envs, (flat,), generator=generator, device=self.device, dtype=torch.int32)
        u = torch.rand((flat,), generator=generator, device=self.device)
        return envs, u

    def _check_draw(self, batch_size: int, n_samples: int) -> None:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")

    def _check_tree(self) -> None:
        if self._tree is None:
            raise RuntimeError("prioritized sampling requested on a cache built without prioritized=True")

    def sample(
        self,
        n_samples: int,
        batch_size: int,
        seq_len: int,
        generator: Optional[torch.Generator] = None,
        *,
        envs: Optional[torch.Tensor] = None,
        u: Optional[torch.Tensor] = None,
    ) -> List[Dict[str, torch.Tensor]]:
        """``n_samples`` independent (seq_len, batch, *feat) batches on the
        card, one per gradient step, from one gather.  ``envs``/``u`` are
        the draws (flat = n_samples * batch); by default they come from
        ``generator``."""
        self._check_draw(batch_size, n_samples)
        if not self.can_sample(seq_len):
            raise ValueError(
                f"Cannot sample a sequence of length {seq_len}. Data added so far: {int(self._filled.min())}"
            )
        flat = n_samples * batch_size
        if envs is None or u is None:
            envs, u = self.draw(flat, generator)
        envs = envs.to(self.device, torch.int32).contiguous()
        starts = sample_window_starts(
            torch.from_numpy(self._pos).to(self.device),
            torch.from_numpy(self._filled).to(self.device),
            envs,
            u.to(self.device),
            seq_len=seq_len,
            cap=self.capacity,
        ).contiguous()
        return self._windows(starts, envs, n_samples, batch_size, seq_len)

    def _windows(self, starts, envs, n_samples: int, batch_size: int, seq_len: int) -> List[Dict[str, torch.Tensor]]:
        gather = gather_windows if self.kernel == "pallas" else gather_windows_plain
        out = gather(self._bufs, starts, envs, seq_len=seq_len, batch_size=batch_size)
        return [{k: v[i] for k, v in out.items()} for i in range(n_samples)]

    def sample_per(
        self,
        n_samples: int,
        batch_size: int,
        seq_len: int,
        generator: Optional[torch.Generator] = None,
        beta: float = 0.0,
        *,
        r01: Optional[torch.Tensor] = None,
    ) -> List[Dict[str, torch.Tensor]]:
        """Prioritized sequence-start draw (``_sample_prioritized``,
        ``device_buffer.py:313-354``): the layout of :meth:`sample`, with
        each window's start cell drawn proportional to its priority.  The
        L - 1 rows before each env's write head cannot start a full window
        and are excluded from the draw.  With ``per_decay`` the drawn starts'
        priorities are multiplied by it afterwards.  ``r01`` are the
        n_samples * batch uniforms (by default from ``generator``)."""
        self._check_draw(batch_size, n_samples)
        if not self.can_sample(seq_len):
            raise ValueError(
                f"Cannot sample a sequence of length {seq_len}. Data added so far: {int(self._filled.min())}"
            )
        self._check_tree()
        flat = n_samples * batch_size
        n_live = int(np.maximum(self._filled - seq_len + 1, 0).sum())
        excl = window_exclusions(self._pos, self.capacity, seq_len)
        excl = None if excl is None else upload(excl, self.device)
        leaves, _ = self._tree.sample(flat, beta=beta, count=n_live, exclude_idx=excl, generator=generator, r01=r01)
        starts = (leaves // self.n_envs).to(torch.int32).contiguous()
        envs = (leaves % self.n_envs).to(torch.int32).contiguous()
        out = self._windows(starts, envs, n_samples, batch_size, seq_len)
        if self.per_decay is not None:
            self._tree.scale(leaves, self.per_decay)
        return out

    def _transition_draw_ready(self, n_samples: int, batch_size: int, sample_next_obs: bool) -> None:
        self._check_draw(batch_size, n_samples)
        if not self.can_sample_transitions(sample_next_obs):
            raise ValueError("Not enough data in the device cache, add first")

    def _transitions(self, rows, envs, n_samples: int, batch_size: int, next_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
        """(flat,) rows/envs -> {k: (n_samples, batch, *feat)} (``_gather_transitions``)."""
        gather = gather_transitions if self.kernel == "pallas" else gather_transitions_plain
        flat = gather(self._bufs, rows, envs, next_keys=next_keys)
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in flat.items()}

    def sample_transitions(
        self,
        n_samples: int,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        sample_next_obs: bool = False,
        obs_keys: Sequence[str] = (),
        *,
        envs: Optional[torch.Tensor] = None,
        u: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Uniform flat-transition draw mirroring ``ReplayBuffer.sample``: one
        dict of (n_samples, batch, *feat) (and ``next_<k>`` for ``obs_keys``
        with ``sample_next_obs``).  ``envs``/``u`` are the draws (by default
        from ``generator``)."""
        self._transition_draw_ready(n_samples, batch_size, sample_next_obs)
        flat = n_samples * batch_size
        if envs is None or u is None:
            envs, u = self.draw(flat, generator)
        # the envs add in lockstep: env 0's write head and fill are everyone's
        pos, filled = int(self._pos[0]), int(self._filled[0])
        rows = sample_transition_rows(
            u.to(self.device),
            base=pos if filled >= self.capacity else 0,
            count=filled - (1 if sample_next_obs else 0),
            cap=self.capacity,
        ).contiguous()
        next_keys = tuple(obs_keys) if sample_next_obs else ()
        return self._transitions(rows, envs.to(self.device, torch.int32).contiguous(), n_samples, batch_size, next_keys)

    def sample_transitions_per(
        self,
        n_samples: int,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        beta: float = 0.4,
        sample_next_obs: bool = False,
        obs_keys: Sequence[str] = (),
        *,
        r01: Optional[torch.Tensor] = None,
    ):
        """Prioritized flat-transition draw (``_sample_transitions_prioritized``,
        ``device_buffer.py:202-246``): :meth:`sample_transitions`' dict plus
        ``is_weights`` (n_samples, batch, 1), and the drawn leaves
        (n_samples, batch) for :meth:`update_priorities`.  With
        ``sample_next_obs`` each env's newest row is excluded (its successor
        is stale).  ``r01`` are the uniforms (by default from ``generator``)."""
        self._transition_draw_ready(n_samples, batch_size, sample_next_obs)
        self._check_tree()
        flat = n_samples * batch_size
        next_keys = tuple(obs_keys) if sample_next_obs else ()
        n_live = int(self._filled.sum()) - (self.n_envs if next_keys else 0)
        excl = upload(head_exclusions(self._pos, self.capacity), self.device) if next_keys else None
        leaves, w = self._tree.sample(flat, beta=beta, count=n_live, exclude_idx=excl, generator=generator, r01=r01)
        rows = (leaves // self.n_envs).to(torch.int32).contiguous()
        envs = (leaves % self.n_envs).to(torch.int32).contiguous()
        out = self._transitions(rows, envs, n_samples, batch_size, next_keys)
        out["is_weights"] = w.reshape(n_samples, batch_size, 1)
        return out, leaves.reshape(n_samples, batch_size)


class ShardedDeviceReplayCache(DeviceReplayCache):
    """The env-sharded cache of a mesh of N shards (``device_buffer.py:1054-1438``).

    Shard ``r`` owns env columns ``[r * n_local, (r + 1) * n_local)`` of the
    rings (``n_local = n_envs / N``) and the sub-tree of
    :class:`~sheeprl_tpu_torch.replay.priority_tree.ShardedPriorityTree`
    over their cells.  JAX places each device's columns on that device
    (``P(None, BATCH_AXES)``); here every shard lies on the runtime's one
    device, so the rings stay one tensor per key (the global layout, written
    by the base class's adds and loads) and a shard's rings are its columns
    of it (:meth:`shard_buffers`).  Each shard's work runs in shard order and
    touches only its columns: the gathers address them by global env index
    in one launch per shard.

    - :meth:`sample` and :meth:`sample_transitions`: stratified uniform draws,
      ``batch / N`` rows from each shard's own envs (JAX draws them from
      ``fold_in(key, rank)``; ``envs``/``u`` here are (N, flat / N) per-shard
      draws, envs shard-local), the batch axis in shard order;
    - :meth:`sample_transitions_per` and :meth:`sample_per`: globally
      proportional draws (:func:`shard_proportional_draw`), shard-local
      exclusions, each shard gathering every draw and keeping those it owns,
      the batch assembled by a masked sum over the shards (JAX's masked
      psum, so the bytes are JAX's), IS weights from the summed masses and
      the summed live counts."""

    def __init__(
        self,
        capacity: int,
        n_envs: int,
        runtime,
        budget_bytes: Optional[int] = None,
        prioritized: bool = False,
        per_alpha: float = 0.6,
        per_eps: float = 1e-6,
        per_decay: Optional[float] = None,
        kernel: str = "lax",
    ):
        n_dev = runtime.device_count
        if n_envs % n_dev:
            raise ValueError(f"n_envs ({n_envs}) must divide over {n_dev} devices")
        super().__init__(
            capacity,
            n_envs,
            device=runtime.device,
            budget_bytes=budget_bytes,
            prioritized=prioritized,
            per_alpha=per_alpha,
            per_eps=per_eps,
            per_decay=per_decay,
            kernel=kernel,
        )
        self._runtime = runtime
        self._n_dev = n_dev
        self.n_local_envs = n_envs // n_dev

    def _ensure_tree(self) -> None:
        if self.prioritized and self._tree is None:
            self._tree = ShardedPriorityTree(
                self.capacity, self.n_envs, self._n_dev, self.device,
                alpha=self.per_alpha, eps=self.per_eps, kernel=self.kernel,
            )

    def _cols(self, r: int) -> slice:
        return slice(r * self.n_local_envs, (r + 1) * self.n_local_envs)

    def shard_buffers(self, r: int) -> Dict[str, torch.Tensor]:
        """Shard ``r``'s rings: (capacity, n_local, *feat) views of its columns."""
        return {k: v[:, self._cols(r)] for k, v in self._bufs.items()}

    def _local_draws(self, flat: int, generator, envs, u):
        """Per-shard (envs, u): the given (N, flat / N) draws, or drawn from
        ``generator`` shard by shard."""
        if envs is None or u is None:
            envs = torch.stack([
                torch.randint(0, self.n_local_envs, (flat,), generator=generator, device=self.device, dtype=torch.int32)
                for _ in range(self._n_dev)
            ])
            u = torch.rand((self._n_dev, flat), generator=generator, device=self.device)
        return envs.to(self.device, torch.int32).reshape(self._n_dev, flat), u.to(self.device).reshape(self._n_dev, flat)

    def _check_split(self, batch_size: int) -> None:
        if batch_size % self._n_dev:
            raise ValueError(f"batch_size ({batch_size}) must divide over {self._n_dev} devices")

    # ---- per-shard stratified uniform samplers
    def sample(
        self,
        n_samples: int,
        batch_size: int,
        seq_len: int,
        generator: Optional[torch.Generator] = None,
        *,
        envs: Optional[torch.Tensor] = None,
        u: Optional[torch.Tensor] = None,
    ) -> List[Dict[str, torch.Tensor]]:
        self._check_draw(batch_size, n_samples)
        self._check_split(batch_size)
        if not self.can_sample(seq_len):
            raise ValueError(
                f"Cannot sample a sequence of length {seq_len}. Data added so far: {int(self._filled.min())}"
            )
        b_local = batch_size // self._n_dev
        envs, u = self._local_draws(n_samples * b_local, generator, envs, u)
        gather = gather_windows if self.kernel == "pallas" else gather_windows_plain
        parts = []
        for r in range(self._n_dev):
            cols = self._cols(r)
            starts = sample_window_starts(
                torch.from_numpy(self._pos[cols]).to(self.device),
                torch.from_numpy(self._filled[cols]).to(self.device),
                envs[r], u[r], seq_len=seq_len, cap=self.capacity,
            ).contiguous()
            env_g = (envs[r] + r * self.n_local_envs).contiguous()
            parts.append(gather(self._bufs, starts, env_g, seq_len=seq_len, batch_size=b_local))
        out = {k: torch.cat([p[k] for p in parts], 2) for k in parts[0]}
        return [{k: v[i] for k, v in out.items()} for i in range(n_samples)]

    def sample_transitions(
        self,
        n_samples: int,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        sample_next_obs: bool = False,
        obs_keys: Sequence[str] = (),
        *,
        envs: Optional[torch.Tensor] = None,
        u: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Stratified uniform flat-transition draw: each shard gathers
        ``batch / N`` rows from its own env columns."""
        self._transition_draw_ready(n_samples, batch_size, sample_next_obs)
        self._check_split(batch_size)
        b_local = batch_size // self._n_dev
        envs, u = self._local_draws(n_samples * b_local, generator, envs, u)
        next_keys = tuple(obs_keys) if sample_next_obs else ()
        parts = []
        for r in range(self._n_dev):
            # the envs add in lockstep: the shard's first env's head and fill are its envs'
            pos, filled = int(self._pos[r * self.n_local_envs]), int(self._filled[r * self.n_local_envs])
            rows = sample_transition_rows(
                u[r], base=pos if filled >= self.capacity else 0, count=filled - (1 if sample_next_obs else 0), cap=self.capacity
            ).contiguous()
            env_g = (envs[r] + r * self.n_local_envs).contiguous()
            parts.append(self._transitions(rows, env_g, n_samples, b_local, next_keys))
        return {k: torch.cat([p[k] for p in parts], 1) for k in parts[0]}

    # ---- globally proportional prioritized samplers
    def sample_transitions_per(
        self,
        n_samples: int,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        beta: float = 0.4,
        sample_next_obs: bool = False,
        obs_keys: Sequence[str] = (),
        *,
        r01: Optional[torch.Tensor] = None,
    ):
        self._transition_draw_ready(n_samples, batch_size, sample_next_obs)
        self._check_tree()
        next_keys = tuple(obs_keys) if sample_next_obs else ()
        return self._sharded_per(n_samples, batch_size, None, next_keys, generator, r01, beta)

    def sample_per(
        self,
        n_samples: int,
        batch_size: int,
        seq_len: int,
        generator: Optional[torch.Generator] = None,
        beta: float = 0.0,
        *,
        r01: Optional[torch.Tensor] = None,
    ) -> List[Dict[str, torch.Tensor]]:
        """Prioritized sequence starts (no IS weights: ``beta`` is unused, as
        in JAX); with ``per_decay`` the drawn starts are decayed after."""
        self._check_draw(batch_size, n_samples)
        if not self.can_sample(seq_len):
            raise ValueError(
                f"Cannot sample a sequence of length {seq_len}. Data added so far: {int(self._filled.min())}"
            )
        self._check_tree()
        out, leaves = self._sharded_per(n_samples, batch_size, int(seq_len), (), generator, r01, 0.0)
        if self.per_decay is not None:
            self._tree.scale(leaves, self.per_decay)
        return [{k: v[i] for k, v in out.items()} for i in range(n_samples)]

    def _shard_exclusions(self, r: int, seq_len: Optional[int], next_keys) -> Optional[torch.Tensor]:
        """Shard ``r``'s local sampling exclusions: the L - 1 rows before each
        env's head (window starts), or each env's head row (next observations)."""
        pos_l = self._pos[self._cols(r)]
        if seq_len is not None and seq_len > 1:
            excl = window_exclusions(pos_l, self.capacity, seq_len)
        elif seq_len is None and next_keys:
            excl = head_exclusions(pos_l, self.capacity)
        else:
            return None
        return upload(excl, self.device)

    def _sharded_per(self, n_samples, batch_size, seq_len, next_keys, generator, r01, beta):
        """``_build_sharded_per``'s body for every shard (``device_buffer.py:1337-1438``):
        ``seq_len=None`` draws flat transitions with IS weights, an int draws
        window starts.  Returns the batch and the (n_samples, batch) int32
        global leaves."""
        flat = n_samples * batch_size
        if r01 is None:
            r01 = torch.rand((flat,), generator=generator, device=self.device)
        r01 = r01.to(self.device, torch.float32).reshape(-1)
        if r01.numel() != flat:
            raise ValueError(f"{r01.numel()} uniforms for {flat} draws")
        nl, depth = self.n_local_envs, self._tree.depth
        excl = [self._shard_exclusions(r, seq_len, next_keys) for r in range(self._n_dev)]
        trees = list(self._tree.trees)
        if self.kernel == "pallas":
            draws = shard_proportional_draw(
                trees, r01, depth=depth, kernel="pallas", exclude_idx=None if excl[0] is None else excl,
                scratch=None if excl[0] is None or self.device.type != "cuda" else self._tree.draw_scratch(excl[0].numel()),
            )
        else:
            trees = [t if e is None else _tree_zeroed_local(t, e, depth) for t, e in zip(trees, excl)]
            draws = shard_proportional_draw(trees, r01, depth=depth)
        windows = seq_len is not None
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        cells, parts = [], []
        for r, (leaf, _, own, _) in enumerate(draws):
            leaf = leaf.long()
            rows = leaf // nl
            env_g = r * nl + leaf % nl
            cells.append(torch.where(own, rows * self.n_envs + env_g, zero))
            if windows:
                t_idx = (rows[:, None] + torch.arange(seq_len, device=self.device)[None, :]) % self.capacity
                got = {k: buf[t_idx, env_g[:, None]] for k, buf in self._bufs.items()}  # (flat, L, *feat)
            else:
                got = gather_transitions_plain(self._bufs, rows, env_g, next_keys=next_keys)  # (flat, *feat)
            parts.append({k: torch.where(own.reshape((flat,) + (1,) * (g.dim() - 1)), g, torch.zeros((), dtype=g.dtype, device=self.device)) for k, g in got.items()})
        out = {}
        for k in parts[0]:
            g = psum([p[k] for p in parts])
            if windows:
                g = g.reshape(n_samples, batch_size, seq_len, *g.shape[2:]).transpose(1, 2).contiguous()
            else:
                g = g.reshape(n_samples, batch_size, *g.shape[1:])
            out[k] = g
        if not windows:
            zf = torch.zeros((), device=self.device)
            mass_global = psum([torch.where(own, mass, zf) for _, mass, own, _ in draws])
            live = [float(self._filled[self._cols(r)].sum() - (nl if next_keys else 0)) for r in range(self._n_dev)]
            # made on the device (a fill), not copied from the host: no stream sync
            n_live = psum([torch.full((), v, dtype=torch.float32, device=self.device) for v in live])
            total = draws[0][3]
            tiny = torch.finfo(torch.float32).tiny
            probs = torch.clamp_min(mass_global, tiny) / torch.clamp_min(total, tiny)
            w = (torch.clamp_min(n_live, 1.0) * probs) ** (-torch.full((), float(beta), dtype=torch.float32, device=self.device))
            out["is_weights"] = (w / w.max()).reshape(n_samples, batch_size, 1)
        leaves = psum(cells).to(torch.int32).reshape(n_samples, batch_size)
        return out, leaves


@contextlib.contextmanager
def sequence_batches(rb, device_cache, device, n_samples: int, batch_size: int, seq_len: int, generator=None):
    """The train loop's feed: yields an iterable of per-gradient-step batch
    dicts: one on-card draw when the cache can sample (prioritized starts
    when the cache keeps a tree: biased by design, with no IS weights, so
    beta is 0), else the host ``rb.sample`` through
    :func:`~sheeprl_tpu_torch.data.feed.batched_feed`."""
    if device_cache is not None and device_cache.can_sample(seq_len):
        if device_cache.prioritized and device_cache.tree is not None:
            yield device_cache.sample_per(n_samples, batch_size, seq_len, generator, beta=0.0)
        else:
            yield device_cache.sample(n_samples, batch_size, seq_len, generator)
        return
    from sheeprl_tpu_torch.data.feed import batched_feed

    local_data = rb.sample(batch_size, sequence_length=seq_len, n_samples=n_samples)
    with batched_feed(local_data, n_samples, device) as feed:
        yield feed

"""Device-resident replay window with on-device sequence sampling.

Counterpart of the single-device half of ``sheeprl_tpu/data/device_buffer.py``:
:class:`DeviceReplayCache` mirrors an ``EnvIndependentReplayBuffer`` over
``SequentialReplayBuffer``s in rings ``(capacity, n_envs, *feat)`` on the
card.  Each policy step appends only its new rows; a draw is one gather on
the card instead of a host sample and a copy of every batch.  Semantics
are the host buffer's: one ring per env with its own write head, the env
drawn uniformly per batch row, the window start uniform over the
``filled - L + 1`` starts that never cross the write head.

``buffer.per_kernel`` keeps its JAX meaning: ``pallas`` gathers every key's
windows with the hand-written kernel (``ops/gather.py``, one launch per
draw), ``lax`` with per-key advanced indexing.  Both give the same bytes.

Not ported yet: prioritized sampling (``buffer.prioritized``, the
sum-tree kernels of the next slice) and the env-sharded cache of
multi-device meshes (the multi-GPU slice); both raise.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.ops.gather import gather_windows, gather_windows_plain

__all__ = [
    "DeviceReplayCache",
    "device_cache_setting",
    "maybe_create_for",
    "sample_window_starts",
    "sequence_batches",
]

_KERNELS = ("lax", "pallas")


def _store_dtype(dt) -> np.dtype:
    dt = np.dtype(dt)
    return np.dtype(np.float32) if dt == np.float64 else dt


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


def maybe_create_for(cfg, runtime, rb) -> Optional["DeviceReplayCache"]:
    """A cache mirroring ``rb`` when it is an ``EnvIndependentReplayBuffer``
    and the config allows one, filled from ``rb`` (empty when ``rb`` is)."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer

    if not isinstance(rb, EnvIndependentReplayBuffer):
        return None
    cache = DeviceReplayCache.maybe_create(cfg, runtime, capacity=rb.buffer_size, n_envs=rb.n_envs)
    if cache is not None:
        cache.load_from(rb)
    return cache


class DeviceReplayCache:
    """Device mirror of a sequential replay buffer (see the module docstring).

    The rings are allocated on the first :meth:`add` or :meth:`load_from`,
    with the dtypes and shapes of that data (f64 is stored as f32).  Writes
    go into the rings in place."""

    def __init__(
        self,
        capacity: int,
        n_envs: int,
        device=None,
        budget_bytes: Optional[int] = None,
        prioritized: bool = False,
        kernel: str = "lax",
    ):
        if capacity <= 0 or n_envs <= 0:
            raise ValueError(f"capacity ({capacity}) and n_envs ({n_envs}) must be positive")
        if prioritized:
            raise NotImplementedError("prioritized device replay (buffer.prioritized) is not ported yet: slice 3")
        if kernel not in _KERNELS:
            raise ValueError(f"buffer.per_kernel must be one of {_KERNELS}, got '{kernel}'")
        self.capacity = int(capacity)
        self.n_envs = int(n_envs)
        self.device = torch.device("cpu" if device is None else device)
        self.kernel = kernel
        self._budget = budget_bytes
        self._bufs: Optional[Dict[str, torch.Tensor]] = None
        self._pos = np.zeros(n_envs, dtype=np.int64)
        self._filled = np.zeros(n_envs, dtype=np.int64)
        self.active = True  # False once the data would bust the budget

    @classmethod
    def maybe_create(cls, cfg, runtime, capacity: int, n_envs: int) -> Optional["DeviceReplayCache"]:
        """Create when the config allows: ``on`` always, ``auto`` on a card
        when the rings fit ``buffer.device_cache_budget_gb``."""
        mode = device_cache_setting(cfg)
        if bool(cfg.buffer.get("prioritized", False)):
            raise NotImplementedError("prioritized device replay (buffer.prioritized) is not ported yet: slice 3")
        if mode == "off" or (mode == "auto" and runtime.device.type == "cpu"):
            return None
        budget_gb = float(cfg.buffer.get("device_cache_budget_gb", 6.0))
        return cls(
            capacity,
            n_envs,
            device=runtime.device,
            budget_bytes=int(budget_gb * 1e9) if mode == "auto" else None,
            kernel=str(cfg.buffer.get("per_kernel", "lax")),
        )

    @property
    def buffers(self) -> Optional[Dict[str, torch.Tensor]]:
        return self._bufs

    def estimate_bytes(self, row: Dict[str, np.ndarray]) -> int:
        return sum(
            self.capacity * self.n_envs * int(np.prod(v.shape[2:], dtype=np.int64)) * _store_dtype(v.dtype).itemsize
            for v in row.values()
        )

    def _admit(self, row: Dict[str, np.ndarray]) -> bool:
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
        return True

    def _to_device(self, v: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(v, dtype=_store_dtype(v.dtype))).to(self.device)

    # ------------------------------------------------------------- write
    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None) -> None:
        """Mirror of ``EnvIndependentReplayBuffer.add``: ``data`` is
        (T, n_envs_in, *feat); ``indices`` routes its columns to env rings
        (default: all envs in order).  When T exceeds the capacity only the
        last ``capacity`` rows survive, and the write heads still move by T."""
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
        self._pos[idx] = (self._pos[idx] + advance) % self.capacity
        self._filled[idx] = np.minimum(self._filled[idx] + advance, self.capacity)

    def load_from(self, rb) -> None:
        """Bulk fill from an ``EnvIndependentReplayBuffer``: one host copy
        and one transfer per key.  Adopts the host buffer's write heads."""
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

    # ------------------------------------------------------------- read
    def can_sample(self, seq_len: int) -> bool:
        return self.active and self._bufs is not None and bool(np.all(self._filled >= seq_len))

    def draw(
        self, flat: int, generator: Optional[torch.Generator] = None
    ) -> tuple:
        """(envs int32, u f32) for ``flat`` window starts, from ``generator``
        (on the cache's device)."""
        envs = torch.randint(0, self.n_envs, (flat,), generator=generator, device=self.device, dtype=torch.int32)
        u = torch.rand((flat,), generator=generator, device=self.device)
        return envs, u

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
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
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
        gather = gather_windows if self.kernel == "pallas" else gather_windows_plain
        out = gather(self._bufs, starts, envs, seq_len=seq_len, batch_size=batch_size)
        return [{k: v[i] for k, v in out.items()} for i in range(n_samples)]


@contextlib.contextmanager
def sequence_batches(rb, device_cache, device, n_samples: int, batch_size: int, seq_len: int, generator=None):
    """The train loop's feed: yields an iterable of per-gradient-step batch
    dicts: one on-card draw when the cache can sample, else the host
    ``rb.sample`` through :func:`~sheeprl_tpu_torch.data.feed.batched_feed`."""
    if device_cache is not None and device_cache.can_sample(seq_len):
        yield device_cache.sample(n_samples, batch_size, seq_len, generator)
        return
    from sheeprl_tpu_torch.data.feed import batched_feed

    local_data = rb.sample(batch_size, sequence_length=seq_len, n_samples=n_samples)
    with batched_feed(local_data, n_samples, device) as feed:
        yield feed

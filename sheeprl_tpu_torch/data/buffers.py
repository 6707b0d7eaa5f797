"""Host replay buffers: dict-of-numpy, time-major (T, n_envs, *).

Counterpart of ``sheeprl_tpu/data/buffers.py`` (``ReplayBuffer``,
``SequentialReplayBuffer``, ``EnvIndependentReplayBuffer``): the same
storage, the same wrap-around index arithmetic and the same draws from the
same ``np.random.Generator``, so a buffer seeded alike samples the same
rows in both packages.  Memory-mapped storage and the replay-corruption
fault site wait for the checkpoint and resilience slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Type, Union

import numpy as np

__all__ = ["EnvIndependentReplayBuffer", "ReplayBuffer", "SequentialReplayBuffer"]


class ReplayBuffer:
    """Circular dict-of-arrays buffer, shapes (buffer_size, n_envs, *)."""

    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if memmap:
            raise NotImplementedError("memory-mapped replay is not ported yet (checkpoint slice); use buffer.memmap=False")
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._buf: Dict[str, np.ndarray] = {}
        self._pos = 0
        self._full = False
        self._rng: np.random.Generator = np.random.default_rng()

    @property
    def buffer(self) -> Dict[str, np.ndarray]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def full(self) -> bool:
        return self._full

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def empty(self) -> bool:
        return len(self._buf) == 0

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def _validate(data: Dict[str, np.ndarray]) -> None:
        if not isinstance(data, dict):
            raise ValueError(f"'data' must be a dict of numpy arrays, got {type(data)}")
        shapes = {}
        for k, v in data.items():
            if not isinstance(v, np.ndarray):
                raise ValueError(f"'data[{k}]' must be a numpy array, got {type(v)}")
            if v.ndim < 2:
                raise RuntimeError(
                    f"'data' must have at least 2 dims [sequence_length, n_envs, ...]; '{k}' has shape {v.shape}"
                )
            shapes[k] = v.shape[:2]
        if len(set(shapes.values())) > 1:
            raise RuntimeError(f"Arrays in 'data' must agree in the first 2 dims, got {shapes}")

    def add(self, data: Union["ReplayBuffer", Dict[str, np.ndarray]], validate_args: bool = False) -> None:
        """Insert (T, n_envs, *) rows at the write head, wrapping circularly."""
        if isinstance(data, ReplayBuffer):
            data = data.buffer
        if validate_args:
            self._validate(data)
        data_len = next(iter(data.values())).shape[0]
        next_pos = (self._pos + data_len) % self._buffer_size
        if next_pos <= self._pos or (data_len > self._buffer_size and not self._full):
            idxes = np.concatenate([np.arange(self._pos, self._buffer_size), np.arange(0, next_pos)]).astype(np.intp)
        else:
            idxes = np.arange(self._pos, next_pos, dtype=np.intp)
        if data_len > self._buffer_size:
            # keep only the most recent buffer_size rows (+ the wrapped tail)
            data = {k: v[-self._buffer_size - next_pos :] for k, v in data.items()}
        if self.empty:
            for k, v in data.items():
                self._buf[k] = np.empty((self._buffer_size, self._n_envs, *v.shape[2:]), dtype=v.dtype)
        for k, v in data.items():
            self._buf[k][idxes] = v
        if self._pos + data_len >= self._buffer_size:
            self._full = True
        self._pos = next_pos

    def sample(
        self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1, **kwargs: Any
    ) -> Dict[str, np.ndarray]:
        """Uniform sample -> dict of (n_samples, batch_size, *).  With
        ``sample_next_obs`` the row at the write head is excluded (its next
        observation is stale)."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer, call 'add' first")
        if self._full:
            first_range_end = self._pos - 1 if sample_next_obs else self._pos
            second_range_end = self._buffer_size if first_range_end >= 0 else self._buffer_size + first_range_end
            valid = np.concatenate([np.arange(0, first_range_end), np.arange(self._pos, second_range_end)]).astype(
                np.intp
            )
            batch_idxes = valid[self._rng.integers(0, len(valid), size=(batch_size * n_samples,))]
        else:
            max_pos = self._pos - 1 if sample_next_obs else self._pos
            if max_pos == 0:
                raise RuntimeError("Cannot sample next observations with a single transition in the buffer")
            batch_idxes = self._rng.integers(0, max_pos, size=(batch_size * n_samples,), dtype=np.intp)
        out = self._get_samples(batch_idxes, sample_next_obs=sample_next_obs, clone=clone)
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in out.items()}

    def _get_samples(
        self, batch_idxes: np.ndarray, sample_next_obs: bool = False, clone: bool = False
    ) -> Dict[str, np.ndarray]:
        if self.empty:
            raise RuntimeError("The buffer has not been initialized, add data first")
        env_idxes = self._rng.integers(0, self._n_envs, size=(len(batch_idxes),), dtype=np.intp)
        flat = (batch_idxes * self._n_envs + env_idxes).ravel()
        if sample_next_obs:
            flat_next = (((batch_idxes + 1) % self._buffer_size) * self._n_envs + env_idxes).ravel()
        samples: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            flat_v = v.reshape(-1, *v.shape[2:])
            samples[k] = np.take(flat_v, flat, axis=0)
            if clone:
                samples[k] = samples[k].copy()
            if sample_next_obs and k in self._obs_keys:
                samples[f"next_{k}"] = np.take(flat_v, flat_next, axis=0)
                if clone:
                    samples[f"next_{k}"] = samples[f"next_{k}"].copy()
        return samples


class SequentialReplayBuffer(ReplayBuffer):
    """Samples contiguous sequences (n_samples, seq_len, batch, *), ignoring
    episode boundaries; start windows never cross the write head."""

    batch_axis: int = 2

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        sequence_length: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        batch_dim = batch_size * n_samples
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer, call 'add' first")
        if not self._full and self._pos - sequence_length + 1 < 1:
            raise ValueError(f"Cannot sample a sequence of length {sequence_length}. Data added so far: {self._pos}")
        if self._full and sequence_length > self._buffer_size:
            raise ValueError(
                f"The sequence length ({sequence_length}) is greater than the buffer size ({self._buffer_size})"
            )
        if self._full:
            first_range_end = self._pos - sequence_length + 1
            second_range_end = self._buffer_size if first_range_end >= 0 else self._buffer_size + first_range_end
            valid = np.concatenate(
                [np.arange(0, max(first_range_end, 0)), np.arange(self._pos, second_range_end)]
            ).astype(np.intp)
            start_idxes = valid[self._rng.integers(0, len(valid), size=(batch_dim,))]
        else:
            start_idxes = self._rng.integers(0, self._pos - sequence_length + 1, size=(batch_dim,), dtype=np.intp)
        chunk = np.arange(sequence_length, dtype=np.intp)[None, :]
        idxes = (start_idxes[:, None] + chunk) % self._buffer_size
        return self._get_seq_samples(idxes, batch_size, n_samples, sequence_length, sample_next_obs, clone)

    def _get_seq_samples(
        self,
        batch_idxes: np.ndarray,
        batch_size: int,
        n_samples: int,
        sequence_length: int,
        sample_next_obs: bool = False,
        clone: bool = False,
    ) -> Dict[str, np.ndarray]:
        flat_batch_idxes = batch_idxes.ravel()
        # each sequence stays within one env
        if self._n_envs == 1:
            env_idxes = np.zeros(flat_batch_idxes.shape[0], dtype=np.intp)
        else:
            env_idxes = self._rng.integers(0, self._n_envs, size=(batch_size * n_samples,), dtype=np.intp)
            env_idxes = np.repeat(env_idxes, sequence_length)
        flat = (flat_batch_idxes * self._n_envs + env_idxes).ravel()
        samples: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            flat_v = v.reshape(-1, *v.shape[2:])
            taken = np.take(flat_v, flat, axis=0)
            samples[k] = np.swapaxes(taken.reshape(n_samples, batch_size, sequence_length, *taken.shape[1:]), 1, 2)
            if clone:
                samples[k] = samples[k].copy()
            if sample_next_obs:
                flat_next = (((flat_batch_idxes + 1) % self._buffer_size) * self._n_envs + env_idxes).ravel()
                taken_n = np.take(flat_v, flat_next, axis=0)
                samples[f"next_{k}"] = np.swapaxes(
                    taken_n.reshape(n_samples, batch_size, sequence_length, *taken_n.shape[1:]), 1, 2
                )
                if clone:
                    samples[f"next_{k}"] = samples[f"next_{k}"].copy()
        return samples


class EnvIndependentReplayBuffer:
    """One sub-buffer per environment: routed adds, multinomial sample split."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        buffer_cls: Type[ReplayBuffer] = ReplayBuffer,
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        self._buf = [
            buffer_cls(buffer_size=buffer_size, n_envs=1, obs_keys=obs_keys, memmap=memmap, **kwargs)
            for _ in range(n_envs)
        ]
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._rng: np.random.Generator = np.random.default_rng()
        self._concat_along_axis = buffer_cls.batch_axis

    @property
    def buffer(self) -> Sequence[ReplayBuffer]:
        return tuple(self._buf)

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)
        for i, b in enumerate(self._buf):
            b.seed(None if seed is None else seed + i)

    def add(
        self,
        data: Union[ReplayBuffer, Dict[str, np.ndarray]],
        indices: Optional[Sequence[int]] = None,
        validate_args: bool = False,
    ) -> None:
        if isinstance(data, ReplayBuffer):
            data = data.buffer
        if indices is None:
            indices = tuple(range(self._n_envs))
        elif len(indices) != next(iter(data.values())).shape[1]:
            raise ValueError(
                f"The length of 'indices' ({len(indices)}) must equal the envs dim of 'data' "
                f"({next(iter(data.values())).shape[1]})"
            )
        for data_idx, env_idx in enumerate(indices):
            env_data = {k: v[:, data_idx : data_idx + 1] for k, v in data.items()}
            self._buf[env_idx].add(env_data, validate_args=validate_args)

    def sample(
        self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1, **kwargs: Any
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        bs_per_buf = np.bincount(self._rng.integers(0, self._n_envs, (batch_size,)))
        per_buf = [
            b.sample(batch_size=bs, sample_next_obs=sample_next_obs, clone=clone, n_samples=n_samples, **kwargs)
            for b, bs in zip(self._buf, bs_per_buf)
            if bs > 0
        ]
        return {k: np.concatenate([s[k] for s in per_buf], axis=self._concat_along_axis) for k in per_buf[0]}

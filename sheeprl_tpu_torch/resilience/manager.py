"""CheckpointManager: the checkpoint path of the port's training loops.

Counterpart of ``sheeprl_tpu/resilience/manager.py:CheckpointManager``:

- cadence: every ``checkpoint.every`` policy steps, and the last iteration
  when ``checkpoint.save_last``;
- the state is brought to the host (torch tensors to numpy), refused when
  the agent's parameters are not finite (unless
  ``checkpoint.allow_nonfinite``), written as a ``sheeprl_tpu_ckpt_v1``
  file and the oldest files beyond ``checkpoint.keep_last`` removed.  As in
  the JAX package the finiteness check reads ``"agent"``, the key of the
  PPO, SAC and DroQ states; DreamerV3's and Plan2Explore's keep their
  models under top-level keys (``world_model``, ``actor_task``,
  ``critics_exploration``, ``ensembles``, ...), which it does not read;
- a replay buffer under ``"rb"`` is written in the JAX package's layout
  (``utils/callback.py:_materialize_rb``), its newest row of every env
  marked truncated in the saved copy only (``_ckpt_rb``), so that a resumed
  run never samples across the episode that was in flight;
  :func:`restore_buffer` builds it back, and the JAX package's
  ``restore_buffer`` reads it;
- ``checkpoint.async_save`` writes synchronously: the background writer
  waits for ROADMAP A2.  ``checkpoint.sharded`` (ROADMAP A5) and
  ``checkpoint.device_digests`` (ROADMAP A6) raise.  The preemption
  handler (a forced save on SIGTERM) waits for ROADMAP A6.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.utils.ckpt_format import CheckpointCorruptError, save_state, validate_checkpoint

__all__ = ["CheckpointManager", "NonFiniteCheckpointError", "materialize_rb", "restore_buffer", "to_host"]


class NonFiniteCheckpointError(RuntimeError):
    """A save refused because the agent's parameters hold NaN or inf."""

    def __init__(self, path: str, bad_leaves):
        self.path = str(path)
        self.bad_leaves = list(bad_leaves)
        super().__init__(
            f"refusing to save non-finite params to {self.path}: offending leaves {self.bad_leaves[:5]}; "
            "set checkpoint.allow_nonfinite=true only to capture a post-mortem snapshot on purpose"
        )


def to_host(tree: Any) -> Any:
    """``tree`` with every tensor as a numpy array (copied off the device)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _ckpt_rb(rb) -> list:
    """Mark the newest row of every env truncated (``_ckpt_rb``); returns
    what :func:`_restore_rb` puts back."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer

    if isinstance(rb, ReplayBuffer):
        if rb.empty or "truncated" not in rb.buffer:
            return []
        saved = np.copy(rb.buffer["truncated"][rb._pos - 1])
        rb.buffer["truncated"][rb._pos - 1, :] = True
        return [(rb, saved)]
    if isinstance(rb, EnvIndependentReplayBuffer):
        return [s for sub in rb.buffer for s in _ckpt_rb(sub)]
    return []


def _restore_rb(restore: list) -> None:
    for rb, saved in restore:
        rb.buffer["truncated"][rb._pos - 1] = saved


def materialize_rb(rb) -> Dict[str, Any]:
    """A copy of a replay buffer's contents in the JAX package's checkpoint
    layout (``{"kind": "replay" | "env_independent", ...}``)."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer

    if isinstance(rb, ReplayBuffer):
        return {
            "kind": "replay",
            "cls": type(rb).__name__,
            "buffer_size": rb.buffer_size,
            "n_envs": rb.n_envs,
            "obs_keys": rb._obs_keys,
            "pos": rb._pos,
            "full": rb._full,
            "data": {k: np.array(v) for k, v in rb.buffer.items()},
        }
    if isinstance(rb, EnvIndependentReplayBuffer):
        return {
            "kind": "env_independent",
            "buffer_size": rb.buffer_size,
            "n_envs": rb.n_envs,
            "sub": [materialize_rb(b) for b in rb.buffer],
        }
    raise TypeError(f"{type(rb).__name__} is not a checkpointable replay buffer")


def restore_buffer(saved: Dict[str, Any]):
    """The buffer of a checkpoint's ``"rb"`` (``utils/callback.py:restore_buffer``)."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer

    if saved["kind"] == "replay":
        cls = SequentialReplayBuffer if saved["cls"] == "SequentialReplayBuffer" else ReplayBuffer
        rb = cls(saved["buffer_size"], saved["n_envs"], obs_keys=tuple(saved["obs_keys"]))
        if saved["data"]:
            rb.add(dict(saved["data"]))
            rb._pos = int(saved["pos"])
            rb._full = bool(saved["full"])
            for k, v in saved["data"].items():
                rb.buffer[k][:] = v
        return rb
    if saved["kind"] == "env_independent":
        rb = EnvIndependentReplayBuffer(
            saved["buffer_size"], saved["n_envs"], buffer_cls=SequentialReplayBuffer
        )
        rb._buf = [restore_buffer(s) for s in saved["sub"]]
        return rb
    raise ValueError(f"Unknown buffer kind: {saved.get('kind')}")


def _nonfinite_leaves(tree: Any, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _nonfinite_leaves(v, f"{prefix}/{k}")]
    arr = np.asarray(tree) if isinstance(tree, (np.ndarray, np.generic)) else None
    return [prefix] if arr is not None and arr.dtype.kind == "f" and not np.isfinite(arr).all() else []


class CheckpointManager:
    def __init__(self, runtime, cfg, log_dir: Optional[str], last_checkpoint: int = 0):
        ckpt_cfg = cfg.checkpoint
        if ckpt_cfg.get("sharded", False):
            raise NotImplementedError("checkpoint.sharded (per-shard checkpoint directories) waits for ROADMAP A5")
        if ckpt_cfg.get("device_digests", False):
            raise NotImplementedError("checkpoint.device_digests (manifest digests on the device) waits for ROADMAP A6")
        self._runtime = runtime
        self.every = int(ckpt_cfg.every)
        self.save_last = bool(ckpt_cfg.save_last)
        self.keep_last = ckpt_cfg.get("keep_last")
        self.allow_nonfinite = bool(ckpt_cfg.get("allow_nonfinite", False))
        self.log_dir = log_dir
        self.last_checkpoint = int(last_checkpoint)

    def should_checkpoint(self, policy_step: int, is_last: bool = False) -> bool:
        """The cadence check (pure: ``last_checkpoint`` advances in
        :meth:`checkpoint_now`)."""
        return (self.every > 0 and policy_step - self.last_checkpoint >= self.every) or (is_last and self.save_last)

    def ckpt_path(self, policy_step: int) -> str:
        return os.path.join(self.log_dir or ".", "checkpoint", f"ckpt_{policy_step}_{self._runtime.global_rank}.ckpt")

    def maybe_checkpoint(
        self, *, policy_step: int, is_last: bool, state_fn: Callable[[], Dict[str, Any]]
    ) -> Optional[str]:
        """The per-iteration call: the path written, or None."""
        if not self.should_checkpoint(policy_step, is_last):
            return None
        return self.checkpoint_now(policy_step=policy_step, state_fn=state_fn)

    def checkpoint_now(self, *, policy_step: int, state_fn: Callable[[], Dict[str, Any]]) -> str:
        self.last_checkpoint = policy_step
        path = self.ckpt_path(policy_step)
        state = state_fn()
        restore = _ckpt_rb(state["rb"]) if "rb" in state else []
        try:
            host_state = to_host({k: materialize_rb(v) if k == "rb" else v for k, v in state.items()})
        finally:
            _restore_rb(restore)
        if not self.allow_nonfinite and "agent" in host_state:
            bad = _nonfinite_leaves(host_state["agent"])
            if bad:
                raise NonFiniteCheckpointError(path, bad)
        save_state(path, host_state)
        if self.keep_last:
            self._delete_old_checkpoints(Path(path).parent)
        return path

    def _delete_old_checkpoints(self, folder: Path) -> None:
        """Keep the newest ``keep_last`` files, never deleting the newest
        valid one (a resume must have something to land on)."""
        ckpts = sorted(folder.glob("ckpt_*.ckpt"), key=os.path.getmtime)
        keep = int(self.keep_last)
        if len(ckpts) <= keep:
            return
        kept, candidates = ckpts[-keep:], ckpts[:-keep]
        spare = None
        if not any(self._is_valid(c) for c in kept):
            spare = next((c for c in reversed(candidates) if self._is_valid(c)), None)
        for c in candidates:
            if c != spare:
                c.unlink(missing_ok=True)

    @staticmethod
    def _is_valid(path: Path) -> bool:
        try:
            validate_checkpoint(path)
            return True
        except CheckpointCorruptError:
            return False

    def close(self) -> None:
        """End of run: every write is already on disk (they are synchronous)."""

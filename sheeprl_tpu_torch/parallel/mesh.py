"""The port's runtime: the device, the shards of its mesh, a dtype policy and
the seed.

Counterpart of ``sheeprl_tpu/parallel/mesh.py:MeshRuntime``.  ``devices=N``
(``fabric.devices``) gives a mesh of N shards, as JAX's mesh of N devices
gives N batch shards on its ``data`` axis; the port places all N shards on
the runtime's one device, as the JAX package's CPU tests place 8 devices on
one host (``--xla_force_host_platform_device_count``).  Each shard keeps its
own slice of the env-sharded replay (``data/device_buffer.py``) and the
shards' work runs one after another; collectives are sums and maxima over
the shards in shard order (``parallel/sharding.py``).  So ``shard_batch``
places nothing: every shard already sees the one device.  A mesh over more
than one physical device raises: it waits for the multi-card DDP slice,
which also brings ``fabric.strategy`` (FSDP) to the port.

Precision ``32-true`` (the default) computes in f32 and turns TF32 off for
matmuls and cuDNN convolutions (cuDNN convolutions default to TF32, which
keeps about three decimal digits); ``bf16-mixed``/``bf16-true`` compute in
bf16 with f32 parameters.
"""

from __future__ import annotations

import random
import sys
from typing import Any, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.utils.utils import resolve_device

__all__ = ["MeshRuntime"]

_PRECISIONS = ("32-true", "bf16-mixed", "bf16-true")


class MeshRuntime:
    def __init__(
        self,
        device: Any = None,
        precision: str = "32-true",
        seed: Optional[int] = None,
        *,
        devices: int = 1,
    ):
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}, got '{precision}'")
        if isinstance(device, (list, tuple)):
            physical = {(d.type, d.index or 0): d for d in map(resolve_device, device)}
            if len(physical) != 1:
                raise NotImplementedError(
                    f"a mesh over {len(physical)} devices waits for the multi-card DDP slice; "
                    "the port places every shard on one device"
                )
            device = next(iter(physical.values()))
        if int(devices) < 1:
            raise ValueError(f"devices must be a positive shard count, got {devices}")
        self.device = resolve_device(device)
        self.precision = precision
        self.seed = None if seed is None else int(seed)
        self._n_shards = int(devices)
        self._launched = False

    # ------------------------------------------------------------------ mesh
    @property
    def device_count(self) -> int:
        """The mesh's shard count (JAX's device count)."""
        return self._n_shards

    @property
    def world_size(self) -> int:
        """The number of batch shards, by which SAC's ``per_rank_batch_size``
        is scaled to the batch of one gradient step: every shard of the mesh."""
        return self._n_shards

    def shard_batch(self, batch: Any, axis: int = 0) -> Any:
        """JAX places ``batch`` split over the shards on ``axis``; every shard
        here sees the one device, so the batch stays as it is.  Each tensor's
        ``axis`` must divide over the shards, as in JAX."""
        for v in (batch.values() if isinstance(batch, dict) else [batch]):
            if v.shape[axis] % self._n_shards:
                raise ValueError(f"batch axis {axis} of size {v.shape[axis]} does not divide over {self._n_shards} shards")
        return batch

    # ---------------------------------------------------------------- policy
    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32 if self.precision == "32-true" else torch.bfloat16

    def launch(self) -> "MeshRuntime":
        if self._launched:
            return self
        if self.precision == "32-true":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            print(
                "MeshRuntime: precision 32-true: TF32 off for matmuls and cuDNN convolutions",
                file=sys.stderr,
            )
        if self.seed is not None:
            self.seed_everything(self.seed)
        self._launched = True
        return self

    def seed_everything(self, seed: int) -> None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
        self.seed = int(seed)

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

The runtime takes the ``fabric`` config node as it stands
(``_target_: sheeprl_tpu_torch.parallel.mesh.MeshRuntime``):
``accelerator`` ``cpu`` runs on the CPU, ``auto``/``gpu``/``cuda`` on the
card (and raises without one); more than one node, a ``strategy`` other
than DDP and an explicit ``mesh_shape`` raise (ROADMAP A5).  The JAX
runtime's player knobs (``player_device``, ``player_params_cutoff_mb``) are
not in the port's ``fabric`` node: its players act on the runtime's device.
``generator`` is the run's ``torch.Generator`` on that device, seeded by
``seed_everything`` (the JAX runtime's key stream).
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
# fabric.accelerator -> device (None: the default device, the card)
_ACCELERATORS = {"auto": None, "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


class MeshRuntime:
    def __init__(
        self,
        device: Any = None,
        precision: str = "32-true",
        seed: Optional[int] = None,
        *,
        devices: int = 1,
        accelerator: Optional[str] = None,
        num_nodes: int = 1,
        strategy: str = "auto",
        mesh_shape: Any = "auto",
    ):
        if accelerator is not None and device is None:
            device = _ACCELERATORS.get(str(accelerator).lower(), "unknown")
            if device == "unknown":
                raise ValueError(f"fabric.accelerator must be one of {sorted(_ACCELERATORS)}, got '{accelerator}'")
        if int(num_nodes) != 1 or str(strategy) not in ("auto", "dp", "ddp") or str(mesh_shape) != "auto":
            raise NotImplementedError(
                f"num_nodes={num_nodes}, strategy='{strategy}', mesh_shape='{mesh_shape}': multi-node runs, FSDP "
                "and explicit mesh shapes wait for ROADMAP A5"
            )
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
        self.generator = torch.Generator(device=self.device)
        if self.seed is not None:
            self.generator.manual_seed(self.seed)

    # ------------------------------------------------------------ processes
    # one process drives the one device: rank 0 of a world of one process
    is_global_zero = True
    global_rank = 0

    def print(self, *args, **kwargs) -> None:
        """``print`` on the global rank zero (the only process here)."""
        print(*args, **kwargs)

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
        self.generator.manual_seed(int(seed))
        self.seed = int(seed)

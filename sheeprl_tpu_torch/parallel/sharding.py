"""The shard vocabulary of the env-sharded replay (counterpart of part of
``sheeprl_tpu/parallel/sharding.py``).

The JAX package lays its devices out as a 2-D ``("data", "fsdp")`` mesh and
splits batches and replay env columns over both axes together; inside a
``shard_map`` body a device finds its shard as ``data_idx * fsdp +
fsdp_idx`` and reduces across shards with ``jax.lax.psum``/``pmax``.  The
port's shard index is its place in the shard list.  The port runs every shard of a mesh on one
device, one after another (``parallel/mesh.py``), so a collective is a sum
or a maximum over the list of the shards' values, taken in shard order:
the result does not depend on timing.

The axis names, the layouts, the FSDP parameter specs and the ``shard_map``
DDP core wait for the multi-card slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["pmax", "psum"]

def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jax.lax.psum`` over the shards: the sum of the per-shard tensors,
    added in shard order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jax.lax.pmax`` over the shards: the elementwise maximum of the
    per-shard tensors."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out

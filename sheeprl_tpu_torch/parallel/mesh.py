"""The port's runtime: one device, a dtype policy and the seed.

Counterpart of ``sheeprl_tpu/parallel/mesh.py:MeshRuntime`` for one card:
the device mesh, multi-host rendezvous and player placement wait for the
multi-GPU slice.

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
    def __init__(self, device: Any = None, precision: str = "32-true", seed: Optional[int] = None):
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}, got '{precision}'")
        self.device = resolve_device(device)
        self.precision = precision
        self.seed = None if seed is None else int(seed)
        self._launched = False

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

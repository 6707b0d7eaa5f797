"""Small tensor helpers (counterpart of ``sheeprl_tpu/utils/utils.py``)."""

from __future__ import annotations

import torch

__all__ = ["symlog", "resolve_device"]


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Without a card, asking for ``cuda`` (or nothing) raises:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sheeprl_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev

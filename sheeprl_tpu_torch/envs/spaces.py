"""Space descriptors of the port's envs (the card's machine has no gymnasium).

Counterpart of the ``gym.spaces`` that ``sheeprl_tpu/envs/jax/classic.py``
uses only as descriptors: :class:`Box`, :class:`Discrete`,
:class:`MultiDiscrete` and :class:`Dict`, with what the loops read
(``shape``, ``dtype``, ``low``/``high``, ``n``, ``nvec`` and the keys),
and ``sample(n, generator)``: ``n`` seeded draws on the generator's device,
the counterpart of ``envs.action_space.sample()`` in the JAX package's
off-policy warm-ups (uniform over a bounded ``Box``, uniform integers
otherwise).
"""

from __future__ import annotations

from typing import Dict as TDict, Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = ["Box", "Dict", "Discrete", "MultiDiscrete", "action_space_dims"]


class Box:
    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def sample(self, n: int, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
        """(n, *shape) float32 draws, uniform over the box."""
        if not (np.isfinite(self.low).all() and np.isfinite(self.high).all()):
            raise NotImplementedError("sampling an unbounded Box is not ported (no port env acts in one)")
        low = torch.as_tensor(self.low, dtype=torch.float32, device=device)
        high = torch.as_tensor(self.high, dtype=torch.float32, device=device)
        u = torch.rand((n, *self.shape), generator=generator, device=device, dtype=torch.float32)
        return low + (high - low) * u

    def __repr__(self) -> str:
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"


class Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def sample(self, n: int, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
        """(n,) int64 draws in [0, n)."""
        return torch.randint(0, self.n, (n,), generator=generator, device=device)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete:
    def __init__(self, nvec: Sequence[int]):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = self.nvec.shape
        self.dtype = np.dtype(np.int64)

    def sample(self, n: int, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
        """(n, *nvec.shape) int64 draws, each below its ``nvec``."""
        nvec = torch.as_tensor(self.nvec, device=device)
        u = torch.rand((n, *self.shape), generator=generator, device=device, dtype=torch.float64)
        return torch.minimum((u * nvec).to(torch.int64), nvec - 1)

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class Dict:
    def __init__(self, spaces: TDict[str, object]):
        self.spaces = dict(spaces)

    def __getitem__(self, key: str):
        return self.spaces[key]

    def __contains__(self, key: str) -> bool:
        return key in self.spaces

    def __iter__(self) -> Iterator[str]:
        return iter(self.spaces)

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def __repr__(self) -> str:
        return f"Dict({self.spaces})"


def action_space_dims(space):
    """(actions_dim, is_continuous) of an action space."""
    if isinstance(space, Box):
        return tuple(space.shape), True
    if isinstance(space, MultiDiscrete):
        return tuple(space.nvec.tolist()), False
    return (space.n,), False

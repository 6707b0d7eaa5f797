"""Space descriptors of the port's envs (the card's machine has no gymnasium).

Counterpart of the ``gym.spaces`` that ``sheeprl_tpu/envs/jax/classic.py``
uses only as descriptors: :class:`Box`, :class:`Discrete`,
:class:`MultiDiscrete` and :class:`Dict`, with what the loops read
(``shape``, ``dtype``, ``low``/``high``, ``n``, ``nvec`` and the keys).
Nothing here samples.
"""

from __future__ import annotations

from typing import Dict as TDict, Iterator, Optional, Sequence

import numpy as np

__all__ = ["Box", "Dict", "Discrete", "MultiDiscrete"]


class Box:
    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def __repr__(self) -> str:
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"


class Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete:
    def __init__(self, nvec: Sequence[int]):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = self.nvec.shape
        self.dtype = np.dtype(np.int64)

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

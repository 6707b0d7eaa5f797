"""Device-resident binary sum-tree for proportional prioritized replay.

Counterpart of ``sheeprl_tpu/replay/priority_tree.py``.  Prioritized
Experience Replay (Schaul et al., 2016) samples transition i with
probability p_i^alpha / sum p^alpha and corrects the bias with
importance-sampling weights w_i = (N P(i))^-beta.  The tree is one flat
(2P,) f32 tensor on the card beside the replay rings: index 0 unused, the
root (total mass) at 1, leaves at [P, 2P), P the leaf count padded to a
power of two.

``kernel`` is ``buffer.per_kernel``, with its JAX meaning:

- ``lax``: the plain tree functions.  JAX's ``_write_impl``/``_tree_write``,
  ``_tree_update`` and ``_descend``/``_tree_sample`` compute exactly what
  the kernels' plain versions in ``ops/per.py`` compute (a descent without
  exclusions is op for op the corrected one), so the port has them once,
  there; what is the lax path's own is :func:`_tree_zeroed`: a draw with
  exclusions descends a copy of the tree with the excluded leaves zeroed;
- ``pallas``: the hand-written kernels of ``ops/per.py`` (exclusions folded
  into the descent; on the CPU their plain versions).

Writes are in place on :attr:`PriorityTree.tree`.  A leaf written by several
active lanes of one call takes the last lane's value; parents are rebuilt
from the final children, so the tree stays consistent.

The env-sharded tree of multi-device meshes waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.ops.per import (
    owner_scratch,
    sum_tree_sample,
    sum_tree_sample_plain,
    sum_tree_update,
    sum_tree_update_plain,
    sum_tree_write,
    sum_tree_write_plain,
)
from sheeprl_tpu_torch.utils.utils import resolve_device

__all__ = [
    "PriorityTree",
    "ShardedPriorityTree",
    "per_beta_schedule",
    "priority_from_td",
    "resolve_per_kernel",
    "shard_proportional_draw",
]


def resolve_per_kernel(value) -> str:
    """Validate ``buffer.per_kernel``: ``lax`` or ``pallas``."""
    s = str(value).lower()
    if s not in ("lax", "pallas"):
        raise ValueError(f"buffer.per_kernel must be 'lax' or 'pallas', got {value!r}")
    return s


def priority_from_td(td_abs, alpha: float, eps: float):
    """Schaul proportional priority: (|delta| + eps)^alpha (tensors or numpy)."""
    return (abs(td_abs) + eps) ** alpha


def per_beta_schedule(beta0: float, beta_end: float, total_steps: int):
    """Linear beta annealing from ``beta0`` to ``beta_end`` over
    ``total_steps``: ``step -> beta`` on host floats."""
    beta0 = float(beta0)
    beta_end = float(beta_end)
    span = max(int(total_steps), 1)

    def beta(step: int) -> float:
        frac = min(max(float(step) / span, 0.0), 1.0)
        return beta0 + (beta_end - beta0) * frac

    return beta


def _tree_zeroed(tree: torch.Tensor, leaf_idx, active, depth: int) -> torch.Tensor:
    """A copy of ``tree`` with ``leaf_idx`` zeroed where ``active``: the
    sampling-time exclusions of the lax path (``priority_tree.py:100``).
    ``tree`` is untouched."""
    leaf = torch.as_tensor(leaf_idx, device=tree.device).reshape(-1)
    return sum_tree_write_plain(tree.clone(), leaf, torch.zeros(leaf.shape, device=tree.device), active, depth=depth)


class PriorityTree:
    """The sum-tree over ``n_leaves`` cells and the running max priority.

    The cache maps cell ``(row, env)`` to leaf ``row * n_envs + env``.
    ``max_priority`` stays a 0-d tensor on the device: seeding and TD
    updates never wait for the host.  The tree lives on ``cuda`` unless the
    caller names another device."""

    def __init__(
        self,
        n_leaves: int,
        *,
        alpha: float = 0.6,
        eps: float = 1e-6,
        device=None,
        initial_priority: float = 1.0,
        kernel: str = "lax",
    ):
        if n_leaves <= 0:
            raise ValueError(f"n_leaves must be positive, got {n_leaves}")
        self.n_leaves = int(n_leaves)
        self.alpha = float(alpha)
        self.eps = float(eps)
        self.kernel = resolve_per_kernel(kernel)
        self.depth = max(int(self.n_leaves - 1).bit_length(), 1)
        self.device = resolve_device(device)
        self.tree = torch.zeros(2 << self.depth, dtype=torch.float32, device=self.device)
        self.max_priority = torch.tensor(float(initial_priority), dtype=torch.float32, device=self.device)
        self._owner: Optional[torch.Tensor] = None  # the kernel writes' scratch, made at the first one

    def _idx(self, leaf_idx) -> torch.Tensor:
        return torch.as_tensor(leaf_idx, device=self.device).reshape(-1).to(torch.int64)

    def _mask(self, active, like: torch.Tensor) -> torch.Tensor:
        if active is None:
            return torch.ones(like.shape, dtype=torch.bool, device=self.device)
        return torch.as_tensor(active, device=self.device).reshape(like.shape).to(torch.bool)

    # ------------------------------------------------------------- write
    def _scratch(self) -> Optional[torch.Tensor]:
        if self._owner is None and self.device.type == "cuda":
            self._owner = owner_scratch(self.depth, self.device)
        return self._owner

    def _write_tree(self, leaf_idx: torch.Tensor, values: torch.Tensor, active: torch.Tensor) -> None:
        if self.kernel == "pallas":
            sum_tree_write(self.tree, leaf_idx, values, active, depth=self.depth, owner=self._scratch())
        else:
            sum_tree_write_plain(self.tree, leaf_idx, values, active, depth=self.depth)

    def seed_max(self, leaf_idx, active) -> None:
        """New cells enter at the running max priority, so that every
        transition is trained on at least once (Schaul 3.3)."""
        leaf = self._idx(leaf_idx)
        self._write_tree(leaf, self.max_priority.expand(leaf.shape), self._mask(active, leaf))

    def update(self, leaf_idx, td_abs, active=None) -> None:
        """TD-error feedback: p = (|delta| + eps)^alpha, and the running max."""
        leaf = self._idx(leaf_idx)
        pri = priority_from_td(
            torch.as_tensor(td_abs, device=self.device).to(torch.float32).reshape(leaf.shape), self.alpha, self.eps
        )
        if self.kernel == "pallas":
            self.max_priority = sum_tree_update(
                self.tree, self.max_priority, leaf, pri, self._mask(active, leaf), depth=self.depth, owner=self._scratch()
            )
        else:
            self.max_priority = sum_tree_update_plain(
                self.tree, self.max_priority, leaf, pri, self._mask(active, leaf), depth=self.depth
            )

    def scale(self, leaf_idx, factor: float) -> None:
        """Multiply the priorities at ``leaf_idx`` by ``factor``; a leaf given
        twice is scaled once (gather, then write)."""
        leaf = self._idx(leaf_idx)
        vals = self.priorities(leaf) * torch.tensor(float(factor), dtype=torch.float32)
        self._write_tree(leaf, vals, self._mask(None, leaf))

    def set_priorities(self, leaf_idx, priorities, active=None) -> None:
        """Raw priority write (restore path, tests)."""
        leaf = self._idx(leaf_idx)
        vals = torch.as_tensor(priorities, device=self.device).reshape(leaf.shape).to(torch.float32)
        self._write_tree(leaf, vals, self._mask(active, leaf))

    # ------------------------------------------------------------- read
    def sample(
        self,
        n: int,
        *,
        beta: float,
        count,
        exclude_idx=None,
        exclude_active=None,
        generator: Optional[torch.Generator] = None,
        r01: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n`` leaves drawn proportional to priority, and their IS weights.

        ``r01`` are the n uniforms in [0, 1) (by default drawn from
        ``generator``).  ``exclude_idx``/``exclude_active`` leave those cells
        out of this draw: the stored priorities survive.  ``pallas`` needs
        the excluded leaves distinct where active (every caller's are)."""
        if r01 is None:
            r01 = torch.rand((int(n),), generator=generator, device=self.device)
        r01 = r01.to(self.device, torch.float32).reshape(-1)
        if r01.numel() != int(n):
            raise ValueError(f"{r01.numel()} uniforms for {n} draws")
        if self.kernel == "pallas":
            return sum_tree_sample(
                self.tree, r01, beta, count, depth=self.depth, exclude_idx=exclude_idx, exclude_active=exclude_active
            )
        tree = self.tree
        if exclude_idx is not None:
            ex = self._idx(exclude_idx)
            tree = _tree_zeroed(tree, ex, self._mask(exclude_active, ex), self.depth)
        return sum_tree_sample_plain(tree, r01, beta, count, depth=self.depth)

    def priorities(self, leaf_idx) -> torch.Tensor:
        return self.tree[self._idx(leaf_idx) + (1 << self.depth)]

    @property
    def total(self) -> float:
        return float(self.tree[1])

    # ------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        """Leaf priorities and the running max as host numpy (internal nodes
        are derived state)."""
        p = 1 << self.depth
        return {
            "leaves": self.tree[p : p + self.n_leaves].cpu().numpy(),
            "max_priority": self.max_priority.cpu().numpy(),
            "alpha": self.alpha,
            "eps": self.eps,
        }

    def load_state_dict(self, state: dict) -> None:
        leaves = np.asarray(state["leaves"], np.float32)
        if leaves.shape[0] != self.n_leaves:
            raise ValueError(f"priority state has {leaves.shape[0]} leaves, tree expects {self.n_leaves}")
        p = 1 << self.depth
        full = np.zeros(2 << self.depth, np.float32)
        full[p : p + self.n_leaves] = leaves
        # rebuild the internal nodes level by level, as the JAX package's host loop does node by node
        lo = p
        while lo > 1:
            full[lo // 2 : lo] = full[lo : 2 * lo : 2] + full[lo + 1 : 2 * lo : 2]
            lo //= 2
        self.tree = torch.from_numpy(full).to(self.device)
        self.max_priority = torch.tensor(float(state["max_priority"]), dtype=torch.float32, device=self.device)


def shard_proportional_draw(*args, **kwargs):
    raise NotImplementedError("the env-sharded prioritized draw is not ported yet: it comes with the multi-GPU slice")


class ShardedPriorityTree:
    """The env-sharded sum-tree of multi-device meshes: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ShardedPriorityTree is not ported yet: it comes with the multi-GPU slice")

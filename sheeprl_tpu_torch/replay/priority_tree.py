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

The env-sharded tree of a mesh of N shards (:class:`ShardedPriorityTree`):
each shard owns a sub-tree over its env columns' cells, the sub-trees are the
rows of one (N, 2P) tensor on the runtime's device, and a draw places every
shard's mass interval in the global CDF (:func:`shard_proportional_draw`).
JAX runs the shards' bodies inside ``shard_map`` on its devices; the port
runs them one after another on one device, each shard's descent and write a
launch of kernels #8 and #9 (``pallas``) on its own row, and its collectives
are sums and maxima over the shards in shard order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.ops.per import (
    draw_scratch,
    owner_scratch,
    sum_tree_descend,
    sum_tree_descend_plain,
    sum_tree_sample,
    sum_tree_sample_plain,
    sum_tree_scatter,
    sum_tree_scatter_plain,
    sum_tree_update,
    sum_tree_update_plain,
    sum_tree_write,
    sum_tree_write_plain,
)
from sheeprl_tpu_torch.parallel.sharding import pmax, psum
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


def _count(idx) -> int:
    """How many leaves ``idx`` (None, a tensor or an array) names."""
    if idx is None:
        return 0
    return idx.numel() if isinstance(idx, torch.Tensor) else int(np.size(idx))


def _tree_zeroed(tree: torch.Tensor, leaf_idx, active, depth: int) -> torch.Tensor:
    """A copy of ``tree`` with ``leaf_idx`` zeroed where ``active``: the
    sampling-time exclusions of the lax path (``priority_tree.py:100``).
    ``tree`` is untouched."""
    leaf = torch.as_tensor(leaf_idx, device=tree.device).reshape(-1)
    return sum_tree_write_plain(tree.clone(), leaf, torch.zeros(leaf.shape, device=tree.device), active, depth=depth)


def _tree_zeroed_local(tree: torch.Tensor, leaf_idx, depth: int) -> torch.Tensor:
    """:func:`_tree_zeroed` of one shard's sub-tree with every lane active
    (``priority_tree.py:122``): the lax path's exclusions inside a shard's
    draw."""
    leaf = torch.as_tensor(leaf_idx, device=tree.device).reshape(-1)
    return _tree_zeroed(tree, leaf, torch.ones(leaf.shape, dtype=torch.bool, device=tree.device), depth)


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
        self._draws: Optional[torch.Tensor] = None  # the kernel draws' scratch, made at the first one
        self._draws_room = 0  # the exclusions it has room for

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

    def draw_scratch(self, n_excl: int) -> torch.Tensor:
        """The draw kernels' scratch (``ops/per.py:draw_scratch``) with room
        for ``n_excl`` exclusions: kept, and made anew only when it is too
        small."""
        if self._draws is None or n_excl > self._draws_room:
            self._draws = draw_scratch(self.depth, n_excl, self.device)
            self._draws_room = n_excl
        return self._draws

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
        elif r01.dim() != 1 or r01.dtype != torch.float32 or r01.device.type != self.device.type:
            r01 = r01.to(self.device, torch.float32).reshape(-1)
        if r01.numel() != int(n):
            raise ValueError(f"{r01.numel()} uniforms for {n} draws")
        if self.kernel == "pallas":
            n_excl = _count(exclude_idx)
            return sum_tree_sample(
                self.tree, r01, beta, count, depth=self.depth, exclude_idx=exclude_idx, exclude_active=exclude_active,
                scratch=self.draw_scratch(n_excl) if self.device.type == "cuda" else None,
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


# --------------------------------------------------------------------- sharded
_ONE_LESS_ULP = torch.tensor(1.0 - 1e-7, dtype=torch.float32)  # JAX's f32(1 - 1e-7)
_ONE_LESS_ON = {}  # its copy on each device, made once (a copy from the host waits for the stream)


def _one_less(device: torch.device) -> torch.Tensor:
    t = _ONE_LESS_ON.get(device)
    if t is None:
        t = _ONE_LESS_ON[device] = _ONE_LESS_ULP.to(device)
    return t


def shard_proportional_draw(
    trees: Sequence[torch.Tensor],
    r01: torch.Tensor,
    *,
    depth: int,
    kernel: str = "lax",
    exclude_idx: Optional[Sequence] = None,
    exclude_active: Optional[Sequence] = None,
    scratch: Optional[torch.Tensor] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Globally proportional draw from per-shard sub-trees
    (``priority_tree.py:331-399``), every shard's body in shard order.

    ``trees`` are the shards' sub-trees (the rows of
    :attr:`ShardedPriorityTree.trees`), ``r01`` the n uniforms that every
    shard draws (JAX's ``uniform(key, (n,))``, the key not folded with the
    rank).  The global mass space is the shards' masses side by side: their
    sum in shard order (JAX's one ``psum``) places each shard's interval,
    each shard descends its own sub-tree for all n draws and owns the draws
    whose ``u`` falls in its interval, so each draw has exactly one owner and
    the marginals are a single global tree's.

    Returns, for each shard, ``(local_leaf, mass, own, total)``: the
    shard-local leaf and its mass for all n draws (meaningless where ``own``
    is False), the ownership mask and the global total mass.

    ``kernel="pallas"`` descends through kernel #8 (``sum_tree_descend``)
    with the shard-local exclusions ``exclude_idx[r]`` (``exclude_active[r]``)
    folded into the descent, every shard's descent through one ``scratch``
    (``ShardedPriorityTree.draw_scratch``; they run one after another on one
    stream); the lax path takes no exclusions (its caller zeroes them in a
    copy of the sub-tree, :func:`_tree_zeroed_local`)."""
    n_shards = len(trees)
    device = trees[0].device
    one_less = _one_less(device)
    excl = [None] * n_shards if exclude_idx is None else list(exclude_idx)
    eact = [None] * n_shards if exclude_active is None else list(exclude_active)
    if kernel == "pallas":
        m_local = []
        for r, tree in enumerate(trees):
            if excl[r] is None:
                m_local.append(tree[1])
                continue
            e = torch.as_tensor(excl[r], device=device).reshape(-1).long()
            emass = tree[e + (1 << depth)]
            if eact[r] is not None:
                a = torch.as_tensor(eact[r], device=device).reshape(e.shape).bool()
                emass = torch.where(a, emass, torch.zeros((), device=device))
            m_local.append(tree[1] - emass.sum())
    else:
        if exclude_idx is not None:
            raise ValueError("exclude_idx on the lax path: zero the sub-trees instead")
        m_local = [tree[1] for tree in trees]
    masses = torch.stack(m_local)  # JAX's psum of one-hot mass vectors: exact
    prefix = torch.cat([torch.zeros(1, dtype=torch.float32, device=device), torch.cumsum(masses, 0)])
    total = prefix[-1]
    # u == total would fall outside every half-open interval: clamp below 1
    u = torch.minimum(r01.to(device, torch.float32).reshape(-1), one_less) * total
    out = []
    for r, tree in enumerate(trees):
        lo, hi = prefix[r], prefix[r + 1]
        own = (u >= lo) & (u < hi)
        # cumsum rounding can widen a shard's interval past its own mass by an ulp
        u_loc = torch.clamp(u - lo, torch.zeros((), device=device), m_local[r] * one_less)
        if kernel == "pallas":
            leaf, mass = sum_tree_descend(
                tree, u_loc, depth=depth, exclude_idx=excl[r], exclude_active=eact[r], scratch=scratch
            )
        else:
            leaf, mass = sum_tree_descend_plain(tree, u_loc, depth=depth)
        out.append((leaf, mass, own, total))
    return out


class ShardedPriorityTree:
    """The env-sharded counterpart of :class:`PriorityTree` for
    ``ShardedDeviceReplayCache`` (``priority_tree.py:402-614``).

    Shard ``r`` owns the cells of envs ``[r * n_local, (r + 1) * n_local)``
    in a sub-tree whose leaf is ``row * n_local + env_local``; the sub-trees
    are the rows of :attr:`trees`, an (n_shards, 2P) f32 tensor on
    ``device`` (JAX's stacked ``trees``, sharded over the mesh).  A write
    goes to every shard, which writes the lanes it owns (kernel #9 on the
    ``pallas`` path), and the running max takes the maximum of the shards'
    candidates.  The API takes global cell ids, and the checkpoint state is
    in global leaf order, so a sharded run and a single-device run can
    resume each other."""

    def __init__(
        self,
        capacity: int,
        n_envs: int,
        n_shards: int,
        device=None,
        *,
        alpha: float = 0.6,
        eps: float = 1e-6,
        initial_priority: float = 1.0,
        kernel: str = "lax",
    ):
        if n_envs % n_shards:
            raise ValueError(f"n_envs ({n_envs}) must divide over {n_shards} shards")
        self.capacity = int(capacity)
        self.n_envs = int(n_envs)
        self.n_shards = int(n_shards)
        self.n_local_envs = self.n_envs // self.n_shards
        self.n_leaves = self.capacity * self.n_envs
        self.n_leaves_local = self.capacity * self.n_local_envs
        self.alpha = float(alpha)
        self.eps = float(eps)
        self.kernel = resolve_per_kernel(kernel)
        self.depth = max(int(self.n_leaves_local - 1).bit_length(), 1)
        self.device = resolve_device(device)
        self.trees = torch.zeros((self.n_shards, 2 << self.depth), dtype=torch.float32, device=self.device)
        self.max_priority = torch.tensor(float(initial_priority), dtype=torch.float32, device=self.device)
        self._owner: Optional[torch.Tensor] = None  # kernel #9's scratch, made at its first write
        self._draws: Optional[torch.Tensor] = None  # kernel #8's scratch, made at its first pre-pass
        self._draws_room = 0

    # ------------------------------------------------------------- mapping
    def _map_leaves(self, leaf_idx):
        """Global cell id -> (owning shard, shard-local leaf); tensors or numpy."""
        row = leaf_idx // self.n_envs
        env = leaf_idx % self.n_envs
        return env // self.n_local_envs, row * self.n_local_envs + env % self.n_local_envs

    def _idx(self, leaf_idx) -> torch.Tensor:
        return torch.as_tensor(leaf_idx, device=self.device).reshape(-1).to(torch.int64)

    _mask = PriorityTree._mask
    # the shards' scatters run one after another and each leaves the scratch
    # all -1, so one (P,) scratch serves every shard
    _scratch = PriorityTree._scratch
    # likewise one draw scratch serves the shards' descents
    draw_scratch = PriorityTree.draw_scratch

    def _write(self, leaf_idx, values, active, track_max: bool) -> None:
        """Every shard writes the active lanes it owns; with ``track_max`` the
        running max takes the maximum of the shards' candidates (JAX's pmax)."""
        leaf = self._idx(leaf_idx)
        values = torch.as_tensor(values, device=self.device).reshape(leaf.shape).to(torch.float32)
        active = self._mask(active, leaf)
        shard_ids, local_leaf = (t.to(torch.int32) for t in self._map_leaves(leaf))
        owner = self._scratch() if self.kernel == "pallas" else None
        cands = []
        for r in range(self.n_shards):
            if self.kernel == "pallas":
                _, cand = sum_tree_scatter(self.trees[r], local_leaf, values, active, shard_ids, r, depth=self.depth, owner=owner)
            else:
                _, cand = sum_tree_scatter_plain(self.trees[r], local_leaf, values, active, shard_ids, r, depth=self.depth)
            cands.append(cand)
        if track_max:
            self.max_priority = torch.maximum(self.max_priority, pmax(cands))

    # ------------------------------------------------------------- write API
    def seed_max(self, leaf_idx, active) -> None:
        leaf = self._idx(leaf_idx)
        self._write(leaf, self.max_priority.expand(leaf.shape), active, track_max=False)

    def update(self, leaf_idx, td_abs, active=None) -> None:
        leaf = self._idx(leaf_idx)
        pri = priority_from_td(
            torch.as_tensor(td_abs, device=self.device).to(torch.float32).reshape(leaf.shape), self.alpha, self.eps
        )
        self._write(leaf, pri, active, track_max=True)

    def scale(self, leaf_idx, factor: float) -> None:
        leaf = self._idx(leaf_idx)
        vals = self.priorities(leaf) * torch.tensor(float(factor), dtype=torch.float32, device=self.device)
        self._write(leaf, vals, None, track_max=False)

    def set_priorities(self, leaf_idx, priorities, active=None) -> None:
        self._write(self._idx(leaf_idx), priorities, active, track_max=False)

    # ------------------------------------------------------------- read
    def priorities(self, leaf_idx) -> torch.Tensor:
        """Per-cell priorities of global cell ids: each shard contributes the
        cells it owns to one masked sum (JAX's masked psum)."""
        leaf = self._idx(leaf_idx)
        shard_ids, local_leaf = self._map_leaves(leaf)
        node = local_leaf + (1 << self.depth)
        zero = torch.zeros((), device=self.device)
        return psum([torch.where(shard_ids == r, self.trees[r][node], zero) for r in range(self.n_shards)])

    @property
    def total(self) -> float:
        return float(self.trees[:, 1].sum())

    # ------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        """:class:`PriorityTree`'s schema: leaves in global cell order."""
        p = 1 << self.depth
        local = self.trees[:, p : p + self.n_leaves_local].cpu().numpy()
        # (shard, row * n_local + e) -> global order (row, shard, e)
        leaves = local.reshape(self.n_shards, self.capacity, self.n_local_envs).transpose(1, 0, 2).reshape(-1)
        return {
            "leaves": np.ascontiguousarray(leaves),
            "max_priority": self.max_priority.cpu().numpy(),
            "alpha": self.alpha,
            "eps": self.eps,
        }

    def load_state_dict(self, state: dict) -> None:
        leaves = np.asarray(state["leaves"], np.float32)
        if leaves.shape[0] != self.n_leaves:
            raise ValueError(f"priority state has {leaves.shape[0]} leaves, tree expects {self.n_leaves}")
        p = 1 << self.depth
        local = (
            leaves.reshape(self.capacity, self.n_shards, self.n_local_envs)
            .transpose(1, 0, 2)
            .reshape(self.n_shards, self.n_leaves_local)
        )
        full = np.zeros((self.n_shards, 2 << self.depth), np.float32)
        full[:, p : p + self.n_leaves_local] = local
        # rebuild the internal nodes level by level, every shard at once
        lo = p
        while lo > 1:
            full[:, lo // 2 : lo] = full[:, lo : 2 * lo : 2] + full[:, lo + 1 : 2 * lo : 2]
            lo //= 2
        self.trees = torch.from_numpy(full).to(self.device)
        self.max_priority = torch.tensor(float(state["max_priority"]), dtype=torch.float32, device=self.device)

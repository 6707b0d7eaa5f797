"""Procedurally generated gridworld on torch tensors.

Counterpart of ``sheeprl_tpu/envs/jax/gridworld.py`` (``GridWorldJax``),
batched over the env axis like :mod:`.classic`.  Every reset draws a new
maze: a Bernoulli wall grid, a start cell and a goal cell, each cell drawn
as the argmax of ``logits + Gumbel`` over the flat grid with ``-inf`` on
walls (``jax.random.categorical``'s arithmetic, ties to the first index),
the goal's draw also excluding the start.  Both cells are then cleared.

Moves: 4 discrete actions (up, down, left, right); a move into a wall or
off the grid leaves the agent where it was.  Reward ``+1`` on reaching the
goal (terminated), ``-step_cost`` otherwise; episodes truncate at
``max_episode_steps``.  The observation ``"state"`` is the egocentric
``view x view`` wall window (the border reads as wall) followed by the
position and the goal offset, both divided by ``size - 1``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.core import DeviceEnv
from sheeprl_tpu_torch.utils.distribution import gumbel_noise

__all__ = ["GridWorld"]

# action index -> (drow, dcol)
_MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))


class GridWorld(DeviceEnv):
    """State: ``{"walls": (N, S, S) bool, "pos": (N, 2) int32, "goal": (N, 2)
    int32}``.  Reset noise: ``walls`` uniform in [0, 1) (S, S), a wall where
    it is below ``wall_density``; ``start`` and ``goal`` Gumbel (S * S,)."""

    def __init__(
        self,
        size: int = 9,
        view: int = 5,
        wall_density: float = 0.25,
        step_cost: float = 0.01,
        max_episode_steps: int = 128,
    ):
        if view % 2 != 1:
            raise ValueError(f"view must be odd, got {view}")
        self.size = int(size)
        self.view = int(view)
        self.wall_density = float(wall_density)
        self.step_cost = float(step_cost)
        self.max_episode_steps = int(max_episode_steps)
        obs_dim = self.view * self.view + 4
        self.observation_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, shape=(obs_dim,), dtype=np.float32)})
        self.action_space = spaces.Discrete(4)

    def reset_noise(self, n: int, generator: Optional[torch.Generator] = None, device=None):
        cells = self.size * self.size
        like = torch.empty((), dtype=torch.float32, device=device)
        return {
            "walls": torch.rand((n, self.size, self.size), generator=generator, device=device, dtype=torch.float32),
            "start": gumbel_noise((n, cells), like=like, generator=generator),
            "goal": gumbel_noise((n, cells), like=like, generator=generator),
        }

    def _draw_cell(self, gumbel: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
        """(N, 2) int32 cells: argmax over the flat grid of the free cells' Gumbel."""
        scores = torch.where(free, gumbel.float(), torch.full_like(gumbel.float(), -torch.inf))
        flat = torch.argmax(scores, dim=-1)
        return torch.stack([flat // self.size, flat % self.size], -1).to(torch.int32)

    def reset(self, noise):
        n = noise["walls"].shape[0]
        size = self.size
        walls = noise["walls"].float() < self.wall_density
        free = ~walls.reshape(n, size * size)
        start = self._draw_cell(noise["start"], free)
        flat_start = (start[:, 0] * size + start[:, 1]).long()
        cells = torch.arange(size * size, device=free.device)
        goal = self._draw_cell(noise["goal"], free & (cells[None, :] != flat_start[:, None]))
        rows = torch.arange(n, device=free.device)
        walls = walls.clone()
        walls[rows, start[:, 0].long(), start[:, 1].long()] = False
        walls[rows, goal[:, 0].long(), goal[:, 1].long()] = False
        state = {"walls": walls, "pos": start, "goal": goal}
        return state, self._obs(state)

    def _obs(self, state):
        walls, pos, goal = state["walls"], state["pos"], state["goal"]
        n = walls.shape[0]
        pad = self.view // 2
        padded = torch.nn.functional.pad(walls.to(torch.float32), (pad, pad, pad, pad), value=1.0)
        offs = torch.arange(self.view, device=walls.device)
        rows = (pos[:, 0:1].long() + offs)[:, :, None]  # (N, view, 1)
        cols = (pos[:, 1:2].long() + offs)[:, None, :]  # (N, 1, view)
        window = padded[torch.arange(n, device=walls.device)[:, None, None], rows, cols]
        denom = float(max(self.size - 1, 1))
        pos_f = pos.to(torch.float32) / denom
        offset = (goal - pos).to(torch.float32) / denom
        return {"state": torch.cat([window.reshape(n, -1), pos_f, offset], -1).to(torch.float32)}

    def step(self, state, action):
        walls, pos, goal = state["walls"], state["pos"], state["goal"]
        n = pos.shape[0]
        moves = torch.tensor(_MOVES, dtype=torch.int32, device=pos.device)
        delta = moves[action.reshape(n).long()]
        proposed = torch.clamp(pos + delta, 0, self.size - 1)
        rows = torch.arange(n, device=pos.device)
        blocked = walls[rows, proposed[:, 0].long(), proposed[:, 1].long()]
        new_pos = torch.where(blocked[:, None], pos, proposed).to(torch.int32)
        reached = (new_pos == goal).all(-1)
        reward = torch.where(
            reached, torch.ones_like(reached, dtype=torch.float32), torch.full_like(reached, -self.step_cost, dtype=torch.float32)
        )
        new_state = {"walls": walls, "pos": new_pos, "goal": goal}
        return new_state, self._obs(new_state), reward, reached, {}

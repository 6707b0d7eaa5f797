"""The SAC agent as torch modules (counterpart of ``sheeprl_tpu/algos/sac/agent.py``).

- :class:`SACActor`: an MLP trunk (two ReLU layers) with a mean and a
  log-std head for the pre-tanh Normal; :func:`actor_action_and_log_prob`
  draws the tanh-squashed action from given standard-normal noise.
- :class:`SACCritic`: the N critics as one module whose parameters carry a
  leading (N,) axis in flax's layout (kernels (N, in, out), biases (N, out)),
  evaluated together by batched products (``baddbmm``).
- :class:`SACAgent`: actor, critic, the target critic (a copy left out of
  autograd, updated by EMA) and ``log_alpha``.

Initialisation follows flax in distribution: ``lecun_normal`` kernels, zero
biases, each critic of the ensemble drawn independently.
"""

from __future__ import annotations

import copy
import math
from math import prod
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.models.models import MLP, lecun_normal_

__all__ = [
    "LOG_STD_MAX",
    "LOG_STD_MIN",
    "SACActor",
    "SACAgent",
    "SACCritic",
    "SACPlayer",
    "actor_action_and_log_prob",
    "actor_greedy_action",
    "build_agent",
]

LOG_STD_MIN = -5.0
LOG_STD_MAX = 2.0


class SACActor(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden_size: int = 256, action_low=-1.0, action_high=1.0, device=None):
        super().__init__()
        self.action_dim = int(action_dim)
        self.trunk = MLP(obs_dim, (hidden_size, hidden_size), activation="relu", device=device)
        self.mean = MLP._linear(hidden_size, self.action_dim, device)
        self.log_std = MLP._linear(hidden_size, self.action_dim, device)
        low = np.broadcast_to(np.asarray(action_low, np.float32), (self.action_dim,))
        high = np.broadcast_to(np.asarray(action_high, np.float32), (self.action_dim,))
        self.register_buffer("action_scale", torch.tensor((high - low) / 2.0, device=device), persistent=False)
        self.register_buffer("action_bias", torch.tensor((high + low) / 2.0, device=device), persistent=False)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (mean, log_std) of the pre-tanh Normal."""
        x = self.trunk(obs)
        return self.mean(x), self.log_std(x)


def actor_action_and_log_prob(actor: SACActor, obs: torch.Tensor, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tanh-squashed reparameterised sample, rescaled to the action
    bounds, and its log-prob (``agent.py:54-69``); ``noise`` is the
    standard-normal draw, shaped like the mean."""
    mean, log_std = actor(obs)
    std = torch.exp(torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))
    x_t = mean + std * noise
    y_t = torch.tanh(x_t)
    scale, bias = actor.action_scale, actor.action_bias
    action = y_t * scale + bias
    log_prob = (
        -((x_t - mean) ** 2) / (2 * std**2) - torch.log(std) - 0.5 * math.log(2 * math.pi)
        - torch.log(scale * (1 - y_t**2) + 1e-6)
    ).sum(-1, keepdim=True)
    return action, log_prob


def actor_greedy_action(actor: SACActor, obs: torch.Tensor) -> torch.Tensor:
    mean, _ = actor(obs)
    return torch.tanh(mean) * actor.action_scale + actor.action_bias


class SACCritic(nn.Module):
    """N Q(s, a) MLPs (two ReLU layers of ``hidden_size``, one output) with
    stacked parameters: ``weights.i`` (N, in, out), ``biases.i`` (N, out)."""

    def __init__(self, input_dim: int, hidden_size: int = 256, num_critics: int = 2, device=None):
        super().__init__()
        self.num_critics = int(num_critics)
        dims = [int(input_dim), int(hidden_size), int(hidden_size), 1]
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for din, dout in zip(dims[:-1], dims[1:]):
            w = torch.empty(self.num_critics, din, dout, device=device)
            self.weights.append(nn.Parameter(lecun_normal_(w, din)))
            self.biases.append(nn.Parameter(torch.zeros(self.num_critics, dout, device=device)))

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """(B, N) q-values: every critic in one batched product per layer."""
        x = torch.cat([obs, action], -1)
        h = x.unsqueeze(0).expand(self.num_critics, *x.shape)
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = torch.baddbmm(b.unsqueeze(1), h, w)
            if i < last:
                h = F.relu(h)
        return h.squeeze(-1).transpose(0, 1)


class SACAgent(nn.Module):
    def __init__(self, actor: SACActor, critic: SACCritic, alpha: float):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.target_critic = copy.deepcopy(critic).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], device=critic.weights[0].device)))


class SACPlayer:
    """Env-interaction policy over the agent's actor (reference ``SACPlayer``):
    observations through ``prepare_obs_fn`` (host numpy), actions back as
    tensors on the actor's device."""

    def __init__(self, actor: SACActor, prepare_obs_fn: Callable[[Dict[str, Any]], np.ndarray]):
        self.actor = actor
        self._prepare_obs = prepare_obs_fn

    @torch.no_grad()
    def get_actions(
        self, obs: Dict[str, Any], generator: Optional[torch.Generator] = None, greedy: bool = False
    ) -> torch.Tensor:
        device = self.actor.action_scale.device
        prepared = torch.from_numpy(self._prepare_obs(obs)).to(device)
        if greedy:
            return actor_greedy_action(self.actor, prepared)
        noise = torch.randn((prepared.shape[0], self.actor.action_dim), generator=generator, device=device)
        return actor_action_and_log_prob(self.actor, prepared, noise)[0]


def build_agent(runtime, cfg, obs_space, action_space, agent_state: Optional[Dict[str, torch.Tensor]] = None):
    """-> (agent, target_entropy) on the runtime's device.  ``obs_space``
    maps each key to something with a ``shape``; ``action_space`` has
    ``shape``, ``low`` and ``high``.  ``agent_state`` is a ``state_dict`` to
    start from instead of a fresh initialisation."""
    act_dim = int(prod(action_space.shape))
    obs_dim = int(sum(prod(obs_space[k].shape) for k in cfg.algo.mlp_keys.encoder))
    device = runtime.device
    actor = SACActor(
        obs_dim,
        act_dim,
        hidden_size=int(cfg.algo.actor.hidden_size),
        action_low=np.asarray(action_space.low),
        action_high=np.asarray(action_space.high),
        device=device,
    )
    critic = SACCritic(obs_dim + act_dim, int(cfg.algo.critic.hidden_size), int(cfg.algo.critic.n), device=device)
    agent = SACAgent(actor, critic, float(cfg.algo.alpha.alpha))
    if agent_state is not None:
        agent.load_state_dict(agent_state, strict=True)
    return agent, -float(act_dim)

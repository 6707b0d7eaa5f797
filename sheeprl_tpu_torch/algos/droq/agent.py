"""The DroQ agent as torch modules (counterpart of ``sheeprl_tpu/algos/droq/agent.py``;
arXiv:2110.02034).

- :class:`DroQCritic`: the N critics as one module, each two hidden layers of
  linear -> dropout -> LayerNorm -> ReLU and one output, with stacked
  parameters in flax's layout (kernels (N, in, out), biases and LayerNorm
  scales (N, out)), every critic in one batched product a layer, as the
  port's ``SACCritic`` runs them.  JAX vmaps N flax critics
  (``droq_ensemble_apply``).
- Dropout is chosen per call: deterministic unless ``masks`` are given
  (one keep mask (N, B, hidden) a hidden layer, one per critic, as JAX's
  split key gives; ``droq.py:draw_noise`` draws them).
- :func:`build_agent`: the port's ``SACActor``, a ``DroQCritic`` and
  ``log_alpha`` in a ``SACAgent`` (the target critic a copy out of autograd).
"""

from __future__ import annotations

from math import prod
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACAgent
from sheeprl_tpu_torch.models.models import dropout, layer_norm_stacked, lecun_normal_

__all__ = ["DroQCritic", "build_agent"]

LN_EPS = 1e-5  # the JAX MLP's LayerNorm epsilon when no norm_args are given


class DroQCritic(nn.Module):
    """N Q(s, a) MLPs with dropout and LayerNorm: ``weights.i`` (N, in, out),
    ``biases.i`` (N, out), ``norm_weights.i``/``norm_biases.i`` (N, hidden)."""

    def __init__(self, input_dim: int, hidden_size: int = 256, num_critics: int = 2, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.num_critics = int(num_critics)
        self.hidden_size = int(hidden_size)
        self.rate = float(dropout)
        dims = [int(input_dim), self.hidden_size, self.hidden_size, 1]
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        self.norm_weights = nn.ParameterList()
        self.norm_biases = nn.ParameterList()
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.empty(self.num_critics, din, dout, device=device)
            self.weights.append(nn.Parameter(lecun_normal_(w, din)))
            self.biases.append(nn.Parameter(torch.zeros(self.num_critics, dout, device=device)))
            if i < len(dims) - 2:
                self.norm_weights.append(nn.Parameter(torch.ones(self.num_critics, dout, device=device)))
                self.norm_biases.append(nn.Parameter(torch.zeros(self.num_critics, dout, device=device)))

    @property
    def hidden_layers(self) -> int:
        return len(self.norm_weights)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """(B, N) q-values; dropout only where ``masks`` (one keep mask
        (N, B, hidden) a hidden layer) are given."""
        x = torch.cat([obs, action], -1)
        h = x.unsqueeze(0).expand(self.num_critics, *x.shape)
        for i in range(self.hidden_layers):
            h = torch.baddbmm(self.biases[i].unsqueeze(1), h, self.weights[i])
            h = dropout(h, self.rate, None if masks is None else masks[i])
            h = F.relu(layer_norm_stacked(h, self.norm_weights[i], self.norm_biases[i], LN_EPS))
        h = torch.baddbmm(self.biases[-1].unsqueeze(1), h, self.weights[-1])
        return h.squeeze(-1).transpose(0, 1)


def build_agent(runtime, cfg, obs_space, action_space):
    """-> (agent, target_entropy) on the runtime's device
    (``droq/agent.py:build_agent``); load trained weights with
    :func:`sheeprl_tpu_torch.utils.convert.load_flax_params`."""
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
    critic = DroQCritic(obs_dim + act_dim, int(cfg.algo.critic.hidden_size), int(cfg.algo.critic.n),
                        float(cfg.algo.critic.dropout), device=device)
    return SACAgent(actor, critic, float(cfg.algo.alpha.alpha)), -float(act_dim)

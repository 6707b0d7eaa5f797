"""The Plan2Explore-DreamerV3 agent as torch modules (counterpart of
``sheeprl_tpu/algos/p2e_dv3/agent.py``; arXiv:2005.05960).

:class:`P2EDV3Agent` is the DreamerV3 agent (its ``actor``, ``critic`` and
``target_critic`` are the *task* policy's, so that DreamerV3's train step
and player run on it unchanged) plus

- ``actor_exploration``: the same actor class with its own parameters;
- ``critics_exploration``: one ``{"module", "target_module"}`` pair a
  configured exploration critic with ``weight > 0``, each with its reward
  type (``intrinsic``: the ensemble's disagreement; ``task``: the reward
  model) in ``critics_cfg``;
- ``ensembles``: :class:`StackedDreamerMLP`, ``ensembles.n`` DreamerMLPs
  over (stochastic, recurrent, action) that predict the next stochastic
  state, their parameters stacked on a leading axis in the order of JAX's
  vmapped tree, every member in one batched product a layer.

:func:`build_agent` raises as JAX's does: ``RuntimeError`` with no
intrinsic critic, ``ValueError`` for an unknown reward type.  JAX's
``make_player(actor_type)`` has no counterpart: DreamerV3's loop
(``run_dreamer``) builds the player over the actor its family names and
switches policies by assigning ``player.agent.actor``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn as nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    DreamerAgent,
    _ln_enabled,
    _ln_eps,
    build_actor,
    build_critic,
)
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent as dv3_build_agent
from sheeprl_tpu_torch.models.models import flax_init_, layer_norm_stacked, resolve_activation

__all__ = ["P2EDV3Agent", "StackedDreamerMLP", "build_agent", "exploration_critics_cfg"]


class StackedDreamerMLP(nn.Module):
    """``n`` DreamerMLPs (LinearLnAct layers, then a head) side by side:
    ``weights.i`` (n, in, units), ``norm_weights.i``/``norm_biases.i``
    (n, units) with LayerNorm, ``biases.i`` (n, units) where the dense layer
    has a bias, ``head_weight`` (n, units, out), ``head_bias`` (n, out).
    ``forward(x)`` maps (..., in) to (n, ..., out) in f32.

    ``bias`` None keeps DreamerV3's blocks (a bias only without LayerNorm);
    DreamerV2's ``V2MLP`` (DenseActLn: a biased dense, then the optional
    LayerNorm, eps 1e-6, then ELU) passes ``bias=True``, ``out_init="trunc"``
    and ``block="DenseActLn"``, its flax name."""

    def __init__(self, n: int, in_features: int, units: int, layers: int, output_dim: int, layer_norm: bool = True,
                 eps: float = 1e-3, act: Any = "silu", out_init: str = "uniform", device=None, bias=None,
                 block: str = "LinearLnAct"):
        super().__init__()
        self.n, self.layer_norm, self.eps = int(n), bool(layer_norm), float(eps)
        self.bias = not self.layer_norm if bias is None else bool(bias)
        self.flax_block = block
        self.act = resolve_activation(act)
        dims = [int(in_features)] + [int(units)] * int(layers)
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        self.norm_weights = nn.ParameterList()
        self.norm_biases = nn.ParameterList()
        for din, dout in zip(dims[:-1], dims[1:]):
            w = torch.empty(self.n, din, dout, device=device)
            for member in w:
                flax_init_(member, "trunc")
            self.weights.append(nn.Parameter(w))
            if self.bias:
                self.biases.append(nn.Parameter(torch.zeros(self.n, dout, device=device)))
            if self.layer_norm:
                self.norm_weights.append(nn.Parameter(torch.ones(self.n, dout, device=device)))
                self.norm_biases.append(nn.Parameter(torch.zeros(self.n, dout, device=device)))
        head = torch.empty(self.n, dims[-1], int(output_dim), device=device)
        for member in head:
            flax_init_(member, out_init)
        self.head_weight = nn.Parameter(head)
        self.head_bias = nn.Parameter(torch.zeros(self.n, int(output_dim), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        h = x.float().reshape(1, -1, x.shape[-1]).expand(self.n, -1, -1)
        for i, w in enumerate(self.weights):
            h = torch.baddbmm(self.biases[i].unsqueeze(1), h, w) if self.bias else torch.bmm(h, w)
            if self.layer_norm:
                h = layer_norm_stacked(h, self.norm_weights[i], self.norm_biases[i], self.eps)
            h = self.act(h)
        out = torch.baddbmm(self.head_bias.unsqueeze(1), h, self.head_weight)
        return out.reshape(self.n, *lead, out.shape[-1])


class P2EDV3Agent(DreamerAgent):
    """The DreamerV3 agent (task actor and critics) plus the exploration
    actor, the exploration critics and the ensembles (module docstring)."""

    def __init__(self, base: DreamerAgent, actor_exploration: nn.Module, critics_exploration: nn.ModuleDict,
                 critics_cfg: Dict[str, Dict[str, Any]], ensembles: StackedDreamerMLP):
        super().__init__(base.world_model, base.actor, base.critic, base.target_critic)
        self.actor_exploration = actor_exploration
        self.critics_exploration = critics_exploration
        self.critics_cfg = dict(critics_cfg)
        self.ensembles = ensembles
        for pair in critics_exploration.values():
            pair["target_module"].requires_grad_(False)

    def target_pairs(self):
        return super().target_pairs() + [(c["target_module"], c["module"]) for c in self.critics_exploration.values()]


def exploration_critics_cfg(cfg) -> Dict[str, Dict[str, Any]]:
    """The exploration critics with ``weight > 0`` and their reward types
    (``agent.py:91-114``); raises with no intrinsic one or an unknown type."""
    out: Dict[str, Dict[str, Any]] = {}
    intrinsic = 0
    for name, v in cfg.algo.critics_exploration.items():
        if v["weight"] > 0:
            if v["reward_type"] == "intrinsic":
                intrinsic += 1
            elif v["reward_type"] != "task":
                raise ValueError(f"Exploration critic '{name}' has unknown reward_type '{v['reward_type']}'")
            out[name] = {"weight": v["weight"], "reward_type": v["reward_type"]}
    if intrinsic == 0:
        raise RuntimeError("You must specify at least one intrinsic critic (`reward_type='intrinsic'`)")
    return out


def build_agent(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space) -> P2EDV3Agent:
    """The whole agent on ``runtime.device``, initialised from the torch RNG:
    DreamerV3's, then the exploration actor, the exploration critics (a
    target each, starting as a copy) and the ensembles.  Load trained
    weights with :func:`sheeprl_tpu_torch.utils.convert.load_flax_params`."""
    critics_cfg = exploration_critics_cfg(cfg)
    base = dv3_build_agent(runtime, actions_dim, is_continuous, cfg, obs_space)
    actor_exploration = build_actor(runtime, actions_dim, is_continuous, cfg)
    critics = nn.ModuleDict()
    for name in critics_cfg:
        module = build_critic(runtime, cfg)
        target = build_critic(runtime, cfg)
        target.load_state_dict(module.state_dict())
        critics[name] = nn.ModuleDict({"module": module, "target_module": target})
    wm_cfg = cfg.algo.world_model
    ens_cfg = cfg.algo.ensembles
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent = stoch + int(wm_cfg.recurrent_model.recurrent_state_size)
    ensembles = StackedDreamerMLP(
        int(ens_cfg.n), int(np.sum(actions_dim)) + latent, int(ens_cfg.dense_units), int(ens_cfg.mlp_layers), stoch,
        _ln_enabled(ens_cfg.layer_norm), _ln_eps(ens_cfg.layer_norm), ens_cfg.get("dense_act", "silu"),
        out_init="uniform", device=runtime.device,
    )
    return P2EDV3Agent(base, actor_exploration, critics, critics_cfg, ensembles)

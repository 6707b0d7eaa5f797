"""The Plan2Explore-DreamerV2 agent as torch modules (counterpart of
``sheeprl_tpu/algos/p2e_dv2/agent.py``; arXiv:2005.05960).

:class:`P2EDV2Agent` is the DreamerV2 agent (its ``actor``, ``critic`` and
``target_critic`` are the *task* policy's, so that DreamerV2's train step
and player run on it unchanged) plus the exploration branch:
``actor_exploration``, ``critic_exploration`` and
``target_critic_exploration`` (a hard copy every
``per_rank_target_network_update_freq`` gradient steps, as the task's), and
``ensembles``: ``ensembles.n`` DreamerV2 ``V2MLP``s over (stochastic,
recurrent, action) that predict the next flattened stochastic state, their
parameters stacked on a leading axis in the order of JAX's vmapped tree,
every member in one batched product a layer
(:class:`~sheeprl_tpu_torch.algos.p2e_dv3.agent.StackedDreamerMLP` with
DenseActLn's biased dense, optional LayerNorm with eps 1e-6 and ELU).

JAX's ``make_player(actor_type)`` has no counterpart: the Dreamer loop
(``run_dreamer``) builds ``PlayerDV2`` over the actor its family names.
"""

from __future__ import annotations

from typing import Sequence

import copy

import numpy as np
import torch.nn as nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import Actor, build_actor, build_critic  # noqa: F401  (Actor: cfg.algo.actor.cls)
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as dv2_build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.agent import DreamerAgent
from sheeprl_tpu_torch.algos.p2e_dv3.agent import StackedDreamerMLP

__all__ = ["Actor", "P2EDV2Agent", "build_agent", "build_ensembles"]


class P2EDV2Agent(DreamerAgent):
    """The DreamerV2 agent (task actor and critics) plus the exploration
    actor, critic and target critic and the ensembles (module docstring)."""

    def __init__(self, base: DreamerAgent, actor_exploration: nn.Module, critic_exploration: nn.Module,
                 target_critic_exploration: nn.Module, ensembles: StackedDreamerMLP):
        super().__init__(base.world_model, base.actor, base.critic, base.target_critic)
        self.actor_exploration = actor_exploration
        self.critic_exploration = critic_exploration
        self.target_critic_exploration = target_critic_exploration.requires_grad_(False)
        self.ensembles = ensembles

    def target_pairs(self):
        return super().target_pairs() + [(self.target_critic_exploration, self.critic_exploration)]


def build_ensembles(runtime, cfg, in_features: int, output_dim: int, layer_norm: bool) -> StackedDreamerMLP:
    """``ensembles.n`` V2MLPs of ``cfg.algo.ensembles`` side by side."""
    ens_cfg = cfg.algo.ensembles
    return StackedDreamerMLP(
        int(ens_cfg.n), in_features, int(ens_cfg.dense_units), int(ens_cfg.mlp_layers), output_dim, layer_norm,
        1e-6, ens_cfg.get("dense_act", "elu"), out_init="trunc", device=runtime.device, bias=True, block="DenseActLn",
    )


def build_agent(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space) -> P2EDV2Agent:
    """The whole agent on ``runtime.device``, initialised from the torch RNG:
    DreamerV2's (its actor and critics the task's), a fresh actor, critic
    and target critic (a copy) for the exploration, and the ensembles.  Load
    trained weights with :func:`sheeprl_tpu_torch.utils.convert.load_flax_params`."""
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent = stoch + int(wm_cfg.recurrent_model.recurrent_state_size)
    base = dv2_build_agent(runtime, actions_dim, is_continuous, cfg, obs_space)
    critic = build_critic(runtime, cfg, latent)
    ensembles = build_ensembles(runtime, cfg, int(np.sum(actions_dim)) + latent, stoch,
                                bool(cfg.algo.ensembles.get("layer_norm", False)))
    return P2EDV2Agent(base, build_actor(runtime, actions_dim, is_continuous, cfg, latent), critic,
                       copy.deepcopy(critic), ensembles)

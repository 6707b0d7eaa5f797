"""The Plan2Explore-DreamerV1 agent as torch modules (counterpart of
``sheeprl_tpu/algos/p2e_dv1/agent.py``; arXiv:2005.05960).

:class:`P2EDV1Agent` is the DreamerV1 agent (its ``actor`` and ``critic``
are the *task* policy's, so that DreamerV1's train step and player run on it
unchanged) plus ``actor_exploration``, ``critic_exploration`` (no target
critics: DreamerV1 keeps none) and ``ensembles``: ``ensembles.n`` DreamerV2
``V2MLP``s without LayerNorm over (stochastic, recurrent, action) that
predict the next *embedded observation* (width :func:`embedded_obs_dim`),
stacked as P2E-DV2's (:func:`~sheeprl_tpu_torch.algos.p2e_dv2.agent.build_ensembles`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch.nn as nn

from sheeprl_tpu_torch.algos.dreamer_v1.agent import DV1Agent, build_critic
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.agent import Actor, V2MLP, build_actor, cnn_encoder_output_dim  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_ensembles
from sheeprl_tpu_torch.algos.p2e_dv3.agent import StackedDreamerMLP

__all__ = ["Actor", "P2EDV1Agent", "build_agent", "embedded_obs_dim"]


class P2EDV1Agent(DV1Agent):
    """The DreamerV1 agent (task actor and critic) plus the exploration
    actor and critic and the ensembles (module docstring)."""

    def __init__(self, base: DV1Agent, actor_exploration: nn.Module, critic_exploration: V2MLP,
                 ensembles: StackedDreamerMLP):
        super().__init__(base.world_model, base.actor, base.critic)
        self.actor_exploration = actor_exploration
        self.critic_exploration = critic_exploration
        self.ensembles = ensembles


def embedded_obs_dim(cfg, obs_space) -> int:
    """The width of DreamerV1's encoder output (``agent.py:35``): the conv
    stages' flattened features of a 64x64 image and ``dense_units`` for the
    MLP keys."""
    enc_cfg = cfg.algo.world_model.encoder
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    cnn = cnn_encoder_output_dim(int(obs_space[cnn_keys[0]].shape[0]), int(enc_cfg.cnn_channels_multiplier)) if cnn_keys else 0
    return int(cnn + (int(enc_cfg.dense_units) if mlp_keys else 0))


def build_agent(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space) -> P2EDV1Agent:
    """The whole agent on ``runtime.device``, initialised from the torch RNG:
    DreamerV1's (its actor and critic the task's), a fresh actor and critic
    for the exploration, and the ensembles."""
    wm_cfg = cfg.algo.world_model
    latent = int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    base = dv1_build_agent(runtime, actions_dim, is_continuous, cfg, obs_space)
    ensembles = build_ensembles(runtime, cfg, int(np.sum(actions_dim)) + latent, embedded_obs_dim(cfg, obs_space), False)
    return P2EDV1Agent(base, build_actor(runtime, actions_dim, is_continuous, cfg, latent),
                       build_critic(runtime, cfg, latent), ensembles)

"""DreamerV1 as torch modules.

Counterpart of ``sheeprl_tpu/algos/dreamer_v1/agent.py``: ``GRUCell`` (flax's
``nn.GRUCell`` written out), ``RecurrentModel`` (a dense layer and its
activation, then the cell in f32), the Gaussian ``compute_stochastic_state``
with ``min_std``, the continuous-latent ``RSSM`` (no ``is_first`` resets:
sampled windows may cross episode ends), ``PlayerDV1`` with the
exploration half-life and ``build_agent``.  The encoders, decoders, actor
and the MLPs are DreamerV2's, as the JAX package imports them; the agent
has no target critic.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2, V2MLP, build_actor, build_encoder_decoder
from sheeprl_tpu_torch.algos.dreamer_v3.agent import DreamerPlayer, WorldModel, _linear
from sheeprl_tpu_torch.models.models import flax_init_, lecun_normal_, resolve_activation

__all__ = ["DV1Agent", "GRUCell", "PlayerDV1", "RSSM", "RecurrentModel", "build_agent", "build_critic",
           "compute_stochastic_state"]


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell``: ``r = sigmoid(x W_ir + b_ir + h W_hr)``,
    ``z = sigmoid(x W_iz + b_iz + h W_hz)``, ``n = tanh(x W_in + b_in +
    r (h W_hn + b_hn))``, ``h' = (1 - z) n + z h``.  Its hidden dense
    layers ``hr``/``hz`` have no bias, which ``torch.nn.GRUCell`` has.
    ``input_kernel`` (X, 3H) and ``hidden_kernel`` (H, 3H) hold the gates
    r, z, n side by side; ``input_bias`` (3H) theirs and ``hidden_bias`` (H)
    the candidate's hidden bias.  f32 throughout."""

    flax_layout = "dreamer_v1"  # the converter's tree for modules holding this cell

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.hidden_size = int(hidden_size)
        h = self.hidden_size
        self.input_kernel = nn.Parameter(torch.empty(input_size, 3 * h, device=device))
        lecun_normal_(self.input_kernel, input_size)
        # flax's recurrent kernels start orthogonal, one (H, H) block a gate
        blocks = [nn.init.orthogonal_(torch.empty(h, h, device=device)) for _ in range(3)]
        self.hidden_kernel = nn.Parameter(torch.cat(blocks, -1))
        self.input_bias = nn.Parameter(torch.zeros(3 * h, device=device))
        self.hidden_bias = nn.Parameter(torch.zeros(h, device=device))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gi = x.float() @ self.input_kernel + self.input_bias
        gh = h.float() @ self.hidden_kernel
        i_r, i_z, i_n = torch.chunk(gi, 3, -1)
        h_r, h_z, h_n = torch.chunk(gh, 3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.hidden_bias))
        return (1.0 - z) * n + z * h.float()


class RecurrentModel(nn.Module):
    """Dense to the recurrent size and its activation (in the compute
    dtype), then the GRU cell in f32: a bf16 carry would lose the state's
    small updates every step."""

    def __init__(self, input_size: int, recurrent_state_size: int, act: Any = "elu", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dense = nn.Linear(input_size, recurrent_state_size, device=device)
        flax_init_(self.dense.weight, "trunc")
        nn.init.zeros_(self.dense.bias)
        self.gru = GRUCell(recurrent_state_size, recurrent_state_size, device=device)
        self.act = act
        self.dtype = dtype

    def forward(self, inp: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        feat = resolve_activation(self.act)(_linear(inp, self.dense, self.dtype))
        return self.gru(recurrent_state, feat.float())


def compute_stochastic_state(state_information: torch.Tensor, min_std: float = 0.1, sample: bool = True,
                             noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
    """(..., 2 * stoch) -> ((mean, std), state): ``std = softplus(std) +
    min_std``, the state ``mean + std * noise`` (standard normals) or the
    mean when ``sample`` is false."""
    mean, std = torch.chunk(state_information, 2, -1)
    std = F.softplus(std) + min_std
    if not sample:
        return (mean, std), mean
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return (mean, std), mean + std * noise


class RSSM(nn.Module):
    """Continuous-latent RSSM: zero initial states and no ``is_first``
    resets."""

    def __init__(self, actions_dim: Sequence[int], embedded_obs_dim: int, recurrent_state_size: int,
                 stochastic_size: int = 30, representation_hidden_size: int = 200, transition_hidden_size: int = 200,
                 min_std: float = 0.1, act: Any = "elu", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.recurrent_state_size = int(recurrent_state_size)
        self.stochastic_size = int(stochastic_size)
        self.min_std = float(min_std)
        self.act = act
        self.dtype = dtype
        self.recurrent_model = RecurrentModel(stochastic_size + int(np.sum(actions_dim)), recurrent_state_size, act,
                                              dtype, device)
        self.representation_model = V2MLP(recurrent_state_size + embedded_obs_dim, representation_hidden_size, 1,
                                          2 * stochastic_size, act, False, dtype, device)
        self.transition_model = V2MLP(recurrent_state_size, transition_hidden_size, 1, 2 * stochastic_size, act, False,
                                      dtype, device)

    def recurrent_step(self, inp: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.recurrent_model(inp, recurrent_state)

    def _representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor,
                        noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        out = self.representation_model(torch.cat([recurrent_state, embedded_obs], -1))
        return compute_stochastic_state(out, self.min_std, noise=noise, generator=generator)

    def _transition(self, recurrent_out: torch.Tensor, sample_state: bool = True, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        return compute_stochastic_state(self.transition_model(recurrent_out), self.min_std, sample=sample_state,
                                        noise=noise, generator=generator)

    def representation_embed_proj(self, embedded_obs: torch.Tensor) -> torch.Tensor:
        """The embed half of the representation model's first product and
        its bias, batched over the whole sequence outside the dynamic loop."""
        dense = self.representation_model.layers[0].dense
        k_e = dense.weight[:, self.recurrent_state_size :]
        k_e = k_e if self.dtype == torch.float32 else k_e.to(self.dtype)
        return embedded_obs.to(self.dtype) @ k_e.t() + dense.bias.to(self.dtype)

    def _representation_from_proj(self, emb_proj: torch.Tensor, recurrent_state: torch.Tensor,
                                  noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        dense = self.representation_model.layers[0].dense
        k_h = dense.weight[:, : self.recurrent_state_size]
        k_h = k_h if self.dtype == torch.float32 else k_h.to(self.dtype)
        x = resolve_activation(self.act)((recurrent_state.to(self.dtype) @ k_h.t() + emb_proj).to(self.dtype))
        return compute_stochastic_state(self.representation_model.head(x.float()), self.min_std, noise=noise,
                                        generator=generator)

    def dynamic_posterior_from_proj(self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor,
                                    emb_proj: torch.Tensor, noise: Optional[torch.Tensor] = None,
                                    generator: Optional[torch.Generator] = None):
        """One step of the dynamic loop: -> (recurrent_state, posterior,
        (posterior mean, posterior std))."""
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        mean_std, posterior = self._representation_from_proj(emb_proj, recurrent_state, noise, generator)
        return recurrent_state, posterior, mean_std

    def imagination(self, stochastic_state: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor,
                    noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """One imagination step: -> (prior sample, recurrent state)."""
        recurrent_state = self.recurrent_model(torch.cat([stochastic_state, actions], -1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, noise=noise, generator=generator)
        return imagined_prior, recurrent_state


class DV1Agent(nn.Module):
    """Everything DreamerV1 trains, laid out like the JAX package's
    ``params`` tree: ``world_model``, ``actor`` and ``critic`` (no target
    critic)."""

    def __init__(self, world_model: WorldModel, actor: nn.Module, critic: V2MLP):
        super().__init__()
        self.world_model = world_model
        self.actor = actor
        self.critic = critic

    def player(self) -> DreamerPlayer:
        wm = self.world_model
        return DreamerPlayer(WorldModel(wm.encoder, wm.rssm), self.actor)

    def target_pairs(self):
        return []


class PlayerDV1(PlayerDV2):
    """DreamerV2's player on Gaussian latents, its exploration amount halved
    every ``expl_decay`` policy steps (``get_actions(..., step=policy_step)``)
    down to ``expl_min`` (``expl_decay`` 0: constant)."""

    def __init__(self, agent: DreamerPlayer, actions_dim: Sequence[int], num_envs: int, stochastic_size: int,
                 recurrent_state_size: int, expl_amount: float = 0.0, expl_decay: float = 0.0, expl_min: float = 0.0):
        self.expl_decay = float(expl_decay)
        self.expl_min = float(expl_min)
        super().__init__(agent, actions_dim, num_envs, stochastic_size, recurrent_state_size, discrete_size=1,
                         expl_amount=expl_amount)

    def get_expl_amount(self, step: int) -> float:
        amount = self.expl_amount
        if self.expl_decay:
            amount = amount * 0.5 ** (float(step) / self.expl_decay)
        return max(amount, self.expl_min)

    def _expl_amount(self, greedy: bool, step: int) -> float:
        return 0.0 if greedy else self.get_expl_amount(step)


def build_critic(runtime, cfg, latent_state_size: int) -> V2MLP:
    """DreamerV1's critic (``cfg.algo.critic``, no LayerNorm)."""
    node = cfg.algo.critic
    return V2MLP(latent_state_size, int(node.dense_units), int(node.mlp_layers), 1, node.get("dense_act", "elu"), False,
                 runtime.compute_dtype, runtime.device)


def build_agent(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space) -> DV1Agent:
    """The whole DreamerV1 agent (``agent.py:build_agent``): the world model
    (encoder, RSSM, observation and reward models, and the continue model
    when ``use_continues``), the actor and the critic, on ``runtime.device``
    and initialised from the torch RNG; no LayerNorm anywhere."""
    wm_cfg = cfg.algo.world_model
    device, dtype = runtime.device, runtime.compute_dtype
    rec, stoch = int(wm_cfg.recurrent_model.recurrent_state_size), int(wm_cfg.stochastic_size)
    latent = stoch + rec
    dense_act = wm_cfg.encoder.get("dense_act", "elu")
    encoder, observation_model, embedded_obs_dim = build_encoder_decoder(
        runtime, cfg, obs_space, latent, cnn_act=wm_cfg.encoder.get("cnn_act", "relu"), dense_act=dense_act,
        layer_norms={"encoder": False, "observation_model": False}, family="DreamerV1",
    )
    rssm = RSSM(tuple(actions_dim), embedded_obs_dim, rec, stoch, int(wm_cfg.representation_model.hidden_size),
                int(wm_cfg.transition_model.hidden_size), float(wm_cfg.min_std), dense_act, dtype, device)

    def head(node, act) -> V2MLP:
        return V2MLP(latent, int(node.dense_units), int(node.mlp_layers), 1, act, False, dtype, device)

    reward_model = head(wm_cfg.reward_model, dense_act)
    continue_model = head(wm_cfg.discount_model, dense_act) if bool(wm_cfg.use_continues) else None
    critic = build_critic(runtime, cfg, latent)
    actor = build_actor(runtime, actions_dim, is_continuous, cfg, latent)
    return DV1Agent(WorldModel(encoder, rssm, observation_model, reward_model, continue_model), actor, critic)

"""DreamerV2 as torch modules.

Counterpart of ``sheeprl_tpu/algos/dreamer_v2/agent.py``: ``DenseActLn``,
``V2MLP``, the encoders and decoders (their concatenations DreamerV3's),
``RecurrentModel`` (a dense layer,
then the LayerNorm GRU cell with its dense's bias), the discrete-latent
``RSSM`` without unimix and with zero resets, ``Actor`` (one-hot heads with
the MineDojo masks, or a truncated-normal, tanh-normal or normal head),
``add_exploration_noise``, ``PlayerDV2`` and ``build_agent``.  The world
model, agent and player containers are DreamerV3's
(:class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.WorldModel`,
:class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.DreamerAgent`,
:class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.DreamerPlayer`), so that
the parameter trees line up with the JAX package's
(``utils/convert.py``).

Parameters start from the JAX package's initialisers in distribution:
Xavier (fan-average) truncated normal kernels and zero biases everywhere
but the GRU cell (flax's LeCun normal).  Activations default to ELU; the
optional LayerNorms are flax's (eps 1e-6).  The conv encoder and decoder
are 4 VALID stages and take 64x64 images only; observations are NHWC at
the module boundaries, and the conv features are flattened in (H, W, C)
order, as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    DreamerAgent,
    DreamerPlayer,
    MultiDecoderDV3,
    MultiEncoderDV3,
    WorldModel,
    _linear,
    compute_stochastic_state,
)
from sheeprl_tpu_torch.models.models import LayerNorm, LayerNormGRUCell, flax_init_, ln_act_apply, resolve_activation
from sheeprl_tpu_torch.utils.distribution import (
    Independent,
    Normal,
    OneHotCategoricalStraightThrough,
    TanhNormal,
    TruncatedNormal,
    gumbel_noise,
    normal_noise,
    truncated_uniform_noise,
)

__all__ = [
    "Actor",
    "CNNDecoder",
    "CNNEncoder",
    "DenseActLn",
    "MLPDecoder",
    "MLPEncoder",
    "PlayerDV2",
    "RSSM",
    "RecurrentModel",
    "V2MLP",
    "add_exploration_noise",
    "build_agent",
    "build_critic",
    "cnn_encoder_output_dim",
]

class DenseActLn(nn.Module):
    """Dense (with its bias) -> optional LayerNorm -> activation."""

    flax_layout = "dreamer_v2"  # the converter's tree for modules built of these

    def __init__(self, in_features: int, units: int, act: Any = "elu", layer_norm: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dense = nn.Linear(in_features, units, device=device)
        flax_init_(self.dense.weight, "trunc")
        nn.init.zeros_(self.dense.bias)
        self.norm = LayerNorm(units, 1e-6, device=device) if layer_norm else None
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _linear(x, self.dense, self.dtype)
        if self.norm is not None:
            return ln_act_apply(self.norm, x, act=self.act, dtype=self.dtype)
        return resolve_activation(self.act)(x.to(self.dtype))


class V2MLP(nn.Module):
    """Stack of DenseActLn blocks + an optional f32 output head."""

    def __init__(self, in_features: int, units: int, layers: int, output_dim: Optional[int] = None, act: Any = "elu",
                 layer_norm: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        dims = [in_features] + [units] * layers
        self.layers = nn.ModuleList(DenseActLn(dims[i], units, act, layer_norm, dtype, device) for i in range(layers))
        self.head = nn.Linear(dims[-1], output_dim, device=device) if output_dim is not None else None
        if self.head is not None:
            flax_init_(self.head.weight, "trunc")
            nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        if self.head is not None:
            x = self.head(x.float())  # heads emit f32 for the distributions
        return x


def _conv_norm_act(x: torch.Tensor, norm: Optional[LayerNorm], act, dtype) -> torch.Tensor:
    if norm is not None:
        return ln_act_apply(norm, x, act=act, dtype=dtype, dim=1)
    return resolve_activation(act)(x.to(dtype))


class CNNEncoder(nn.Module):
    """4 VALID conv stages, kernel 4, stride 2, channels [1, 2, 4, 8] * mult
    (64 -> 31 -> 14 -> 6 -> 2), optional LayerNorm over channels, then the
    activation; NHWC in, features flattened in (H, W, C) order out."""

    def __init__(self, keys: Sequence[str], in_channels: int, channels_multiplier: int, layer_norm: bool = False,
                 act: Any = "elu", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.keys = tuple(keys)
        self.act = act
        self.dtype = dtype
        chans = [in_channels] + [(2**i) * channels_multiplier for i in range(4)]
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 4, stride=2, device=device) for i in range(4))
        for conv in self.convs:
            flax_init_(conv.weight, "trunc")
            nn.init.zeros_(conv.bias)
        self.norms = nn.ModuleList(LayerNorm(chans[i + 1], 1e-6, device=device) for i in range(4)) if layer_norm else None

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            w, b = (conv.weight, conv.bias) if self.dtype == torch.float32 else (conv.weight.to(self.dtype), conv.bias.to(self.dtype))
            x = F.conv2d(x.to(self.dtype), w, b, stride=2)
            x = _conv_norm_act(x, None if self.norms is None else self.norms[i], self.act, self.dtype)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return x.reshape(*lead, -1)


def cnn_encoder_output_dim(size: int, channels_multiplier: int) -> int:
    """The conv encoder's feature count for ``size`` x ``size`` images."""
    for _ in range(4):
        size = (size - 4) // 2 + 1
    return size * size * 8 * channels_multiplier


class MLPEncoder(nn.Module):
    def __init__(self, keys: Sequence[str], in_features: int, mlp_layers: int = 4, dense_units: int = 400,
                 layer_norm: bool = False, act: Any = "elu", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = V2MLP(in_features, dense_units, mlp_layers, None, act, layer_norm, dtype, device)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([obs[k] for k in self.keys], -1))


class CNNDecoder(nn.Module):
    """Linear latent -> (1, 1, cnn_encoder_output_dim) -> 4 VALID transposed
    convs of kernels [5, 5, 6, 6], stride 2 (1 -> 5 -> 13 -> 30 -> 64), the
    last in f32; NHWC out, split per image key.  flax's transposed
    convolution does not flip its kernel and torch's does: the converter
    flips it (``utils/convert.py``)."""

    def __init__(self, keys: Sequence[str], output_channels: Sequence[int], channels_multiplier: int,
                 latent_state_size: int, cnn_encoder_output_dim: int, layer_norm: bool = False, act: Any = "elu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.act = act
        self.dtype = dtype
        self.dense = nn.Linear(latent_state_size, cnn_encoder_output_dim, device=device)
        flax_init_(self.dense.weight, "trunc")
        nn.init.zeros_(self.dense.bias)
        m = channels_multiplier
        chans = [cnn_encoder_output_dim, 4 * m, 2 * m, m, sum(self.output_channels)]
        self.kernels = (5, 5, 6, 6)
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(chans[i], chans[i + 1], self.kernels[i], stride=2, device=device) for i in range(4)
        )
        for deconv in self.deconvs:
            flax_init_(deconv.weight, "trunc")
            nn.init.zeros_(deconv.bias)
        self.norms = nn.ModuleList(LayerNorm(chans[i + 1], 1e-6, device=device) for i in range(3)) if layer_norm else None

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = _linear(latent, self.dense, self.dtype)
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1], 1, 1)
        last = len(self.deconvs) - 1
        for i, deconv in enumerate(self.deconvs):
            dt = torch.float32 if i == last else self.dtype
            w, b = (deconv.weight, deconv.bias) if dt == torch.float32 else (deconv.weight.to(dt), deconv.bias.to(dt))
            x = F.conv_transpose2d(x.to(dt), w, b, stride=2)
            if i < last:
                x = _conv_norm_act(x, None if self.norms is None else self.norms[i], self.act, self.dtype)
        x = x.permute(0, 2, 3, 1)
        x = x.reshape(*lead, *x.shape[1:])
        return dict(zip(self.keys, torch.split(x, list(self.output_channels), -1)))


class MLPDecoder(nn.Module):
    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], latent_state_size: int, mlp_layers: int = 4,
                 dense_units: int = 400, layer_norm: bool = False, act: Any = "elu", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = V2MLP(latent_state_size, dense_units, mlp_layers, None, act, layer_norm, dtype, device)
        self.heads = nn.ModuleList(nn.Linear(dense_units, int(d), device=device) for d in output_dims)
        for head in self.heads:
            flax_init_(head.weight, "trunc")
            nn.init.zeros_(head.bias)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(latent).float()
        return {k: head(x) for k, head in zip(self.keys, self.heads)}


class RecurrentModel(nn.Module):
    """DenseActLn projection -> LayerNormGRUCell with its dense's bias and
    its LayerNorm (the GRU keeps its LayerNorm in V2; ``layer_norm`` is the
    projection's)."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int, layer_norm: bool = False,
                 act: Any = "elu", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.mlp = DenseActLn(input_size, dense_units, act, layer_norm, dtype, device)
        self.gru = LayerNormGRUCell(dense_units, recurrent_state_size, use_bias=True, dtype=dtype, device=device)

    def forward(self, inp: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.gru(recurrent_state, self.mlp(inp)).float()


class RSSM(nn.Module):
    """Discrete-latent RSSM: zero initial states, ``is_first``-gated zero
    resets, no unimix."""

    def __init__(self, actions_dim: Sequence[int], embedded_obs_dim: int, recurrent_state_size: int, dense_units: int,
                 stochastic_size: int = 32, discrete_size: int = 32, representation_hidden_size: int = 600,
                 transition_hidden_size: int = 600, layer_norm: bool = False, recurrent_layer_norm: bool = False,
                 act: Any = "elu", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        stoch = stochastic_size * discrete_size
        self.recurrent_state_size = int(recurrent_state_size)
        self.stochastic_size = int(stochastic_size)
        self.discrete_size = int(discrete_size)
        self.act = act
        self.dtype = dtype
        self.recurrent_model = RecurrentModel(stoch + int(np.sum(actions_dim)), recurrent_state_size, dense_units,
                                              recurrent_layer_norm, act, dtype, device)
        self.representation_model = V2MLP(recurrent_state_size + embedded_obs_dim, representation_hidden_size, 1, stoch,
                                          act, layer_norm, dtype, device)
        self.transition_model = V2MLP(recurrent_state_size, transition_hidden_size, 1, stoch, act, layer_norm, dtype,
                                      device)

    def recurrent_step(self, inp: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.recurrent_model(inp, recurrent_state)

    def _representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor,
                        noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        logits = self.representation_model(torch.cat([recurrent_state, embedded_obs], -1))
        return logits, compute_stochastic_state(logits, self.discrete_size, noise=noise, generator=generator)

    def _transition(self, recurrent_out: torch.Tensor, sample_state: bool = True, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        logits = self.transition_model(recurrent_out)
        return logits, compute_stochastic_state(logits, self.discrete_size, sample=sample_state, noise=noise,
                                                generator=generator)

    def representation_embed_proj(self, embedded_obs: torch.Tensor) -> torch.Tensor:
        """The embed half of the representation model's first product and
        its bias, batched over the whole sequence outside the dynamic loop."""
        dense = self.representation_model.layers[0].dense
        k_e = dense.weight[:, self.recurrent_state_size :]
        k_e = k_e if self.dtype == torch.float32 else k_e.to(self.dtype)
        return embedded_obs.to(self.dtype) @ k_e.t() + dense.bias.to(self.dtype)

    def _representation_from_proj(self, emb_proj: torch.Tensor, recurrent_state: torch.Tensor,
                                  noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """The posterior from a precomputed embed projection: the h-side
        product is added to ``emb_proj``."""
        block = self.representation_model.layers[0]
        k_h = block.dense.weight[:, : self.recurrent_state_size]
        k_h = k_h if self.dtype == torch.float32 else k_h.to(self.dtype)
        x = recurrent_state.to(self.dtype) @ k_h.t() + emb_proj
        if block.norm is not None:
            x = ln_act_apply(block.norm, x, act=self.act, dtype=self.dtype)
        else:
            x = resolve_activation(self.act)(x.to(self.dtype))
        logits = self.representation_model.head(x.float())
        return logits, compute_stochastic_state(logits, self.discrete_size, noise=noise, generator=generator)

    def dynamic_posterior_from_proj(self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor,
                                    emb_proj: torch.Tensor, is_first: torch.Tensor,
                                    noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """One step of the dynamic loop with ``is_first``-gated zero resets:
        -> (recurrent_state, posterior, posterior_logits)."""
        action = (1 - is_first) * action
        posterior = (1 - is_first) * posterior.reshape(*posterior.shape[:-2], -1)
        recurrent_state = (1 - is_first) * recurrent_state
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        posterior_logits, posterior = self._representation_from_proj(emb_proj, recurrent_state, noise, generator)
        return recurrent_state, posterior, posterior_logits

    def imagination(self, prior: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor,
                    noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """One imagination step: -> (prior sample, recurrent state)."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], -1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, noise=noise, generator=generator)
        return imagined_prior, recurrent_state


class Actor(nn.Module):
    """A DenseActLn trunk and one-hot straight-through heads (discrete, with
    the MineDojo masks) or a truncated-normal (``auto``), tanh-normal or
    normal head (continuous).

    ``noise`` (..., sum(actions_dim)) is Gumbel noise for discrete heads,
    uniforms in (1e-6, 1 - 1e-6) for the truncated normal and standard
    normals for the other two (:meth:`draw_noise`); greedy acting draws
    nothing."""

    def __init__(self, latent_state_size: int, actions_dim: Sequence[int], is_continuous: bool,
                 distribution: str = "auto", init_std: float = 0.0, min_std: float = 0.1, dense_units: int = 400,
                 mlp_layers: int = 4, layer_norm: bool = False, act: Any = "elu", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.distribution = str(distribution).lower()
        self.init_std = float(init_std)
        self.min_std = float(min_std)
        self.trunk = V2MLP(latent_state_size, dense_units, mlp_layers, None, act, layer_norm, dtype, device)
        outs = [2 * sum(self.actions_dim)] if self.is_continuous else list(self.actions_dim)
        self.heads = nn.ModuleList(nn.Linear(dense_units, d, device=device) for d in outs)
        for head in self.heads:
            flax_init_(head.weight, "trunc")
            nn.init.zeros_(head.bias)
        if self.is_continuous and self.dist_name() not in ("tanh_normal", "normal", "trunc_normal"):
            raise ValueError(f"Bad continuous distribution: {self.dist_name()}")

    def dist_name(self) -> str:
        if self.distribution == "auto":
            return "trunc_normal" if self.is_continuous else "discrete"
        return self.distribution

    def draw_noise(self, lead: Sequence[int], *, like: torch.Tensor, generator=None) -> torch.Tensor:
        """One sample's noise for ``lead`` rows (the module docstring's kinds)."""
        shape = (*lead, sum(self.actions_dim))
        if not self.is_continuous:
            return gumbel_noise(shape, like=like, generator=generator)
        draw = truncated_uniform_noise if self.dist_name() == "trunc_normal" else normal_noise
        return draw(shape, like=like, generator=generator)

    def forward(self, state: torch.Tensor, greedy: bool = False, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, mask: Optional[Dict[str, torch.Tensor]] = None):
        x = self.trunk(state).float()  # distribution heads in f32
        if self.is_continuous:
            mean, std = torch.chunk(self.heads[0](x), 2, -1)
            name = self.dist_name()
            if name == "tanh_normal":
                mean = 5 * torch.tanh(mean / 5)
                std = F.softplus(std + self.init_std) + self.min_std
                dist = Independent(TanhNormal(mean, std), 1)
            elif name == "normal":
                dist = Independent(Normal(mean, std), 1)
            else:
                std = 2 * torch.sigmoid((std + self.init_std) / 2) + self.min_std
                dist = Independent(TruncatedNormal(torch.tanh(mean), std, -1.0, 1.0), 1)
            actions = dist.mode if greedy else dist.rsample(noise, generator)
            return (actions,), (dist,)
        noises = torch.split(noise, list(self.actions_dim), -1) if noise is not None else [None] * len(self.heads)
        actions, dists = [], []
        functional_action = None
        for i, (head, n) in enumerate(zip(self.heads, noises)):
            logits = head(x)
            if mask is not None:
                logits = _masked(logits, i, mask, functional_action)
            d = OneHotCategoricalStraightThrough(logits=logits)
            dists.append(d)
            actions.append(d.mode if greedy else d.rsample(n, generator))
            if functional_action is None:
                functional_action = actions[0].argmax(-1)
        return tuple(actions), tuple(dists)


def _masked(logits: torch.Tensor, i: int, mask: Dict[str, torch.Tensor], functional_action) -> torch.Tensor:
    """MineDojo's conditional masks: the action type head by its mask; the
    craft head where the functional action is craft (15); the inventory
    head for equip/place (16, 17) and destroy (18)."""
    neg_inf = torch.full_like(logits, -float("inf"))
    if i == 0 and "mask_action_type" in mask:
        return torch.where(mask["mask_action_type"].bool(), logits, neg_inf)
    if i == 1 and "mask_craft_smelt" in mask:
        is_craft = (functional_action == 15)[..., None]
        return torch.where(~is_craft | mask["mask_craft_smelt"].bool(), logits, neg_inf)
    if i == 2 and "mask_equip_place" in mask and "mask_destroy" in mask:
        fa = functional_action[..., None]
        valid = torch.where((fa == 16) | (fa == 17), mask["mask_equip_place"].bool(),
                            torch.where(fa == 18, mask["mask_destroy"].bool(), torch.ones_like(mask["mask_destroy"].bool())))
        return torch.where(valid, logits, neg_inf)
    return logits


def add_exploration_noise(actions: Sequence[torch.Tensor], expl_amount: float, is_continuous: bool,
                          generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
    """Epsilon exploration: continuous actions get ``expl_amount`` times a
    standard normal added and are clipped to [-1, 1]; each discrete head is
    replaced, with probability ``expl_amount``, by a uniformly drawn one-hot.
    ``expl_amount`` 0 returns the actions as they are."""
    if expl_amount <= 0.0:
        return tuple(actions)
    if is_continuous:
        flat = torch.cat(list(actions), -1)
        noise = torch.randn(flat.shape, generator=generator, device=flat.device, dtype=flat.dtype)
        return (torch.clamp(flat + expl_amount * noise, -1.0, 1.0),)
    out = []
    for act in actions:
        idx = torch.randint(act.shape[-1], act.shape[:-1], generator=generator, device=act.device)
        sample = F.one_hot(idx, act.shape[-1]).to(act.dtype)
        coin = torch.rand((*act.shape[:-1], 1), generator=generator, device=act.device)
        out.append(torch.where(coin < expl_amount, sample, act))
    return tuple(out)


class PlayerDV2:
    """Stateful env-interaction wrapper: per-env (actions, recurrent_state,
    stochastic_state), zero initial states, exploration noise of
    ``expl_amount`` when not greedy."""

    def __init__(self, agent: DreamerPlayer, actions_dim: Sequence[int], num_envs: int, stochastic_size: int,
                 recurrent_state_size: int, discrete_size: int = 32, expl_amount: float = 0.0):
        self.agent = agent
        self.actions_dim = tuple(actions_dim)
        self.num_envs = int(num_envs)
        self.stochastic_size = int(stochastic_size)
        self.discrete_size = int(discrete_size)
        self.recurrent_state_size = int(recurrent_state_size)
        self.expl_amount = float(expl_amount)
        self.device = next(agent.parameters()).device
        self.init_states()

    @property
    def is_continuous(self) -> bool:
        return bool(self.agent.actor.is_continuous)

    @property
    def stoch_state_size(self) -> int:
        return self.stochastic_size * self.discrete_size

    @torch.no_grad()
    def init_states(self, reset_envs: Optional[Sequence[int]] = None) -> None:
        if reset_envs is None or len(reset_envs) == 0:
            self.actions = torch.zeros(1, self.num_envs, int(np.sum(self.actions_dim)), device=self.device)
            self.recurrent_state = torch.zeros(1, self.num_envs, self.recurrent_state_size, device=self.device)
            self.stochastic_state = torch.zeros(1, self.num_envs, self.stoch_state_size, device=self.device)
        else:
            idx = torch.as_tensor(list(reset_envs), device=self.device)
            self.actions[:, idx] = 0.0
            self.recurrent_state[:, idx] = 0.0
            self.stochastic_state[:, idx] = 0.0

    def _expl_amount(self, greedy: bool, step: int) -> float:
        return 0.0 if greedy else self.expl_amount

    @torch.no_grad()
    def get_actions(self, obs: Dict[str, torch.Tensor], greedy: bool = False,
                    generator: Optional[torch.Generator] = None, mask: Optional[Dict[str, torch.Tensor]] = None,
                    step: int = 0) -> Tuple[torch.Tensor, ...]:
        """One step of every env's state and its actions (``step``: the
        policy step, for a decaying exploration amount)."""
        wm, actor = self.agent.world_model, self.agent.actor
        embedded = wm.encoder(obs)
        self.recurrent_state = wm.rssm.recurrent_step(torch.cat([self.stochastic_state, self.actions], -1),
                                                      self.recurrent_state)
        _, stoch = wm.rssm._representation(self.recurrent_state, embedded, generator=generator)
        self.stochastic_state = stoch.reshape(*self.recurrent_state.shape[:-1], self.stoch_state_size)
        actions, _ = actor(torch.cat([self.stochastic_state, self.recurrent_state], -1), greedy, generator=generator,
                           mask=mask)
        actions = add_exploration_noise(actions, self._expl_amount(greedy, step), self.is_continuous, generator)
        self.actions = torch.cat(actions, -1)
        return actions


def build_actor(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, latent_state_size: int) -> Actor:
    """The actor of ``cfg.algo.actor`` on ``runtime.device`` (DreamerV2's and V1's)."""
    actor_cfg = cfg.algo.actor
    return Actor(
        latent_state_size, tuple(actions_dim), is_continuous, distribution=cfg.distribution.get("type", "auto"),
        init_std=float(actor_cfg.init_std), min_std=float(actor_cfg.min_std), dense_units=int(actor_cfg.dense_units),
        mlp_layers=int(actor_cfg.mlp_layers), layer_norm=bool(actor_cfg.get("layer_norm", False)),
        act=actor_cfg.get("dense_act", "elu"), dtype=runtime.compute_dtype, device=runtime.device,
    )


def build_head(runtime, node, latent_state_size: int, dense_act: str) -> V2MLP:
    """A one-output V2MLP of ``node`` (its ``dense_act`` if it names one)."""
    return V2MLP(latent_state_size, int(node.dense_units), int(node.mlp_layers), 1, node.get("dense_act", dense_act),
                 bool(node.layer_norm), runtime.compute_dtype, runtime.device)


def build_critic(runtime, cfg, latent_state_size: int) -> V2MLP:
    """DreamerV2's critic (``cfg.algo.critic``)."""
    return build_head(runtime, cfg.algo.critic, latent_state_size, cfg.algo.world_model.encoder.get("dense_act", "elu"))


def build_encoder_decoder(runtime, cfg, obs_space, latent_state_size: int, *, cnn_act: str, dense_act: str,
                          layer_norms: Dict[str, bool], family: str = "DreamerV2"):
    """The encoder, the observation model and the embedding's size (the
    conv encoder and decoder take 64x64 images only)."""
    wm_cfg = cfg.algo.world_model
    device, dtype = runtime.device, runtime.compute_dtype
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    cnn_out = 0
    cnn_encoder = None
    if cnn_keys:
        size = int(obs_space[cnn_keys[0]].shape[0])
        if size != 64:
            raise ValueError(f"{family}'s conv encoder/decoder require env.screen_size=64, got: {size}")
        mult = int(wm_cfg.encoder.cnn_channels_multiplier)
        cnn_encoder = CNNEncoder(cnn_keys, int(sum(obs_space[k].shape[-1] for k in cnn_keys)), mult,
                                 layer_norms["encoder"], cnn_act, dtype, device)
        cnn_out = cnn_encoder_output_dim(size, mult)
    mlp_encoder = (
        MLPEncoder(mlp_keys, int(sum(obs_space[k].shape[0] for k in mlp_keys)), int(wm_cfg.encoder.mlp_layers),
                   int(wm_cfg.encoder.dense_units), layer_norms["encoder"], dense_act, dtype, device)
        if mlp_keys
        else None
    )
    embedded_obs_dim = cnn_out + (int(wm_cfg.encoder.dense_units) if mlp_keys else 0)
    obs_cfg = wm_cfg.observation_model
    cnn_dec_keys, mlp_dec_keys = tuple(cfg.algo.cnn_keys.decoder), tuple(cfg.algo.mlp_keys.decoder)
    cnn_decoder = (
        CNNDecoder(cnn_dec_keys, [int(obs_space[k].shape[-1]) for k in cnn_dec_keys],
                   int(obs_cfg.cnn_channels_multiplier), latent_state_size, cnn_out, layer_norms["observation_model"],
                   cnn_act, dtype, device)
        if cnn_dec_keys
        else None
    )
    mlp_decoder = (
        MLPDecoder(mlp_dec_keys, [int(obs_space[k].shape[0]) for k in mlp_dec_keys], latent_state_size,
                   int(obs_cfg.mlp_layers), int(obs_cfg.dense_units), layer_norms["observation_model"], dense_act,
                   dtype, device)
        if mlp_dec_keys
        else None
    )
    return MultiEncoderDV3(cnn_encoder, mlp_encoder), MultiDecoderDV3(cnn_decoder, mlp_decoder), embedded_obs_dim


def build_agent(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space) -> DreamerAgent:
    """The whole DreamerV2 agent (``agent.py:build_agent``): the world model
    (encoder, RSSM, observation and reward models, and the continue model
    when ``use_continues``), the actor, the critic and a target critic that
    starts as a copy, on ``runtime.device`` and initialised from the torch
    RNG.  ``obs_space`` maps each observation key to anything with a
    ``shape`` (NHWC for images)."""
    wm_cfg = cfg.algo.world_model
    device, dtype = runtime.device, runtime.compute_dtype
    rec = int(wm_cfg.recurrent_model.recurrent_state_size)
    latent = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + rec
    cnn_act = wm_cfg.encoder.get("cnn_act", "elu")
    dense_act = wm_cfg.encoder.get("dense_act", "elu")
    encoder, observation_model, embedded_obs_dim = build_encoder_decoder(
        runtime, cfg, obs_space, latent, cnn_act=cnn_act, dense_act=dense_act,
        layer_norms={"encoder": bool(wm_cfg.encoder.layer_norm),
                     "observation_model": bool(wm_cfg.observation_model.layer_norm)},
    )
    rssm = RSSM(
        tuple(actions_dim), embedded_obs_dim, rec, int(wm_cfg.recurrent_model.dense_units),
        int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size), int(wm_cfg.representation_model.hidden_size),
        int(wm_cfg.transition_model.hidden_size), bool(wm_cfg.representation_model.layer_norm),
        bool(wm_cfg.recurrent_model.layer_norm), dense_act, dtype, device,
    )

    def head(node) -> V2MLP:
        return build_head(runtime, node, latent, dense_act)

    reward_model = head(wm_cfg.reward_model)
    continue_model = head(wm_cfg.discount_model) if bool(wm_cfg.use_continues) else None
    critic = build_critic(runtime, cfg, latent)
    actor = build_actor(runtime, actions_dim, is_continuous, cfg, latent)
    world_model = WorldModel(encoder, rssm, observation_model, reward_model, continue_model)
    return DreamerAgent(world_model, actor, critic, copy.deepcopy(critic))

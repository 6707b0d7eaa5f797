"""DreamerV3 player half as torch modules.

Counterpart of the player half of ``sheeprl_tpu/algos/dreamer_v3/agent.py``:
``LinearLnAct``, ``DreamerMLP``, the encoders, ``RecurrentModel``,
``compute_stochastic_state``, ``RSSM`` (recurrent step, representation,
transition, initial states), ``Actor``, ``PlayerDV3`` and the player part
of ``build_agent``.  The decoders, reward/continue heads and critic belong
to the training slice.

Layouts at the module boundaries are the JAX package's: observations are
NHWC, and the conv features are flattened in (H, W, C) order, so that the
representation model's first weight rows line up with converted
parameters.  Inside, convolutions run NCHW and the conv LayerNorm is over
channels.  Sampling takes explicit noise or an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.models.models import LayerNorm, LayerNormGRUCell, ln_act_apply, resolve_activation
from sheeprl_tpu_torch.utils.distribution import (
    Independent,
    Normal,
    OneHotCategoricalStraightThrough,
    TanhNormal,
    straight_through,
)
from sheeprl_tpu_torch.utils.utils import symlog

__all__ = [
    "Actor",
    "CNNEncoder",
    "DreamerMLP",
    "DreamerPlayer",
    "LinearLnAct",
    "MLPEncoder",
    "MultiEncoderDV3",
    "PlayerDV3",
    "RSSM",
    "RecurrentModel",
    "WorldModel",
    "build_agent",
    "compute_stochastic_state",
]


def _ln_enabled(cfg_node: Any) -> bool:
    """Map the reference's layer_norm ``cls`` strings to a bool."""
    if cfg_node is None:
        return False
    cls = str(cfg_node.get("cls", "")) if isinstance(cfg_node, dict) else str(cfg_node)
    return "identity" not in cls.lower()


def _ln_eps(cfg_node: Any) -> float:
    if isinstance(cfg_node, dict):
        return float(cfg_node.get("kw", {}).get("eps", 1e-3))
    return 1e-3


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input and kernel cast to the compute
    dtype, the product in that dtype."""
    w = layer.weight if dtype == torch.float32 else layer.weight.to(dtype)
    b = None if layer.bias is None else (layer.bias if dtype == torch.float32 else layer.bias.to(dtype))
    return F.linear(x.to(dtype), w, b)


class LinearLnAct(nn.Module):
    """Dense (no bias when followed by LN) -> LayerNorm -> activation."""

    def __init__(
        self,
        in_features: int,
        units: int,
        layer_norm: bool = True,
        eps: float = 1e-3,
        act: Any = "silu",
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.dense = nn.Linear(in_features, units, bias=not layer_norm, device=device)
        self.norm = LayerNorm(units, eps, device=device) if layer_norm else None
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _linear(x, self.dense, self.dtype)
        if self.norm is not None:
            return ln_act_apply(self.norm, x, act=self.act, dtype=self.dtype)
        return resolve_activation(self.act)(x.to(self.dtype))


class DreamerMLP(nn.Module):
    """Stack of LinearLnAct blocks + an optional f32 output head."""

    def __init__(
        self,
        in_features: int,
        units: int,
        layers: int,
        output_dim: Optional[int] = None,
        layer_norm: bool = True,
        eps: float = 1e-3,
        act: Any = "silu",
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        dims = [in_features] + [units] * layers
        self.layers = nn.ModuleList(
            LinearLnAct(dims[i], units, layer_norm, eps, act, dtype, device) for i in range(layers)
        )
        self.head = nn.Linear(dims[-1], output_dim, device=device) if output_dim is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        if self.head is not None:
            # heads emit f32: downstream distributions stay exact
            x = self.head(x.float())
        return x


class CNNEncoder(nn.Module):
    """Conv stages (kernel 4, stride 2, padding 1), channels
    [1, 2, 4, 8, ...] * multiplier, LayerNorm over channels + activation;
    NHWC in, features flattened in (H, W, C) order out."""

    def __init__(
        self,
        keys: Sequence[str],
        in_channels: int,
        channels_multiplier: int,
        stages: int = 4,
        layer_norm: bool = True,
        eps: float = 1e-3,
        act: Any = "silu",
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.keys = tuple(keys)
        self.act = act
        self.dtype = dtype
        chans = [in_channels] + [(2**i) * channels_multiplier for i in range(stages)]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 4, stride=2, padding=1, bias=not layer_norm, device=device)
            for i in range(stages)
        )
        self.norms = (
            nn.ModuleList(LayerNorm(chans[i + 1], eps, device=device) for i in range(stages))
            if layer_norm
            else None
        )

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)  # NHWC, channel concat
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            w = conv.weight if self.dtype == torch.float32 else conv.weight.to(self.dtype)
            b = conv.bias if conv.bias is None or self.dtype == torch.float32 else conv.bias.to(self.dtype)
            x = F.conv2d(x.to(self.dtype), w, b, stride=2, padding=1)
            if self.norms is not None:
                x = ln_act_apply(self.norms[i], x, act=self.act, dtype=self.dtype, dim=1)
            else:
                x = resolve_activation(self.act)(x.to(self.dtype))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return x.reshape(*lead, -1)


class MLPEncoder(nn.Module):
    def __init__(
        self,
        keys: Sequence[str],
        in_features: int,
        mlp_layers: int = 4,
        dense_units: int = 512,
        layer_norm: bool = True,
        eps: float = 1e-3,
        act: Any = "silu",
        symlog_inputs: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.keys = tuple(keys)
        self.symlog_inputs = symlog_inputs
        self.mlp = DreamerMLP(in_features, dense_units, mlp_layers, None, layer_norm, eps, act, dtype, device)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([symlog(obs[k]) if self.symlog_inputs else obs[k] for k in self.keys], -1)
        return self.mlp(x)


class MultiEncoderDV3(nn.Module):
    def __init__(self, cnn_encoder: Optional[CNNEncoder], mlp_encoder: Optional[MLPEncoder]):
        super().__init__()
        self.cnn_encoder = cnn_encoder
        self.mlp_encoder = mlp_encoder

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(obs))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(obs))
        return torch.cat(feats, -1) if len(feats) > 1 else feats[0]


class RecurrentModel(nn.Module):
    """LinearLnAct projection -> LayerNormGRUCell."""

    def __init__(
        self,
        input_size: int,
        recurrent_state_size: int,
        dense_units: int,
        layer_norm: bool = True,
        eps: float = 1e-3,
        fused: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.mlp = LinearLnAct(input_size, dense_units, layer_norm, eps, "silu", dtype, device)
        self.gru = LayerNormGRUCell(dense_units, recurrent_state_size, fused=fused, dtype=dtype, device=device)

    def forward(self, inp: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        # the carried recurrent state stays f32
        return self.gru(recurrent_state, self.mlp(inp)).float()


def compute_stochastic_state(
    logits: torch.Tensor,
    discrete: int,
    sample: bool = True,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(..., stoch*discrete) logits -> (..., stoch, discrete) one-hot
    straight-through sample, or the mode when ``sample`` is false.
    ``noise`` is Gumbel noise of the reshaped logits' shape."""
    logits = logits.reshape(*logits.shape[:-1], -1, discrete)
    if noise is not None and sample:
        hard = F.one_hot(torch.argmax(logits + noise, -1), discrete).to(logits.dtype)
        return straight_through(hard, torch.softmax(logits, -1))
    dist = OneHotCategoricalStraightThrough(logits=logits)
    return dist.rsample(generator=generator) if sample else dist.mode


class RSSM(nn.Module):
    """Recurrent State-Space Model with discrete latents (player half)."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        embedded_obs_dim: int,
        recurrent_state_size: int,
        dense_units: int,
        stochastic_size: int = 32,
        discrete_size: int = 32,
        hidden_size: int = 1024,
        unimix: float = 0.01,
        layer_norm: bool = True,
        eps: float = 1e-3,
        act: Any = "silu",
        learnable_initial_recurrent_state: bool = True,
        decoupled: bool = False,
        fused_gru: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        stoch = stochastic_size * discrete_size
        self.recurrent_state_size = int(recurrent_state_size)
        self.stochastic_size = int(stochastic_size)
        self.discrete_size = int(discrete_size)
        self.unimix = float(unimix)
        self.decoupled = bool(decoupled)
        self.recurrent_model = RecurrentModel(
            stoch + int(np.sum(actions_dim)), recurrent_state_size, dense_units, layer_norm, eps,
            fused_gru, dtype, device,
        )
        rep_in = embedded_obs_dim if decoupled else recurrent_state_size + embedded_obs_dim
        self.representation_model = DreamerMLP(
            rep_in, hidden_size, 1, stoch, layer_norm, eps, act, dtype, device
        )
        self.transition_model = DreamerMLP(
            recurrent_state_size, hidden_size, 1, stoch, layer_norm, eps, act, dtype, device
        )
        init = torch.zeros(recurrent_state_size, device=device)
        if learnable_initial_recurrent_state:
            self.initial_recurrent_state = nn.Parameter(init)
        else:
            self.register_buffer("initial_recurrent_state", init)

    def recurrent_step(self, inp: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.recurrent_model(inp, recurrent_state)

    def _uniform_mix(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits.reshape(*logits.shape[:-1], -1, self.discrete_size)
        if self.unimix > 0.0:
            probs = torch.softmax(logits, -1)
            probs = (1 - self.unimix) * probs + self.unimix * (torch.ones_like(probs) / self.discrete_size)
            logits = torch.log(probs)
        return logits.reshape(*logits.shape[:-2], -1)

    def get_initial_states(self, batch_shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        init_rec = torch.tanh(self.initial_recurrent_state).expand(*batch_shape, self.recurrent_state_size)
        _, initial_posterior = self._transition(init_rec, sample_state=False)
        return init_rec, initial_posterior

    def _representation(
        self,
        embedded_obs: torch.Tensor,
        recurrent_state: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = embedded_obs if self.decoupled else torch.cat([recurrent_state, embedded_obs], -1)
        logits = self._uniform_mix(self.representation_model(x))
        return logits, compute_stochastic_state(logits, self.discrete_size, noise=noise, generator=generator)

    def _transition(
        self,
        recurrent_out: torch.Tensor,
        sample_state: bool = True,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self._uniform_mix(self.transition_model(recurrent_out))
        return logits, compute_stochastic_state(
            logits, self.discrete_size, sample=sample_state, noise=noise, generator=generator
        )


class Actor(nn.Module):
    """Trunk MLP + per-subaction heads: unimix'd straight-through one-hot
    distributions (discrete) or a scaled Normal (continuous).

    ``noise`` is Gumbel noise of shape (..., sum(actions_dim)) for discrete
    heads and standard normals of shape (..., sum(actions_dim)) for
    continuous ones; greedy acting draws nothing."""

    def __init__(
        self,
        latent_state_size: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str = "auto",
        init_std: float = 0.0,
        min_std: float = 0.1,
        max_std: float = 1.0,
        dense_units: int = 1024,
        mlp_layers: int = 5,
        layer_norm: bool = True,
        eps: float = 1e-3,
        act: Any = "silu",
        unimix: float = 0.01,
        action_clip: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.distribution = str(distribution).lower()
        self.init_std = float(init_std)
        self.min_std = float(min_std)
        self.max_std = float(max_std)
        self.unimix = float(unimix)
        self.action_clip = float(action_clip)
        self.trunk = DreamerMLP(latent_state_size, dense_units, mlp_layers, None, layer_norm, eps, act, dtype, device)
        if self.is_continuous:
            self.heads = nn.ModuleList([nn.Linear(dense_units, 2 * sum(self.actions_dim), device=device)])
        else:
            self.heads = nn.ModuleList(nn.Linear(dense_units, d, device=device) for d in self.actions_dim)

    def _dist_name(self) -> str:
        if self.distribution == "auto":
            return "scaled_normal" if self.is_continuous else "discrete"
        return self.distribution

    def _uniform_mix(self, logits: torch.Tensor) -> torch.Tensor:
        if self.unimix > 0.0:
            probs = torch.softmax(logits, -1)
            probs = (1 - self.unimix) * probs + self.unimix * (torch.ones_like(probs) / probs.shape[-1])
            logits = torch.log(probs)
        return logits

    def forward(
        self,
        state: torch.Tensor,
        greedy: bool = False,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        x = self.trunk(state).float()  # distribution heads in f32
        if self.is_continuous:
            mean, std = torch.chunk(self.heads[0](x), 2, -1)
            name = self._dist_name()
            if name == "tanh_normal":
                mean = 5 * torch.tanh(mean / 5)
                std = F.softplus(std + self.init_std) + self.min_std
                dist = Independent(TanhNormal(mean, std), 1)
            elif name == "normal":
                dist = Independent(Normal(mean, std), 1)
            elif name == "scaled_normal":
                std = (self.max_std - self.min_std) * torch.sigmoid(std + self.init_std) + self.min_std
                dist = Independent(Normal(torch.tanh(mean), std), 1)
            else:
                raise ValueError(f"Bad continuous distribution: {name}")
            actions = dist.mean if greedy else dist.rsample(noise, generator)
            if self.action_clip > 0.0:
                clip = torch.full_like(actions, self.action_clip)
                actions = actions * (clip / torch.maximum(clip, torch.abs(actions))).detach()
            return (actions,), (dist,)
        noises = (
            torch.split(noise, list(self.actions_dim), -1) if noise is not None else [None] * len(self.heads)
        )
        actions, dists = [], []
        for head, n in zip(self.heads, noises):
            d = OneHotCategoricalStraightThrough(logits=self._uniform_mix(head(x)))
            dists.append(d)
            actions.append(d.mode if greedy else d.rsample(n, generator))
        return tuple(actions), tuple(dists)


class WorldModel(nn.Module):
    """The world-model modules the player runs (encoder + RSSM)."""

    def __init__(self, encoder: MultiEncoderDV3, rssm: RSSM):
        super().__init__()
        self.encoder = encoder
        self.rssm = rssm


class DreamerPlayer(nn.Module):
    """``{"world_model": ..., "actor": ...}``: the modules a served policy
    holds, laid out like the JAX package's player parameter tree."""

    def __init__(self, world_model: WorldModel, actor: Actor):
        super().__init__()
        self.world_model = world_model
        self.actor = actor


class PlayerDV3:
    """Stateful env-interaction wrapper: carries per-env (actions,
    recurrent_state, stochastic_state) and resets envs on request."""

    def __init__(
        self,
        agent: DreamerPlayer,
        actions_dim: Sequence[int],
        num_envs: int,
        stochastic_size: int,
        recurrent_state_size: int,
        discrete_size: int = 32,
        decoupled_rssm: bool = False,
    ):
        self.agent = agent
        self.actions_dim = tuple(actions_dim)
        self.num_envs = int(num_envs)
        self.stochastic_size = int(stochastic_size)
        self.discrete_size = int(discrete_size)
        self.recurrent_state_size = int(recurrent_state_size)
        self.decoupled_rssm = bool(decoupled_rssm)
        self.device = next(agent.parameters()).device
        self.init_states()

    @torch.no_grad()
    def init_states(self, reset_envs: Optional[Sequence[int]] = None) -> None:
        rssm = self.agent.world_model.rssm
        if reset_envs is None or len(reset_envs) == 0:
            self.actions = torch.zeros(1, self.num_envs, int(np.sum(self.actions_dim)), device=self.device)
            rec, stoch = rssm.get_initial_states((1, self.num_envs))
            self.recurrent_state = rec.clone()
            self.stochastic_state = stoch.reshape(1, self.num_envs, -1).clone()
        else:
            idx = torch.as_tensor(list(reset_envs), device=self.device)
            self.actions[:, idx] = 0.0
            rec, stoch = rssm.get_initial_states((1, len(idx)))
            self.recurrent_state[:, idx] = rec
            self.stochastic_state[:, idx] = stoch.reshape(1, len(idx), -1)

    @torch.no_grad()
    def get_actions(
        self,
        obs: Dict[str, torch.Tensor],
        greedy: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, ...]:
        wm, actor = self.agent.world_model, self.agent.actor
        embedded = wm.encoder(obs)
        self.recurrent_state = wm.rssm.recurrent_step(
            torch.cat([self.stochastic_state, self.actions], -1), self.recurrent_state
        )
        rec = None if self.decoupled_rssm else self.recurrent_state
        _, stoch = wm.rssm._representation(embedded, rec, generator=generator)
        self.stochastic_state = stoch.reshape(*stoch.shape[:-2], self.stochastic_size * self.discrete_size)
        actions, _ = actor(torch.cat([self.stochastic_state, self.recurrent_state], -1), greedy, generator=generator)
        self.actions = torch.cat(actions, -1)
        return actions


def build_agent(
    runtime,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
) -> DreamerPlayer:
    """The player modules (encoder, RSSM, actor) on ``runtime.device``,
    initialised from the torch RNG (``runtime`` seeds it).

    ``obs_space`` maps each observation key to anything with a ``shape``
    (NHWC for images).  Load trained weights with
    :func:`sheeprl_tpu_torch.utils.convert.flax_to_torch`."""
    wm_cfg = cfg.algo.world_model
    actor_cfg = cfg.algo.actor
    device = runtime.device
    dtype = runtime.compute_dtype

    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    cnn_stages = int(np.log2(cfg.env.screen_size) - np.log2(4))

    cnn_encoder = (
        CNNEncoder(
            keys=cnn_keys,
            in_channels=int(sum(obs_space[k].shape[-1] for k in cnn_keys)),
            channels_multiplier=int(wm_cfg.encoder.cnn_channels_multiplier),
            stages=cnn_stages,
            layer_norm=_ln_enabled(wm_cfg.encoder.cnn_layer_norm),
            eps=_ln_eps(wm_cfg.encoder.cnn_layer_norm),
            act="silu",
            dtype=dtype,
            device=device,
        )
        if cnn_keys
        else None
    )
    mlp_encoder = (
        MLPEncoder(
            keys=mlp_keys,
            in_features=int(sum(obs_space[k].shape[0] for k in mlp_keys)),
            mlp_layers=int(wm_cfg.encoder.mlp_layers),
            dense_units=int(wm_cfg.encoder.dense_units),
            layer_norm=_ln_enabled(wm_cfg.encoder.mlp_layer_norm),
            eps=_ln_eps(wm_cfg.encoder.mlp_layer_norm),
            dtype=dtype,
            device=device,
        )
        if mlp_keys
        else None
    )
    encoder = MultiEncoderDV3(cnn_encoder, mlp_encoder)
    cnn_out = (2 ** (cnn_stages - 1)) * int(wm_cfg.encoder.cnn_channels_multiplier) * 16 if cnn_keys else 0
    mlp_out = int(wm_cfg.encoder.dense_units) if mlp_keys else 0

    rssm = RSSM(
        actions_dim=tuple(actions_dim),
        embedded_obs_dim=cnn_out + mlp_out,
        recurrent_state_size=recurrent_state_size,
        dense_units=int(wm_cfg.recurrent_model.dense_units),
        stochastic_size=int(wm_cfg.stochastic_size),
        discrete_size=int(wm_cfg.discrete_size),
        hidden_size=int(wm_cfg.transition_model.hidden_size),
        unimix=float(cfg.algo.unimix),
        layer_norm=_ln_enabled(wm_cfg.recurrent_model.layer_norm),
        eps=_ln_eps(wm_cfg.recurrent_model.layer_norm),
        learnable_initial_recurrent_state=bool(wm_cfg.learnable_initial_recurrent_state),
        decoupled=bool(wm_cfg.decoupled_rssm),
        fused_gru=bool(wm_cfg.recurrent_model.get("fused", False)),
        dtype=dtype,
        device=device,
    )
    actor = Actor(
        latent_state_size=stoch_flat + recurrent_state_size,
        actions_dim=tuple(actions_dim),
        is_continuous=is_continuous,
        distribution=cfg.distribution.get("type", "auto"),
        init_std=float(actor_cfg.init_std),
        min_std=float(actor_cfg.min_std),
        max_std=float(actor_cfg.get("max_std", 1.0)),
        dense_units=int(actor_cfg.dense_units),
        mlp_layers=int(actor_cfg.mlp_layers),
        layer_norm=_ln_enabled(actor_cfg.layer_norm),
        eps=_ln_eps(actor_cfg.layer_norm),
        unimix=float(cfg.algo.unimix),
        action_clip=float(actor_cfg.action_clip),
        dtype=dtype,
        device=device,
    )
    return DreamerPlayer(WorldModel(encoder, rssm), actor).eval()

"""DreamerV3 as torch modules.

Counterpart of ``sheeprl_tpu/algos/dreamer_v3/agent.py``: ``LinearLnAct``,
``DreamerMLP``, the encoders and decoders, ``RecurrentModel``,
``compute_stochastic_state``, ``RSSM`` (recurrent step, representation,
transition, initial states, the training scan's ``dynamic_posterior`` and
``imagination``, and the decoupled RSSM's ``recurrent_features_seq``,
``gru_step_gated`` and ``gru_sequence_gated``), ``Actor``, ``PlayerDV3`` and ``build_agent``, which
builds the world model with its observation, reward and continue models,
the actor, the critic and a target critic that starts as a copy.
:func:`build_player` builds only what the session server runs.

Parameters start from the JAX package's initialisers in distribution
(Hafner's: truncated normal, fan-average scaling on every trunk layer,
uniform fan-average on the distribution heads, zeros on the reward and
critic heads, flax's LeCun normal on the GRU's dense).

Layouts at the module boundaries are the JAX package's: observations are
NHWC, and the conv features are flattened in (H, W, C) order, so that the
representation model's first weight rows line up with converted
parameters.  Inside, convolutions run NCHW and the conv LayerNorm is over
channels.  Sampling takes explicit noise or an explicit ``torch.Generator``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.models.models import LayerNorm, LayerNormGRUCell, flax_init_, ln_act_apply, resolve_activation
from sheeprl_tpu_torch.ops.seq_gru import gru_sequence
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
    "CNNDecoder",
    "CNNEncoder",
    "DreamerAgent",
    "DreamerMLP",
    "DreamerPlayer",
    "LinearLnAct",
    "MLPDecoder",
    "MLPEncoder",
    "MultiDecoderDV3",
    "MultiEncoderDV3",
    "PlayerDV3",
    "RSSM",
    "RecurrentModel",
    "WorldModel",
    "build_actor",
    "build_agent",
    "build_critic",
    "build_player",
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
        flax_init_(self.dense.weight, "trunc")
        if self.dense.bias is not None:
            nn.init.zeros_(self.dense.bias)
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
        out_init: str = "trunc",
    ):
        super().__init__()
        dims = [in_features] + [units] * layers
        self.layers = nn.ModuleList(
            LinearLnAct(dims[i], units, layer_norm, eps, act, dtype, device) for i in range(layers)
        )
        self.head = nn.Linear(dims[-1], output_dim, device=device) if output_dim is not None else None
        if self.head is not None:
            flax_init_(self.head.weight, out_init)
            nn.init.zeros_(self.head.bias)

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
        for conv in self.convs:
            flax_init_(conv.weight, "trunc")
            if conv.bias is not None:
                nn.init.zeros_(conv.bias)
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


class CNNDecoder(nn.Module):
    """Dense projection -> (4, 4, 2^(stages-1) * mult) -> transposed convs
    back to (H, W, sum(channels)), NHWC out, split per image key.

    flax's ``ConvTranspose(4, stride 2, padding ((2, 2), (2, 2)))`` does
    not flip its kernel; ``torch``'s transposed convolution is the true
    transpose, so each layer here is ``conv_transpose2d(padding=1)`` with
    the (kh, kw, in, out) flax kernel flipped in both spatial axes
    (``utils/convert.py``).  The LayerNorms are over channels."""

    def __init__(
        self,
        keys: Sequence[str],
        output_channels: Sequence[int],
        channels_multiplier: int,
        latent_state_size: int,
        cnn_encoder_output_dim: int,
        stages: int = 4,
        layer_norm: bool = True,
        eps: float = 1e-3,
        act: Any = "silu",
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.act = act
        self.dtype = dtype
        self.dense = nn.Linear(latent_state_size, cnn_encoder_output_dim, device=device)
        flax_init_(self.dense.weight, "trunc")
        nn.init.zeros_(self.dense.bias)
        chans = [(2 ** (stages - i - 1)) * channels_multiplier for i in range(stages)] + [sum(self.output_channels)]
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(
                chans[i], chans[i + 1], 4, stride=2, padding=1,
                bias=not layer_norm or i == stages - 1, device=device,
            )
            for i in range(stages)
        )
        for i, deconv in enumerate(self.deconvs):
            flax_init_(deconv.weight, "uniform" if i == stages - 1 else "trunc")
            if deconv.bias is not None:
                nn.init.zeros_(deconv.bias)
        self.norms = (
            nn.ModuleList(LayerNorm(chans[i + 1], eps, device=device) for i in range(stages - 1))
            if layer_norm
            else None
        )

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = _linear(latent, self.dense, self.dtype)
        lead = x.shape[:-1]
        x = x.reshape(-1, 4, 4, self.deconvs[0].in_channels).permute(0, 3, 1, 2)
        last = len(self.deconvs) - 1
        for i, deconv in enumerate(self.deconvs):
            # the last layer emits f32 for the reconstruction distributions
            dt = torch.float32 if i == last else self.dtype
            w = deconv.weight if dt == torch.float32 else deconv.weight.to(dt)
            b = deconv.bias if deconv.bias is None or dt == torch.float32 else deconv.bias.to(dt)
            x = F.conv_transpose2d(x.to(dt), w, b, stride=2, padding=1)
            if i == last:
                break
            if self.norms is not None:
                x = ln_act_apply(self.norms[i], x, act=self.act, dtype=self.dtype, dim=1)
            else:
                x = resolve_activation(self.act)(x.to(self.dtype))
        x = x.permute(0, 2, 3, 1)
        x = x.reshape(*lead, *x.shape[1:])
        return dict(zip(self.keys, torch.split(x, list(self.output_channels), -1)))


class MLPDecoder(nn.Module):
    def __init__(
        self,
        keys: Sequence[str],
        output_dims: Sequence[int],
        latent_state_size: int,
        mlp_layers: int = 4,
        dense_units: int = 512,
        layer_norm: bool = True,
        eps: float = 1e-3,
        act: Any = "silu",
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = DreamerMLP(latent_state_size, dense_units, mlp_layers, None, layer_norm, eps, act, dtype, device)
        self.heads = nn.ModuleList(nn.Linear(dense_units, int(d), device=device) for d in output_dims)
        for head in self.heads:
            flax_init_(head.weight, "uniform")
            nn.init.zeros_(head.bias)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(latent).float()  # heads emit f32 for the distributions
        return {k: head(x) for k, head in zip(self.keys, self.heads)}


class MultiDecoderDV3(nn.Module):
    def __init__(self, cnn_decoder: Optional[CNNDecoder], mlp_decoder: Optional[MLPDecoder]):
        super().__init__()
        self.cnn_decoder = cnn_decoder
        self.mlp_decoder = mlp_decoder

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_decoder is not None:
            out.update(self.cnn_decoder(latent))
        if self.mlp_decoder is not None:
            out.update(self.mlp_decoder(latent))
        return out


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
        fused_seq: bool = False,
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
        self.fused_seq = bool(fused_seq)
        # the sequence op of gru_sequence_gated; a comparison may set it to
        # gru_sequence_plain to run the plain version on the card
        self.seq_impl = gru_sequence
        self.layer_norm = bool(layer_norm)
        self.act = act
        self.dtype = dtype
        self.recurrent_model = RecurrentModel(
            stoch + int(np.sum(actions_dim)), recurrent_state_size, dense_units, layer_norm, eps,
            fused_gru, dtype, device,
        )
        rep_in = embedded_obs_dim if decoupled else recurrent_state_size + embedded_obs_dim
        self.representation_model = DreamerMLP(
            rep_in, hidden_size, 1, stoch, layer_norm, eps, act, dtype, device, out_init="uniform"
        )
        self.transition_model = DreamerMLP(
            recurrent_state_size, hidden_size, 1, stoch, layer_norm, eps, act, dtype, device, out_init="uniform"
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

    # ---- the training scans (``make_train_fn``)
    def representation_embed_proj(self, embedded_obs: torch.Tensor) -> torch.Tensor:
        """The embed half of the representation model's first product,
        batched over the whole sequence outside the dynamic scan."""
        dense = self.representation_model.layers[0].dense
        k_e = dense.weight[:, self.recurrent_state_size :]
        k_e = k_e if self.dtype == torch.float32 else k_e.to(self.dtype)
        out = embedded_obs.to(self.dtype) @ k_e.t()
        if not self.layer_norm:
            out = out + dense.bias.to(self.dtype)
        return out

    def _representation_from_proj(
        self,
        emb_proj: torch.Tensor,
        recurrent_state: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior from a precomputed embed projection: the h-side product
        is added to ``emb_proj`` before the LayerNorm."""
        block = self.representation_model.layers[0]
        k_h = block.dense.weight[:, : self.recurrent_state_size]
        k_h = k_h if self.dtype == torch.float32 else k_h.to(self.dtype)
        x = recurrent_state.to(self.dtype) @ k_h.t() + emb_proj
        if block.norm is not None:
            x = ln_act_apply(block.norm, x, act=self.act, dtype=self.dtype)
        else:
            x = resolve_activation(self.act)(x.to(self.dtype))
        logits = self._uniform_mix(self.representation_model.head(x.float()))
        return logits, compute_stochastic_state(logits, self.discrete_size, noise=noise, generator=generator)

    def dynamic_posterior(
        self,
        posterior: torch.Tensor,
        recurrent_state: torch.Tensor,
        action: torch.Tensor,
        emb_proj: torch.Tensor,
        is_first: torch.Tensor,
        init_states: Tuple[torch.Tensor, torch.Tensor],
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """One step of the dynamic scan with ``is_first``-gated resets:
        -> (recurrent_state, posterior, posterior_logits)."""
        init_rec, init_post = init_states
        action = (1 - is_first) * action
        recurrent_state = (1 - is_first) * recurrent_state + is_first * init_rec
        posterior = posterior.reshape(*posterior.shape[:-2], -1)
        posterior = (1 - is_first) * posterior + is_first * init_post.reshape(posterior.shape)
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        posterior_logits, posterior = self._representation_from_proj(
            emb_proj, recurrent_state, noise=noise, generator=generator
        )
        return recurrent_state, posterior, posterior_logits

    # ---- the decoupled RSSM's training scan: posteriors come from the
    # embedded observations alone, so only the GRU is sequential
    def recurrent_features_seq(
        self,
        prev_posteriors: torch.Tensor,
        actions: torch.Tensor,
        is_first: torch.Tensor,
        init_post: torch.Tensor,
    ) -> torch.Tensor:
        """The recurrent model's ``LinearLnAct`` projection of the
        ``is_first``-gated ``[z_{t-1}, a_t]``, batched over the whole (T, B)
        sequence.  ``init_post`` is (B, S, D) or (B, S*D)."""
        prev = prev_posteriors.reshape(*prev_posteriors.shape[:-2], -1)
        prev = (1 - is_first) * prev + is_first * init_post.reshape(init_post.shape[0], -1)
        actions = (1 - is_first) * actions
        return self.recurrent_model.mlp(torch.cat([prev, actions], -1))

    def gru_step_gated(
        self, feat: torch.Tensor, recurrent_state: torch.Tensor, is_first: torch.Tensor, init_rec: torch.Tensor
    ) -> torch.Tensor:
        """One step of the sequential residue: the ``is_first``-gated state
        reset and one GRU cell step on a projected input."""
        recurrent_state = (1 - is_first) * recurrent_state + is_first * init_rec
        return self.recurrent_model.gru(recurrent_state, feat).float()

    def seq_scan_eligible(self, feat_dim: int) -> bool:
        """Does the dynamic recurrence run as one :func:`gru_sequence`?

        JAX's rule and numbers (``seq_gru.py:fits_vmem``), so that both
        packages take the same route at every size: ``fused_seq``, H and X
        multiples of 128, and the (H + X, 3H) weight within 10 MB in the
        compute dtype.  On Hopper the op then takes one of two kernels
        (``ops/seq_gru.py:sequence_route``): where W[:H] and the state fit
        16 blocks (H <= 512 at B <= 16; 192 KB of W and 32 KB of state a
        block at DV3-S), the cluster route keeps W[:H] in shared memory and
        multiplies xs by W[H:] for all steps before the recurrence; else the
        cooperative grid keeps one column slice of the whole W a block, up
        to about 79 KB on each of 132 SMs at the 10 MB limit."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        hidden = self.recurrent_state_size
        return (
            self.fused_seq
            and hidden % 128 == 0
            and feat_dim % 128 == 0
            and (hidden + feat_dim) * 3 * hidden * itemsize <= 10 * 2**20
        )

    def gru_sequence_gated(self, feats: torch.Tensor, is_first: torch.Tensor, init_rec: torch.Tensor) -> torch.Tensor:
        """The whole decoupled recurrence, (T, B, X) projected inputs ->
        (T, B, H) states, in one launch of the sequence kernel
        (``ops/seq_gru.py``): the same as looping :meth:`gru_step_gated`
        over ``feats`` from a zero state, with the one-pass LayerNorm."""
        cell = self.recurrent_model.gru
        w = cell.weight if self.dtype == torch.float32 else cell.weight.to(self.dtype)
        h0 = torch.zeros(feats.shape[1], self.recurrent_state_size, device=feats.device)
        return self.seq_impl(h0, feats, w, cell.norm.weight, cell.norm.bias, is_first, init_rec, eps=cell.norm.eps)

    def imagination(
        self,
        prior: torch.Tensor,
        recurrent_state: torch.Tensor,
        actions: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One imagination step: -> (prior sample, recurrent state)."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], -1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, noise=noise, generator=generator)
        return imagined_prior, recurrent_state


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
        for head in self.heads:
            flax_init_(head.weight, "uniform")
            nn.init.zeros_(head.bias)

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
    """The world-model modules: encoder and RSSM (all the player runs),
    and for training the observation, reward and continue models."""

    def __init__(
        self,
        encoder: MultiEncoderDV3,
        rssm: RSSM,
        observation_model: Optional[MultiDecoderDV3] = None,
        reward_model: Optional[DreamerMLP] = None,
        continue_model: Optional[DreamerMLP] = None,
    ):
        super().__init__()
        self.encoder = encoder
        self.rssm = rssm
        self.observation_model = observation_model
        self.reward_model = reward_model
        self.continue_model = continue_model


class DreamerPlayer(nn.Module):
    """``{"world_model": ..., "actor": ...}``: the modules a served policy
    holds, laid out like the JAX package's player parameter tree."""

    def __init__(self, world_model: WorldModel, actor: Actor):
        super().__init__()
        self.world_model = world_model
        self.actor = actor


class DreamerAgent(nn.Module):
    """Everything training updates, laid out like the JAX package's
    ``params`` tree: ``world_model`` (encoder, rssm, observation_model,
    reward_model, continue_model), ``actor``, ``critic`` and
    ``target_critic`` (an EMA copy of the critic that no optimizer
    touches)."""

    def __init__(self, world_model: WorldModel, actor: Actor, critic: DreamerMLP, target_critic: DreamerMLP):
        super().__init__()
        self.world_model = world_model
        self.actor = actor
        self.critic = critic
        self.target_critic = target_critic
        self.target_critic.requires_grad_(False)

    def player(self) -> DreamerPlayer:
        """The player's modules (encoder, RSSM, actor), shared with this agent."""
        wm = self.world_model
        return DreamerPlayer(WorldModel(wm.encoder, wm.rssm), self.actor)

    def target_pairs(self):
        """Every (target, online) critic pair that the training block's EMA updates."""
        return [(self.target_critic, self.critic)]


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

    @property
    def is_continuous(self) -> bool:
        return bool(self.agent.actor.is_continuous)

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
        mask: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """One step of every env's state and its actions.  ``mask`` is the
        action-mask observations the loops pass; the player does not apply
        them, as the JAX package's ``PlayerDV3`` does not (MineDojo masks:
        ROADMAP A4)."""
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


def _player_modules(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space):
    """Encoder, RSSM and actor, and the sizes the rest of the agent needs."""
    wm_cfg = cfg.algo.world_model
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
        fused_seq=bool(wm_cfg.recurrent_model.get("fused_seq", False)),
        dtype=dtype,
        device=device,
    )
    actor = build_actor(runtime, actions_dim, is_continuous, cfg)
    sizes = {"latent": stoch_flat + recurrent_state_size, "cnn_out": cnn_out, "cnn_stages": cnn_stages}
    return encoder, rssm, actor, sizes


def build_actor(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg) -> Actor:
    """The actor of ``cfg.algo.actor`` on ``runtime.device``, initialised from the torch RNG."""
    wm_cfg = cfg.algo.world_model
    actor_cfg = cfg.algo.actor
    latent = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    return Actor(
        latent_state_size=latent,
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
        dtype=runtime.compute_dtype,
        device=runtime.device,
    )


def build_critic(runtime, cfg) -> DreamerMLP:
    """A critic of ``cfg.algo.critic`` (two-hot bins, a zero head) on ``runtime.device``."""
    wm_cfg = cfg.algo.world_model
    node = cfg.algo.critic
    latent = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    return DreamerMLP(
        latent, int(node.dense_units), int(node.mlp_layers), int(node.bins), _ln_enabled(node.layer_norm),
        _ln_eps(node.layer_norm), "silu", runtime.compute_dtype, runtime.device, out_init="zeros",
    )


def build_player(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space) -> DreamerPlayer:
    """The player modules (encoder, RSSM, actor) on ``runtime.device``,
    initialised from the torch RNG (``runtime`` seeds it): what the session
    server runs.  ``obs_space`` maps each observation key to anything with a
    ``shape`` (NHWC for images).  Load trained weights with
    :func:`sheeprl_tpu_torch.utils.convert.load_flax_params`."""
    encoder, rssm, actor, _ = _player_modules(runtime, actions_dim, is_continuous, cfg, obs_space)
    return DreamerPlayer(WorldModel(encoder, rssm), actor).eval()


def build_agent(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space) -> DreamerAgent:
    """The whole DreamerV3 agent (``agent.py:build_agent``): the world model
    with its observation, reward and continue models, the actor, the critic
    and a target critic that starts as a copy of the critic, on
    ``runtime.device`` and initialised from the torch RNG."""
    wm_cfg = cfg.algo.world_model
    device = runtime.device
    dtype = runtime.compute_dtype
    encoder, rssm, actor, sizes = _player_modules(runtime, actions_dim, is_continuous, cfg, obs_space)
    latent = sizes["latent"]
    cnn_dec_keys = tuple(cfg.algo.cnn_keys.decoder)
    mlp_dec_keys = tuple(cfg.algo.mlp_keys.decoder)
    obs_cfg = wm_cfg.observation_model
    cnn_decoder = (
        CNNDecoder(
            keys=cnn_dec_keys,
            output_channels=[int(obs_space[k].shape[-1]) for k in cnn_dec_keys],
            channels_multiplier=int(obs_cfg.cnn_channels_multiplier),
            latent_state_size=latent,
            cnn_encoder_output_dim=sizes["cnn_out"],
            stages=sizes["cnn_stages"],
            layer_norm=_ln_enabled(obs_cfg.cnn_layer_norm),
            eps=_ln_eps(obs_cfg.cnn_layer_norm),
            dtype=dtype,
            device=device,
        )
        if cnn_dec_keys
        else None
    )
    mlp_decoder = (
        MLPDecoder(
            keys=mlp_dec_keys,
            output_dims=[int(obs_space[k].shape[0]) for k in mlp_dec_keys],
            latent_state_size=latent,
            mlp_layers=int(obs_cfg.mlp_layers),
            dense_units=int(obs_cfg.dense_units),
            layer_norm=_ln_enabled(obs_cfg.mlp_layer_norm),
            eps=_ln_eps(obs_cfg.mlp_layer_norm),
            dtype=dtype,
            device=device,
        )
        if mlp_dec_keys
        else None
    )

    def head(node, output_dim: int, out_init: str) -> DreamerMLP:
        return DreamerMLP(
            latent, int(node.dense_units), int(node.mlp_layers), output_dim, _ln_enabled(node.layer_norm),
            _ln_eps(node.layer_norm), "silu", dtype, device, out_init=out_init,
        )

    reward_model = head(wm_cfg.reward_model, int(wm_cfg.reward_model.bins), "zeros")
    continue_model = head(wm_cfg.discount_model, 1, "uniform")
    critic = build_critic(runtime, cfg)
    world_model = WorldModel(encoder, rssm, MultiDecoderDV3(cnn_decoder, mlp_decoder), reward_model, continue_model)
    return DreamerAgent(world_model, actor, critic, copy.deepcopy(critic))

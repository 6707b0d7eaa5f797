"""The SAC-AE agent as torch modules (counterpart of
``sheeprl_tpu/algos/sac_ae/agent.py``; arXiv:1910.01741).

- :class:`AECNNEncoder`: the conv stack (``[32] * 4 * mult`` channels,
  kernel 3, strides 2, 1, 1, 1, VALID, ReLU; NHWC in, features flattened in
  (H, W, C) order) and its head (:class:`AEFeatureHead`: dense ->
  LayerNorm -> tanh); :class:`AEMLPEncoder`: dense (-> LayerNorm) -> ReLU
  layers.  :class:`SACAEEncoder` holds either or both and concatenates
  their features.
- :class:`AECNNDecoder`: a dense layer to the conv output's (s, s, 32 *
  mult), three VALID transposed convs of stride 1 with ReLU, and a stride-2
  one whose output padding 1 is flax's explicit ((2, 3), (2, 3)) pads;
  :class:`AEMLPDecoder`: ReLU layers and a head a key.  flax's transposed
  convolution does not flip its kernel and torch's does: the converter flips
  it (``utils/convert.py``).
- :class:`SACAECritic`: an encoder and the Q ensemble (:class:`~sheeprl_tpu_torch.algos.sac.agent.SACCritic`,
  its N critics stacked, every critic one batched product a layer) on
  (features, action); the agent's ``target`` is a copy, updated by EMA.
- :class:`SACAEActor`: its own conv head over the critic encoder's conv
  features, detached, the critic encoder's MLP features, detached, and the
  trunk (two ReLU layers, a mean and a log-std head, the log-std squashed
  by tanh into [LOG_STD_MIN, LOG_STD_MAX]).
- :class:`SACAEAgent`: ``critic``, ``target``, ``actor``, ``decoder`` and
  ``log_alpha``, laid out like the JAX package's ``params``.

Initialisation follows the JAX package in distribution: orthogonal dense
kernels, delta-orthogonal conv kernels (an orthogonal centre tap with ReLU's
gain), zero biases.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.sac.agent import SACCritic
from sheeprl_tpu_torch.models.models import LayerNorm

__all__ = [
    "LOG_STD_MAX",
    "LOG_STD_MIN",
    "AECNNDecoder",
    "AECNNEncoder",
    "AEFeatureHead",
    "AEMLPDecoder",
    "AEMLPEncoder",
    "SACAEActor",
    "SACAEAgent",
    "SACAECritic",
    "SACAEDecoder",
    "SACAEEncoder",
    "SACAEPlayer",
    "actions_and_log_probs",
    "build_agent",
    "greedy_actions",
]

LOG_STD_MIN = -10.0
LOG_STD_MAX = 2.0


def _dense(din: int, dout: int, device=None) -> nn.Linear:
    layer = nn.Linear(din, dout, device=device)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight)
        nn.init.zeros_(layer.bias)
    return layer


@torch.no_grad()
def _delta_orthogonal_(weight: torch.Tensor, transposed: bool = False) -> None:
    """A zero kernel with an orthogonal (in, out) centre tap, ReLU's gain."""
    weight.zero_()
    cin, cout = (weight.shape[0], weight.shape[1]) if transposed else (weight.shape[1], weight.shape[0])
    centre = nn.init.orthogonal_(torch.empty(cin, cout, device=weight.device), gain=math.sqrt(2.0))
    k = weight.shape[-1] // 2
    weight[:, :, k, k] = centre if transposed else centre.T


class AEFeatureHead(nn.Module):
    """Dense(features_dim) -> LayerNorm (eps 1e-6) -> tanh."""

    def __init__(self, in_features: int, features_dim: int, device=None):
        super().__init__()
        self.dense = _dense(in_features, features_dim, device)
        self.norm = LayerNorm(features_dim, 1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.norm(self.dense(x)))


class AEConvStack(nn.Module):
    """``[32] * 4 * mult`` channels, kernel 3, strides 2, 1, 1, 1, VALID,
    ReLU; NHWC in, flattened (H, W, C) out."""

    STRIDES = (2, 1, 1, 1)

    def __init__(self, in_channels: int, channels_multiplier: int = 1, device=None):
        super().__init__()
        c = 32 * int(channels_multiplier)
        chans = [int(in_channels)] + [c] * 4
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, stride=s, device=device)
                                   for i, s in enumerate(self.STRIDES))
        for conv in self.convs:
            _delta_orthogonal_(conv.weight)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)


def conv_output_size(screen_size: int) -> int:
    """The conv stack's output side for ``screen_size`` x ``screen_size`` images."""
    return (int(screen_size) - 3) // 2 + 1 - 6


class AECNNEncoder(nn.Module):
    def __init__(self, keys: Sequence[str], in_channels: int, screen_size: int, features_dim: int,
                 channels_multiplier: int = 1, device=None):
        super().__init__()
        self.keys = tuple(keys)
        side = conv_output_size(screen_size)
        self.conv_output_shape = (side, side, 32 * int(channels_multiplier))
        self.convnet = AEConvStack(in_channels, channels_multiplier, device)
        self.head = AEFeatureHead(int(np.prod(self.conv_output_shape)), features_dim, device)

    def conv(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.convnet(torch.cat([obs[k] for k in self.keys], -1))

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.head(self.conv(obs))


class ReluMLP(nn.Module):
    """Dense (-> LayerNorm, eps 1e-6) -> ReLU layers."""

    def __init__(self, in_features: int, dense_units: int, mlp_layers: int, layer_norm: bool = False, device=None):
        super().__init__()
        dims = [int(in_features)] + [int(dense_units)] * int(mlp_layers)
        self.layers = nn.ModuleList(_dense(dims[i], dims[i + 1], device) for i in range(int(mlp_layers)))
        self.norms = nn.ModuleList(LayerNorm(int(dense_units), 1e-6, device=device) for _ in self.layers) \
            if layer_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = F.relu(x)
        return x


class AEMLPEncoder(nn.Module):
    def __init__(self, keys: Sequence[str], in_features: int, dense_units: int = 64, mlp_layers: int = 2,
                 layer_norm: bool = False, device=None):
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = ReluMLP(in_features, dense_units, mlp_layers, layer_norm, device)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([obs[k] for k in self.keys], -1))


class SACAEEncoder(nn.Module):
    """The conv and the MLP encoders (either may be None), features side by side."""

    sac_ae_group = "encoder"  # the converter's layout of this module's optimizer tree

    def __init__(self, cnn: Optional[AECNNEncoder], mlp: Optional[AEMLPEncoder]):
        super().__init__()
        self.cnn, self.mlp = cnn, mlp

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = ([self.cnn(obs)] if self.cnn is not None else []) + ([self.mlp(obs)] if self.mlp is not None else [])
        return torch.cat(feats, -1) if len(feats) > 1 else feats[0]


class AECNNDecoder(nn.Module):
    """The module docstring's conv decoder: NHWC out, split per image key."""

    def __init__(self, keys: Sequence[str], output_channels: Sequence[int], latent_dim: int,
                 conv_output_shape: Tuple[int, int, int], channels_multiplier: int = 1, device=None):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.conv_output_shape = tuple(int(d) for d in conv_output_shape)
        self.dense = _dense(latent_dim, int(np.prod(self.conv_output_shape)), device)
        c = 32 * int(channels_multiplier)
        self.deconvs = nn.ModuleList(
            [nn.ConvTranspose2d(self.conv_output_shape[-1] if i == 0 else c, c, 3, stride=1, device=device)
             for i in range(3)]
            + [nn.ConvTranspose2d(c, sum(self.output_channels), 3, stride=2, output_padding=1, device=device)]
        )
        for deconv in self.deconvs:
            _delta_orthogonal_(deconv.weight, transposed=True)
            nn.init.zeros_(deconv.bias)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        lead = latent.shape[:-1]
        x = self.dense(latent).reshape(-1, *self.conv_output_shape).permute(0, 3, 1, 2)
        for i, deconv in enumerate(self.deconvs):
            x = deconv(x)
            if i < len(self.deconvs) - 1:
                x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(*lead, *x.shape[2:], x.shape[1])
        return dict(zip(self.keys, torch.split(x, list(self.output_channels), -1)))


class AEMLPDecoder(nn.Module):
    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], latent_dim: int, dense_units: int = 64,
                 mlp_layers: int = 2, layer_norm: bool = False, device=None):
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = ReluMLP(latent_dim, dense_units, mlp_layers, layer_norm, device)
        self.heads = nn.ModuleList(_dense(int(dense_units), int(d), device) for d in output_dims)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(latent)
        return {k: head(x) for k, head in zip(self.keys, self.heads)}


class SACAEDecoder(nn.Module):
    """The conv and the MLP decoders (either may be None), outputs merged."""

    sac_ae_group = "decoder"

    def __init__(self, cnn: Optional[AECNNDecoder], mlp: Optional[AEMLPDecoder]):
        super().__init__()
        self.cnn, self.mlp = cnn, mlp

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for part in (self.cnn, self.mlp):
            if part is not None:
                out.update(part(latent))
        return out


class SACAECritic(nn.Module):
    """An encoder and the Q ensemble on (features, action): ``forward(obs,
    action)`` -> (B, N) q-values."""

    sac_ae_group = "critic"

    def __init__(self, encoder: SACAEEncoder, qfs: SACCritic):
        super().__init__()
        self.encoder, self.qfs = encoder, qfs

    def forward(self, obs: Dict[str, torch.Tensor], action: torch.Tensor) -> torch.Tensor:
        return self.qfs(self.encoder(obs), action)


class SACAEActorTrunk(nn.Module):
    def __init__(self, in_features: int, action_dim: int, hidden_size: int = 1024, device=None):
        super().__init__()
        self.layers = nn.ModuleList([_dense(in_features, hidden_size, device), _dense(hidden_size, hidden_size, device)])
        self.mean = _dense(hidden_size, action_dim, device)
        self.log_std = _dense(hidden_size, action_dim, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for layer in self.layers:
            x = F.relu(layer(x))
        log_std = torch.tanh(self.log_std(x))
        return self.mean(x), LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (log_std + 1)


class SACAEActor(nn.Module):
    """The actor's own conv head (None without image keys) and trunk, and
    the action bounds."""

    sac_ae_group = "actor"

    def __init__(self, cnn_head: Optional[AEFeatureHead], trunk: SACAEActorTrunk, action_low, action_high, device=None):
        super().__init__()
        self.cnn_head, self.trunk = cnn_head, trunk
        self.action_dim = int(trunk.mean.out_features)
        low = np.broadcast_to(np.asarray(action_low, np.float32), (self.action_dim,))
        high = np.broadcast_to(np.asarray(action_high, np.float32), (self.action_dim,))
        self.register_buffer("action_scale", torch.tensor((high - low) / 2.0, device=device), persistent=False)
        self.register_buffer("action_bias", torch.tensor((high + low) / 2.0, device=device), persistent=False)

    def features(self, encoder: SACAEEncoder, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The critic encoder's conv features through this actor's head and
        its MLP features, both detached from the encoder."""
        feats = []
        if encoder.cnn is not None:
            feats.append(self.cnn_head(encoder.cnn.conv(obs).detach()))
        if encoder.mlp is not None:
            feats.append(encoder.mlp(obs).detach())
        return torch.cat(feats, -1) if len(feats) > 1 else feats[0]


def actions_and_log_probs(actor: SACAEActor, encoder: SACAEEncoder, obs: Dict[str, torch.Tensor],
                          noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tanh-squashed reparameterised sample from the standard normals
    ``noise``, rescaled to the action bounds, and its log-prob (B, 1)."""
    mean, log_std = actor.trunk(actor.features(encoder, obs))
    std = torch.exp(log_std)
    x = mean + std * noise
    y = torch.tanh(x)
    action = y * actor.action_scale + actor.action_bias
    logp = -((x - mean) ** 2) / (2 * std**2) - log_std - 0.5 * math.log(2 * math.pi)
    logp = logp - torch.log(actor.action_scale * (1 - y**2) + 1e-6)
    return action, logp.sum(-1, keepdim=True)


def greedy_actions(actor: SACAEActor, encoder: SACAEEncoder, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    mean, _ = actor.trunk(actor.features(encoder, obs))
    return torch.tanh(mean) * actor.action_scale + actor.action_bias


class SACAEAgent(nn.Module):
    def __init__(self, critic: SACAECritic, actor: SACAEActor, decoder: SACAEDecoder, alpha: float):
        super().__init__()
        self.critic = critic
        self.target = copy.deepcopy(critic).requires_grad_(False)
        self.actor = actor
        self.decoder = decoder
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], device=critic.qfs.weights[0].device)))


class SACAEPlayer:
    """Env-interaction policy over the critic's encoder and the actor:
    observations through ``prepare_obs_fn`` (host numpy to a dict of
    tensors on the agent's device), actions back as tensors."""

    def __init__(self, agent: SACAEAgent, prepare_obs_fn: Callable[[Dict[str, Any]], Dict[str, np.ndarray]]):
        self.agent = agent
        self._prepare_obs = prepare_obs_fn

    @torch.no_grad()
    def get_actions(self, obs: Dict[str, Any], generator: Optional[torch.Generator] = None,
                    greedy: bool = False) -> torch.Tensor:
        actor, encoder = self.agent.actor, self.agent.critic.encoder
        device = actor.action_scale.device
        prepared = {k: torch.from_numpy(v).to(device) for k, v in self._prepare_obs(obs).items()}
        if greedy:
            return greedy_actions(actor, encoder, prepared)
        n = next(iter(prepared.values())).shape[0]
        noise = torch.randn((n, actor.action_dim), generator=generator, device=device)
        return actions_and_log_probs(actor, encoder, prepared, noise)[0]


def build_agent(runtime, cfg, obs_space, action_space):
    """-> (agent, target_entropy) on the runtime's device, initialised from
    the torch RNG.  ``obs_space`` maps each key to something with a
    ``shape`` (NHWC images); ``action_space`` has ``shape``, ``low`` and
    ``high``.  Raises as the JAX package does for screens too small for the
    conv stack or of odd size."""
    device = runtime.device
    algo = cfg.algo
    act_dim = int(np.prod(action_space.shape))
    cnn_keys, mlp_keys = tuple(algo.cnn_keys.encoder), tuple(algo.mlp_keys.encoder)
    enc_cfg, dec_cfg = algo.encoder, algo.decoder
    cnn = mlp = actor_head = None
    conv_shape = None
    if cnn_keys:
        screen = int(obs_space[cnn_keys[0]].shape[0])
        if conv_output_size(screen) <= 0:
            raise ValueError(f"screen_size {screen} too small for the SAC-AE conv stack")
        if screen % 2 != 0:
            raise ValueError("SAC-AE decoder requires an even env.screen_size")
        cnn = AECNNEncoder(cnn_keys, sum(int(obs_space[k].shape[-1]) for k in cnn_keys), screen,
                           int(enc_cfg.features_dim), int(enc_cfg.cnn_channels_multiplier), device)
        conv_shape = cnn.conv_output_shape
        actor_head = AEFeatureHead(int(np.prod(conv_shape)), int(enc_cfg.features_dim), device)
    if mlp_keys:
        mlp = AEMLPEncoder(mlp_keys, sum(int(obs_space[k].shape[0]) for k in mlp_keys), int(enc_cfg.dense_units),
                           int(enc_cfg.mlp_layers), bool(enc_cfg.layer_norm), device)
    features = (int(enc_cfg.features_dim) if cnn_keys else 0) + (int(enc_cfg.dense_units) if mlp_keys else 0)
    qfs = SACCritic(features + act_dim, int(algo.critic.hidden_size), int(algo.critic.n), device=device)
    with torch.no_grad():
        for w in qfs.weights:
            for member in w:
                member.copy_(nn.init.orthogonal_(torch.empty(member.shape[1], member.shape[0], device=device)).T)
    cnn_dec_keys, mlp_dec_keys = tuple(algo.cnn_keys.decoder), tuple(algo.mlp_keys.decoder)
    cnn_dec = AECNNDecoder(cnn_dec_keys, [int(obs_space[k].shape[-1]) for k in cnn_dec_keys], features, conv_shape,
                           int(dec_cfg.cnn_channels_multiplier), device) if cnn_dec_keys else None
    mlp_dec = AEMLPDecoder(mlp_dec_keys, [int(obs_space[k].shape[0]) for k in mlp_dec_keys], features,
                           int(dec_cfg.dense_units), int(dec_cfg.mlp_layers), bool(dec_cfg.layer_norm),
                           device) if mlp_dec_keys else None
    actor = SACAEActor(actor_head, SACAEActorTrunk(features, act_dim, int(algo.actor.hidden_size), device),
                       np.asarray(action_space.low), np.asarray(action_space.high), device)
    agent = SACAEAgent(SACAECritic(SACAEEncoder(cnn, mlp), qfs), actor, SACAEDecoder(cnn_dec, mlp_dec),
                       float(algo.alpha.alpha))
    return agent, -float(act_dim)

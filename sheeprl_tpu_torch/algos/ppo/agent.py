"""PPO agent as a torch module (counterpart of ``sheeprl_tpu/algos/ppo/agent.py``).

One module gives the actor heads' outputs and the critic's values from a
dict observation: ``feature_extractor`` (an MLP over the concatenated MLP
keys) feeds the critic MLP and the actor backbone, whose output feeds one
linear head per discrete sub-action, or one head of ``2 * sum(actions)``
(mean and log-std) for continuous actions.  Initialised as flax does
(``lecun_normal`` kernels, zero biases): the same distribution as the JAX
package's parameters, not the same values (``utils/convert.py`` carries
the JAX tree over).

Sampling never touches the global RNG: a discrete head draws
``argmax(logits + gumbel)`` (the Gumbel-max form of
``jax.random.categorical``) and a continuous one ``mean + std * normal``,
from noise the caller supplies or an explicit ``torch.Generator``.

The CNN encoder waits for ROADMAP A2 (the pixel envs).
"""

from __future__ import annotations

from math import prod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from sheeprl_tpu_torch.models.models import MLP
from sheeprl_tpu_torch.utils.distribution import Independent, Normal, OneHotCategorical, gumbel_noise, normal_noise

__all__ = [
    "MLPEncoder",
    "MultiEncoder",
    "PPOAgentModule",
    "PPOPlayer",
    "build_agent",
    "draw_policy_noise",
    "evaluate_actions",
    "get_values",
    "sample_actions",
]


class MLPEncoder(nn.Module):
    """The MLP keys concatenated on the feature axis, then an MLP of
    ``mlp_layers`` hidden layers and a ``features_dim`` output."""

    def __init__(self, input_dim: int, features_dim: int, keys: Sequence[str], dense_units: int = 64,
                 mlp_layers: int = 2, dense_act: str = "tanh", layer_norm: bool = False, device=None):
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = MLP(input_dim, (dense_units,) * mlp_layers, features_dim, dense_act, layer_norm, device=device)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([obs[k] for k in self.keys], -1))


class MultiEncoder(nn.Module):
    """``models.MultiEncoder`` with only its MLP half (the CNN half waits
    for ROADMAP A2)."""

    def __init__(self, mlp_encoder: MLPEncoder):
        super().__init__()
        self.mlp_encoder = mlp_encoder

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp_encoder(obs)


class PPOAgentModule(nn.Module):
    """MultiEncoder -> (actor backbone -> per-subaction heads, critic)."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        is_continuous: bool,
        mlp_keys: Sequence[str],
        obs_dims: Dict[str, int],
        encoder_cfg: Dict[str, Any],
        actor_cfg: Dict[str, Any],
        critic_cfg: Dict[str, Any],
        distribution: str = "auto",
        device=None,
    ):
        super().__init__()
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.mlp_keys = tuple(mlp_keys)
        self.distribution = distribution
        enc = encoder_cfg
        feat = int(enc["mlp_features_dim"])
        self.feature_extractor = MultiEncoder(
            MLPEncoder(
                sum(int(obs_dims[k]) for k in self.mlp_keys), feat, self.mlp_keys, int(enc["dense_units"]),
                int(enc["mlp_layers"]), enc["dense_act"], bool(enc["layer_norm"]), device=device,
            )
        )
        self.critic = MLP(
            feat, (int(critic_cfg["dense_units"]),) * int(critic_cfg["mlp_layers"]), 1, critic_cfg["dense_act"],
            bool(critic_cfg["layer_norm"]), device=device,
        )
        self.actor_backbone = MLP(
            feat, (int(actor_cfg["dense_units"]),) * int(actor_cfg["mlp_layers"]), None, actor_cfg["dense_act"],
            bool(actor_cfg["layer_norm"]), device=device,
        )
        head_in = int(actor_cfg["dense_units"]) if int(actor_cfg["mlp_layers"]) > 0 else feat
        outs = [sum(self.actions_dim) * 2] if self.is_continuous else list(self.actions_dim)
        self.actor_heads = nn.ModuleList(MLP._linear(head_in, d, device) for d in outs)

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feat = self.feature_extractor(obs)
        values = self.critic(feat)
        a = self.actor_backbone(feat)
        return [head(a) for head in self.actor_heads], values


def _normal(out: torch.Tensor) -> Independent:
    mean, log_std = torch.chunk(out, 2, dim=-1)
    return Independent(Normal(mean, torch.exp(log_std)), 1)


def evaluate_actions(
    agent: PPOAgentModule, obs: Dict[str, torch.Tensor], actions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logprobs, entropy, values) of the flat ``actions`` (the one-hots
    concatenated for discrete heads, the raw actions for continuous)."""
    actor_outs, values = agent(obs)
    if agent.is_continuous:
        dist = _normal(actor_outs[0])
        return dist.log_prob(actions)[..., None], dist.entropy()[..., None], values
    logprobs, entropies = [], []
    for logits, act in zip(actor_outs, torch.split(actions, list(agent.actions_dim), dim=-1)):
        d = OneHotCategorical(logits=logits)
        logprobs.append(d.log_prob(act))
        entropies.append(d.entropy())
    logprob = torch.stack(logprobs, -1).sum(-1, keepdim=True)
    entropy = torch.stack(entropies, -1).sum(-1, keepdim=True)
    return logprob, entropy, values


def draw_policy_noise(agent: PPOAgentModule, batch_shape, generator: Optional[torch.Generator], device) -> List[torch.Tensor]:
    """The noise :func:`sample_actions` consumes for a batch: Gumbel noise of
    each discrete head's width, or one standard normal of the action width."""
    like = torch.empty((), dtype=torch.float32, device=device)
    if agent.is_continuous:
        return [normal_noise((*batch_shape, sum(agent.actions_dim)), like=like, generator=generator)]
    return [gumbel_noise((*batch_shape, d), like=like, generator=generator) for d in agent.actions_dim]


def sample_actions(
    agent: PPOAgentModule,
    obs: Dict[str, torch.Tensor],
    noise: Optional[List[torch.Tensor]] = None,
    *,
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat_actions, real_actions, logprobs, values); ``real_actions`` are
    what the env takes (indices for discrete heads, raw for continuous).
    ``noise`` as :func:`draw_policy_noise` gives it; drawn from
    ``generator`` when not supplied and not greedy."""
    actor_outs, values = agent(obs)
    if noise is None and not greedy:
        noise = draw_policy_noise(agent, values.shape[:-1], generator, values.device)
    if agent.is_continuous:
        dist = _normal(actor_outs[0])
        act = dist.mean if greedy else dist.rsample(noise[0])
        return act, act, dist.log_prob(act)[..., None], values
    sub_actions, sub_real, logprobs = [], [], []
    for i, logits in enumerate(actor_outs):
        d = OneHotCategorical(logits=logits)
        a = d.mode if greedy else d.sample(noise[i])
        sub_actions.append(a)
        sub_real.append(torch.argmax(a, -1))
        logprobs.append(d.log_prob(a))
    flat = torch.cat(sub_actions, -1)
    real = torch.stack(sub_real, -1)
    return flat, real, torch.stack(logprobs, -1).sum(-1, keepdim=True), values


def get_values(agent: PPOAgentModule, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    return agent(obs)[1]


class PPOPlayer:
    """The agent with its observation preparation bound (``PPOPlayer`` of the
    JAX package): acts without gradients on the agent's device."""

    def __init__(self, agent: PPOAgentModule, prepare_obs_fn):
        self.agent = agent
        self._prepare_obs = prepare_obs_fn

    @torch.no_grad()
    def get_actions(self, obs, *, generator: Optional[torch.Generator] = None, greedy: bool = False):
        return sample_actions(self.agent, self._prepare_obs(obs), generator=generator, greedy=greedy)

    @torch.no_grad()
    def get_values(self, obs) -> torch.Tensor:
        return get_values(self.agent, self._prepare_obs(obs))


def build_agent(
    runtime,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Dict[str, Any],
    obs_space,
    agent_state: Optional[Any] = None,
) -> PPOAgentModule:
    """The agent on ``runtime.device``, initialised from the runtime's seed,
    or from ``agent_state`` (the JAX package's parameter tree, as a
    checkpoint holds it)."""
    distribution = cfg.distribution.get("type", "auto").lower()
    if distribution not in ("auto", "normal", "tanh_normal", "discrete"):
        raise ValueError(f"Unknown distribution: {distribution}")
    if distribution == "discrete" and is_continuous:
        raise ValueError("Discrete distribution chosen but the action space is continuous")
    if distribution not in ("discrete", "auto") and not is_continuous:
        raise ValueError("Continuous distribution chosen but the action space is discrete")
    if len(cfg.algo.cnn_keys.encoder) > 0:
        raise NotImplementedError("PPO's CNN encoder is not ported yet: ROADMAP A2 (the pixel envs)")
    if runtime.precision != "32-true":
        raise NotImplementedError(
            f"PPO/A2C at fabric.precision={runtime.precision} is not ported yet (ROADMAP A2); use 32-true"
        )
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    agent = PPOAgentModule(
        actions_dim,
        is_continuous,
        mlp_keys,
        {k: prod(obs_space[k].shape) for k in mlp_keys},
        dict(cfg.algo.encoder),
        dict(cfg.algo.actor),
        dict(cfg.algo.critic),
        distribution,
        device=runtime.device,
    )
    if agent_state is not None:
        from sheeprl_tpu_torch.utils.convert import load_flax_params

        load_flax_params(agent, agent_state)
    return agent

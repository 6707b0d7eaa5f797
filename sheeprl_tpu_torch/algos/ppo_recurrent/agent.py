"""Recurrent PPO agent as torch modules (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/agent.py``).

- :class:`ResetLSTM`: flax's ``OptimizedLSTMCell`` stepped over the time
  axis, its carry zeroed before each step where ``is_first`` is set
  (``_ResetLSTMCell``).  The gates are ``i, f, g, o = x W_i + h W_h + b_h``
  with sigmoid, sigmoid, tanh and sigmoid, no forget-gate offset, then
  ``c' = f c + i g`` and ``h' = o tanh(c')``.  The input product of all T
  steps is one ``x @ W_i`` before the loop (the input kernels have no
  bias); each step is one ``h @ W_h + b_h`` and the gates.  ``W_i`` (in, 4H)
  and ``W_h`` (H, 4H) keep flax's (in, out) layout with the four gates side
  by side in flax's order ``i, f, g, o``.  ``nn.LSTM`` is not used: cuDNN
  cannot reset the carry inside a sequence, and its gate layout is not
  flax's.
- :class:`RecurrentModel`: the optional pre-RNN dense layer, the LSTM, the
  optional post-RNN dense layer; it takes and returns the carry as
  ``(hx, cx)``.
- :class:`RecurrentPPOAgentModule`: the MLP encoder of the observation,
  the previous actions concatenated, the RNN, the critic MLP, the actor
  backbone and the heads (one of ``2 * sum(actions_dim)`` outputs for
  continuous actions, one a discrete dimension otherwise).

Noise is explicit, as in the PPO agent: supplied by the caller (the tests
feed the JAX package's draws) or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from math import prod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from sheeprl_tpu_torch.algos.ppo.agent import MLPEncoder, MultiEncoder, draw_policy_noise
from sheeprl_tpu_torch.models.models import MLP, lecun_normal_
from sheeprl_tpu_torch.utils.distribution import Independent, Normal, OneHotCategorical

__all__ = [
    "RecurrentModel",
    "RecurrentPPOAgentModule",
    "RecurrentPPOPlayer",
    "ResetLSTM",
    "build_agent",
    "evaluate_actions",
    "get_values",
    "sample_actions",
]


class ResetLSTM(nn.Module):
    """An LSTM over (T, B, D) inputs whose carry is zeroed where ``is_first``
    (T, B, 1) is set, before the step (see the module docstring)."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.hidden_size = int(hidden_size)
        h4 = 4 * self.hidden_size
        self.input_kernel = nn.Parameter(torch.empty(int(input_size), h4, device=device))
        self.hidden_kernel = nn.Parameter(torch.empty(self.hidden_size, h4, device=device))
        self.hidden_bias = nn.Parameter(torch.zeros(h4, device=device))
        # flax's initialisers in distribution: lecun_normal input kernels,
        # orthogonal recurrent kernels (one H x H block a gate), zero biases
        for j in range(4):
            cols = slice(j * self.hidden_size, (j + 1) * self.hidden_size)
            with torch.no_grad():
                self.input_kernel[:, cols] = lecun_normal_(torch.empty(int(input_size), self.hidden_size, device=device),
                                                           int(input_size))
                self.hidden_kernel[:, cols] = nn.init.orthogonal_(torch.empty(self.hidden_size, self.hidden_size,
                                                                              device=device))

    def forward(self, x: torch.Tensor, is_first: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor):
        """-> (outputs (T, B, H), (hx, cx))."""
        xi = torch.matmul(x, self.input_kernel)
        keep = 1.0 - is_first.to(x.dtype)
        outs = []
        for t in range(x.shape[0]):
            hx, cx = hx * keep[t], cx * keep[t]
            gates = xi[t] + torch.addmm(self.hidden_bias, hx, self.hidden_kernel)
            i, f, g, o = gates.chunk(4, -1)
            cx = torch.sigmoid(f) * cx + torch.sigmoid(i) * torch.tanh(g)
            hx = torch.sigmoid(o) * torch.tanh(cx)
            outs.append(hx)
        return torch.stack(outs, 0), (hx, cx)


class RecurrentModel(nn.Module):
    """pre-RNN dense -> :class:`ResetLSTM` -> post-RNN dense, each dense
    only where its ``apply`` is set.  As in the JAX package, each is an
    ``MLP`` of no hidden layer: one linear layer, its activation and
    LayerNorm settings unused."""

    def __init__(self, input_size: int, hidden_size: int, pre_rnn_mlp: Dict[str, Any], post_rnn_mlp: Dict[str, Any],
                 device=None):
        super().__init__()
        self.pre = None
        if pre_rnn_mlp.get("apply", False):
            self.pre = MLP(input_size, (), int(pre_rnn_mlp["dense_units"]), device=device)
            input_size = int(pre_rnn_mlp["dense_units"])
        self.lstm = ResetLSTM(input_size, hidden_size, device=device)
        self.post = None
        self.output_dim = int(hidden_size)
        if post_rnn_mlp.get("apply", False):
            self.post = MLP(hidden_size, (), int(post_rnn_mlp["dense_units"]), device=device)
            self.output_dim = int(post_rnn_mlp["dense_units"])

    def forward(self, x, is_first, hx, cx):
        if self.pre is not None:
            x = self.pre(x)
        out, (hx, cx) = self.lstm(x, is_first, hx, cx)
        if self.post is not None:
            out = self.post(out)
        return out, (hx, cx)


class RecurrentPPOAgentModule(nn.Module):
    """MLP encoder ++ previous actions -> :class:`RecurrentModel` -> actor
    heads and critic."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        is_continuous: bool,
        mlp_keys: Sequence[str],
        obs_dims: Dict[str, int],
        encoder_cfg: Dict[str, Any],
        rnn_cfg: Dict[str, Any],
        actor_cfg: Dict[str, Any],
        critic_cfg: Dict[str, Any],
        device=None,
    ):
        super().__init__()
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.mlp_keys = tuple(mlp_keys)
        self.rnn_hidden_size = int(rnn_cfg["lstm"]["hidden_size"])
        enc = encoder_cfg
        feat = int(enc["mlp_features_dim"])
        self.feature_extractor = MultiEncoder(
            MLPEncoder(
                sum(int(obs_dims[k]) for k in self.mlp_keys), feat, self.mlp_keys, int(enc["dense_units"]),
                int(enc["mlp_layers"]), enc["dense_act"], bool(enc["layer_norm"]), device=device,
            )
        )
        self.rnn = RecurrentModel(feat + sum(self.actions_dim), self.rnn_hidden_size, dict(rnn_cfg["pre_rnn_mlp"]),
                                  dict(rnn_cfg["post_rnn_mlp"]), device=device)
        out = self.rnn.output_dim
        self.critic = MLP(
            out, (int(critic_cfg["dense_units"]),) * int(critic_cfg["mlp_layers"]), 1, critic_cfg["dense_act"],
            bool(critic_cfg["layer_norm"]), device=device,
        )
        self.actor_backbone = MLP(
            out, (int(actor_cfg["dense_units"]),) * int(actor_cfg["mlp_layers"]), None, actor_cfg["dense_act"],
            bool(actor_cfg["layer_norm"]), device=device,
        )
        head_in = int(actor_cfg["dense_units"]) if int(actor_cfg["mlp_layers"]) > 0 else out
        outs = [sum(self.actions_dim) * 2] if self.is_continuous else list(self.actions_dim)
        self.actor_heads = nn.ModuleList(MLP._linear(head_in, d, device) for d in outs)

    def features(self, obs: Dict[str, torch.Tensor], prev_actions, is_first, hx, cx):
        """The RNN's outputs (T, B, ·) and its final carry."""
        feat = self.feature_extractor(obs)
        return self.rnn(torch.cat([feat, prev_actions.to(feat.dtype)], -1), is_first, hx, cx)

    def forward(
        self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, is_first: torch.Tensor, hx: torch.Tensor,
        cx: torch.Tensor,
    ) -> Tuple[List[torch.Tensor], torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """obs values (T, B, ...); prev_actions (T, B, sum(actions_dim));
        is_first (T, B, 1); hx/cx (B, H)."""
        out, states = self.features(obs, prev_actions, is_first, hx, cx)
        a = self.actor_backbone(out)
        return [head(a) for head in self.actor_heads], self.critic(out), states


def _normal(out: torch.Tensor) -> Independent:
    mean, log_std = torch.chunk(out, 2, dim=-1)
    return Independent(Normal(mean, torch.exp(log_std)), 1)


def _dist_stats(agent: RecurrentPPOAgentModule, actor_outs, actions) -> Tuple[torch.Tensor, torch.Tensor]:
    if agent.is_continuous:
        dist = _normal(actor_outs[0])
        return dist.log_prob(actions)[..., None], dist.entropy()[..., None]
    logprobs, entropies = [], []
    for logits, act in zip(actor_outs, torch.split(actions, list(agent.actions_dim), dim=-1)):
        d = OneHotCategorical(logits=logits)
        logprobs.append(d.log_prob(act))
        entropies.append(d.entropy())
    return torch.stack(logprobs, -1).sum(-1, keepdim=True), torch.stack(entropies, -1).sum(-1, keepdim=True)


def evaluate_actions(agent, obs, prev_actions, is_first, hx, cx, actions):
    """(logprobs, entropy, values) over a (T, B, ...) sequence batch."""
    actor_outs, values, _ = agent(obs, prev_actions, is_first, hx, cx)
    logprob, entropy = _dist_stats(agent, actor_outs, actions)
    return logprob, entropy, values


def _no_reset(prev_actions: torch.Tensor) -> torch.Tensor:
    return torch.zeros(prev_actions.shape[:-1] + (1,), dtype=torch.float32, device=prev_actions.device)


def sample_actions(
    agent: RecurrentPPOAgentModule,
    obs: Dict[str, torch.Tensor],
    prev_actions: torch.Tensor,
    hx: torch.Tensor,
    cx: torch.Tensor,
    noise: Optional[List[torch.Tensor]] = None,
    *,
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
):
    """One env step (T = 1, ``is_first`` 0): ``(flat, real, logprobs,
    values, (hx, cx))``, each (1, B, ...).  ``noise`` as
    :func:`~sheeprl_tpu_torch.algos.ppo.agent.draw_policy_noise` gives it
    for the B rows (each head's draws reshaped to its logits); drawn from
    ``generator`` when not supplied and not greedy."""
    actor_outs, values, states = agent(obs, prev_actions, _no_reset(prev_actions), hx, cx)
    if noise is None and not greedy:
        noise = draw_policy_noise(agent, values.shape[:-1], generator, values.device)
    if agent.is_continuous:
        dist = _normal(actor_outs[0])
        act = dist.mean if greedy else dist.rsample(noise[0].reshape(dist.mean.shape))
        return act, act, dist.log_prob(act)[..., None], values, states
    sub_actions, sub_real, logprobs = [], [], []
    for i, logits in enumerate(actor_outs):
        d = OneHotCategorical(logits=logits)
        a = d.mode if greedy else d.sample(noise[i].reshape(logits.shape))
        sub_actions.append(a)
        sub_real.append(torch.argmax(a, -1))
        logprobs.append(d.log_prob(a))
    flat = torch.cat(sub_actions, -1)
    return flat, torch.stack(sub_real, -1), torch.stack(logprobs, -1).sum(-1, keepdim=True), values, states


def get_values(agent: RecurrentPPOAgentModule, obs, prev_actions, hx, cx) -> torch.Tensor:
    """The critic's (T, B, 1) values, ``is_first`` 0 (the actor is not run)."""
    out, _ = agent.features(obs, prev_actions, _no_reset(prev_actions), hx, cx)
    return agent.critic(out)


class RecurrentPPOPlayer:
    """The agent with its observation preparation bound, carrying ``hx``,
    ``cx`` and ``prev_actions`` across env steps (``RecurrentPPOPlayer`` of
    the JAX package); the caller resets them where episodes end
    (:meth:`reset_states`).  Acts without gradients on the agent's device."""

    def __init__(self, agent: RecurrentPPOAgentModule, prepare_obs_fn, num_envs: int):
        self.agent = agent
        self.num_envs = int(num_envs)
        self._prepare_obs = prepare_obs_fn
        self.init_states()

    def init_states(self) -> None:
        dev = next(self.agent.parameters()).device
        h, a = self.agent.rnn_hidden_size, sum(self.agent.actions_dim)
        self.hx = torch.zeros((self.num_envs, h), device=dev)
        self.cx = torch.zeros((self.num_envs, h), device=dev)
        self.prev_actions = torch.zeros((1, self.num_envs, a), device=dev)

    def reset_states(self, dones) -> None:
        """Zero the recurrent state and ``prev_actions`` of every env that is done."""
        keep = 1.0 - torch.as_tensor(dones, dtype=torch.float32, device=self.hx.device).reshape(self.num_envs, 1)
        self.hx, self.cx = self.hx * keep, self.cx * keep
        self.prev_actions = self.prev_actions * keep[None]

    @torch.no_grad()
    def get_actions(self, obs, *, generator: Optional[torch.Generator] = None, greedy: bool = False):
        flat, real, logprobs, values, (self.hx, self.cx) = sample_actions(
            self.agent, self._prepare_obs(obs), self.prev_actions, self.hx, self.cx, generator=generator, greedy=greedy
        )
        self.prev_actions = flat
        return flat, real, logprobs, values

    @torch.no_grad()
    def get_values(self, obs) -> torch.Tensor:
        return get_values(self.agent, self._prepare_obs(obs), self.prev_actions, self.hx, self.cx)


def build_agent(
    runtime,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Dict[str, Any],
    obs_space,
    agent_state: Optional[Any] = None,
) -> RecurrentPPOAgentModule:
    """The agent on ``runtime.device``, initialised from the runtime's seed,
    or from ``agent_state`` (the JAX package's parameter tree, as a
    checkpoint holds it)."""
    if len(cfg.algo.cnn_keys.encoder) > 0:
        raise NotImplementedError("Recurrent PPO's CNN encoder is not ported yet: ROADMAP A2 (the pixel envs)")
    if runtime.precision != "32-true":
        raise NotImplementedError(
            f"recurrent PPO at fabric.precision={runtime.precision} is not ported yet (ROADMAP A2); use 32-true"
        )
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    agent = RecurrentPPOAgentModule(
        actions_dim,
        is_continuous,
        mlp_keys,
        {k: prod(obs_space[k].shape) for k in mlp_keys},
        dict(cfg.algo.encoder),
        dict(cfg.algo.rnn),
        dict(cfg.algo.actor),
        dict(cfg.algo.critic),
        device=runtime.device,
    )
    if agent_state is not None:
        from sheeprl_tpu_torch.utils.convert import load_flax_params

        load_flax_params(agent, agent_state)
    return agent

"""DreamerV2's gradient step and env loop (counterpart of
``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``).

:func:`make_train_fn` builds one gradient step in the JAX step's order
(``dreamer_v2.py:103-397``): the dynamic loop of the RSSM with
``is_first`` zero resets (the first row of a sampled window counts as an
episode start), the priors batched over the stacked recurrent states, the
KL-balanced world-model loss and one optimizer step; imagination from the
detached posteriors through the *updated* world model (rows B-major: row
r = b * T + t); the actor's mixed reinforce/dynamics objective
(``objective_mix``) with the entropy bonus against lambda returns of the
target critic, one actor step; the critic's unit-variance Normal
regression on the lambda returns, weighted by the discount, one critic
step.  JAX's ``world_model.dyn_bptt`` (a custom-VJP route through the same
numbers, ``sheeprl_tpu/ops/dyn_bptt.py``) is the plain loop here under
autograd.  Replay row t holds the action that led to o_t, so the actions
go into the RSSM unshifted.

:func:`main` is DreamerV3's env loop (``dreamer_v3.py:run_dreamer``) with
DreamerV2's :class:`~sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.DreamerFamily`:
the zero-action seed row and rows written after the step, ``PlayerDV2``, a
hard copy of the critic into the target critic every
``per_rank_target_network_update_freq`` gradient steps (step 0 included),
``env.frame_stack = 1`` and a greedy closing test.  ``buffer.type=episode``
(the host-only episode buffer) raises.

Randomness: a step draws every sample's noise up front (:func:`draw_noise`)
from a ``torch.Generator``, or takes it pre-drawn: Gumbel noise (T, B, S, D)
for the dynamic loop and (H, T*B, S, D) for imagination, and the actor's
noise (H, T*B, sum(actions)) (``Actor.draw_noise``: Gumbel per discrete
head, uniforms for the truncated normal, standard normals otherwise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    DreamerFamily,
    DreamerRun,
    TrainState,
    resume_state,
    run_dreamer,
    step_,
    world_model_metrics,
)
from sheeprl_tpu_torch.optim import build_optimizer
from sheeprl_tpu_torch.utils.distribution import Bernoulli, Independent, Normal, gumbel_noise
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import trainable_params as _trainable

__all__ = ["DV2_FAMILY", "StepConfig", "behaviour_update", "draw_noise", "imagination_starts", "imagine", "main",
           "make_optimizers", "make_player", "make_train_fn", "make_train_state", "normal_heads", "step_config",
           "world_model_loss"]

@dataclass(frozen=True)
class StepConfig:
    """The constants of a DreamerV2 gradient step, read from ``cfg`` once."""

    cnn_keys: tuple
    mlp_keys: tuple
    decoded_keys: tuple
    stochastic_size: int
    discrete_size: int
    recurrent_state_size: int
    horizon: int
    gamma: float
    lmbda: float
    ent_coef: float
    objective_mix: float
    kl: dict
    use_continues: bool
    is_continuous: bool
    splits: tuple

    @property
    def stoch_state_size(self) -> int:
        return self.stochastic_size * self.discrete_size


def step_config(cfg, is_continuous: bool, actions_dim) -> StepConfig:
    wm_cfg = cfg.algo.world_model
    return StepConfig(
        cnn_keys=tuple(cfg.algo.cnn_keys.encoder),
        mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
        decoded_keys=tuple(cfg.algo.cnn_keys.decoder) + tuple(cfg.algo.mlp_keys.decoder),
        stochastic_size=int(wm_cfg.stochastic_size),
        discrete_size=int(wm_cfg.discrete_size),
        recurrent_state_size=int(wm_cfg.recurrent_model.recurrent_state_size),
        horizon=int(cfg.algo.horizon),
        gamma=float(cfg.algo.gamma),
        lmbda=float(cfg.algo.lmbda),
        ent_coef=float(cfg.algo.actor.ent_coef),
        objective_mix=float(cfg.algo.actor.objective_mix),
        kl=dict(
            kl_balancing_alpha=float(wm_cfg.kl_balancing_alpha),
            kl_free_nats=float(wm_cfg.kl_free_nats),
            kl_free_avg=bool(wm_cfg.kl_free_avg),
            kl_regularizer=float(wm_cfg.kl_regularizer),
            discount_scale_factor=float(wm_cfg.discount_scale_factor),
        ),
        use_continues=bool(wm_cfg.use_continues),
        is_continuous=bool(is_continuous),
        splits=tuple(int(c) for c in np.cumsum(actions_dim)[:-1]),
    )


def draw_noise(cfg, seq_len: int, batch_size: int, actor, *, device, generator=None) -> Dict[str, torch.Tensor]:
    """Every draw of one train step: {"dyn", "img", "act"} (module docstring)."""
    wm_cfg = cfg.algo.world_model
    horizon, rows = int(cfg.algo.horizon), seq_len * batch_size
    like = torch.empty((), device=device)
    latent = (int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size))
    return {
        "dyn": gumbel_noise((seq_len, batch_size, *latent), like=like, generator=generator),
        "img": gumbel_noise((horizon, rows, *latent), like=like, generator=generator),
        "act": actor.draw_noise((horizon, rows), like=like, generator=generator),
    }


def batch_observations(sc, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The observations of a (T, B) batch, images scaled to [-0.5, 0.5)."""
    obs = {k: data[k].float() / 255.0 - 0.5 for k in sc.cnn_keys}
    obs.update({k: data[k].float() for k in sc.mlp_keys})
    return obs


def normal_heads(sc, wm, latent_states: torch.Tensor, terminated: torch.Tensor, detach_heads: bool = False):
    """The unit-variance Normal observation and reward heads, and the
    Bernoulli continue head with its targets ``(1 - terminated) * gamma``
    when ``use_continues`` (else None, None).  ``detach_heads``: the reward
    and continue heads read the latents detached (Plan2Explore's
    exploration phase)."""
    reconstructed = wm.observation_model(latent_states)
    po = {k: Independent(Normal(v, torch.ones_like(v)), v.dim() - 2) for k, v in reconstructed.items()
          if k in sc.decoded_keys}
    head_in = latent_states.detach() if detach_heads else latent_states
    reward = wm.reward_model(head_in)
    pr = Independent(Normal(reward, torch.ones_like(reward)), 1)
    if sc.use_continues:
        return po, pr, Independent(Bernoulli(logits=wm.continue_model(head_in)), 1), (1 - terminated) * sc.gamma
    return po, pr, None, None


def world_model_loss(sc: StepConfig, wm, data: Dict[str, torch.Tensor], dyn_noise: torch.Tensor,
                     detach_heads: bool = False):
    """The world model's loss over a (T, B) batch: -> ``(loss, aux)``
    (``detach_heads``: :func:`normal_heads`)."""
    rssm = wm.rssm
    T, B = data["rewards"].shape[:2]
    device = data["rewards"].device
    batch_obs = batch_observations(sc, data)
    is_first = data["is_first"].float().clone()
    is_first[0] = 1.0
    actions = data["actions"].float()
    emb_proj = rssm.representation_embed_proj(wm.encoder(batch_obs))
    posterior = torch.zeros(B, sc.stochastic_size, sc.discrete_size, device=device)
    recurrent_state = torch.zeros(B, sc.recurrent_state_size, device=device)
    recs, posts, post_logits = [], [], []
    for t in range(T):
        recurrent_state, posterior, logits = rssm.dynamic_posterior_from_proj(
            posterior, recurrent_state, actions[t], emb_proj[t], is_first[t], noise=dyn_noise[t]
        )
        recs.append(recurrent_state)
        posts.append(posterior)
        post_logits.append(logits)
    recurrent_states = torch.stack(recs)
    posteriors = torch.stack(posts)
    priors_logits, _ = rssm._transition(recurrent_states, sample_state=False)
    latent_states = torch.cat([posteriors.reshape(T, B, -1), recurrent_states], -1)
    po, pr, pc, continue_targets = normal_heads(sc, wm, latent_states, data["terminated"].float(), detach_heads)
    pl = priors_logits.reshape(T, B, sc.stochastic_size, sc.discrete_size)
    psl = torch.stack(post_logits).reshape(T, B, sc.stochastic_size, sc.discrete_size)
    rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
        po, batch_obs, pr, data["rewards"].float(), pl, psl, pc=pc, continue_targets=continue_targets, **sc.kl
    )
    aux = {
        "posteriors": posteriors, "recurrent_states": recurrent_states, "posteriors_logits": psl, "priors_logits": pl,
        "kl": kl.mean(), "state_loss": state_loss, "reward_loss": reward_loss, "observation_loss": observation_loss,
        "continue_loss": continue_loss,
    }
    return rec_loss, aux


def imagine(sc: StepConfig, rssm, actor, imagined_prior: torch.Tensor, recurrent_state: torch.Tensor,
            img_noise: torch.Tensor, act_noise: torch.Tensor):
    """``horizon`` imagined steps from the starts, each action drawn from
    ``actor`` on the detached latent: -> the trajectories (H + 1, N, L),
    the start first, and the actions (H + 1, N, A), a zero placeholder first
    (``imagined_actions[i + 1]`` was taken at ``trajectories[i]``)."""
    latent = torch.cat([imagined_prior, recurrent_state], -1)
    latents, imagined_actions = [latent], []
    for i in range(sc.horizon):
        acts, _ = actor(latent.detach(), False, noise=act_noise[i])
        action = torch.cat(acts, -1)
        imagined_prior, recurrent_state = rssm.imagination(imagined_prior, recurrent_state, action, noise=img_noise[i])
        imagined_prior = imagined_prior.reshape(-1, sc.stoch_state_size)
        latent = torch.cat([imagined_prior, recurrent_state], -1)
        latents.append(latent)
        imagined_actions.append(action)
    return torch.stack(latents), torch.stack([torch.zeros_like(imagined_actions[0])] + imagined_actions)


def imagination_starts(sc: StepConfig, aux: Dict[str, torch.Tensor], terminated: torch.Tensor):
    """The detached (T, B) posteriors and recurrent states flattened B-major
    (row r = b * T + t) as imagination's starts, and the true continues
    (T * B, 1) scaled by gamma."""
    T, B = terminated.shape[:2]
    prior0 = aux["posteriors"].detach().transpose(0, 1).reshape(T * B, sc.stoch_state_size)
    rec0 = aux["recurrent_states"].detach().transpose(0, 1).reshape(T * B, sc.recurrent_state_size)
    true_continue = (1 - terminated.float()).transpose(0, 1).reshape(T * B, 1) * sc.gamma
    return prior0, rec0, true_continue


def behaviour_update(sc: StepConfig, wm, actor, critic, target_critic, txs, opt_states, params, groups, starts,
                     img_noise: torch.Tensor, act_noise: torch.Tensor, objective_mix: float, reward_fn=None):
    """One actor and one critic step in imagination from ``starts``
    (:func:`imagination_starts`) through the updated world model: the
    actor's ``objective_mix`` of reinforce (the target critic's baseline)
    and the lambda returns through the dynamics, with the entropy bonus;
    the critic's unit-variance Normal regression on the lambda returns,
    weighted by the discount.  ``groups`` names the actor's and the critic's
    entries of ``txs``, ``opt_states`` and ``params``; ``reward_fn(traj,
    actions)`` gives the imagined rewards (default: the reward model's).
    -> ``(policy loss, value loss, actor grad norm, critic grad norm, aux)``,
    ``aux`` the rewards, the target values and the lambda returns."""
    actor_group, critic_group = groups
    prior0, rec0, true_continue = starts
    # the rollout carries a gradient only into the dynamics term
    with torch.set_grad_enabled(objective_mix != 1.0):
        traj, imagined_actions = imagine(sc, wm.rssm, actor, prior0, rec0, img_noise, act_noise)
        target_values = target_critic(traj)
        rewards = wm.reward_model(traj) if reward_fn is None else reward_fn(traj, imagined_actions)
        if sc.use_continues:
            continues = torch.sigmoid(wm.continue_model(traj))
            continues = torch.cat([true_continue[None], continues[1:]], 0)
        else:
            continues = torch.ones_like(rewards) * sc.gamma
        lambda_values = compute_lambda_values(rewards[:-1], target_values[:-1], continues[:-1], target_values[-1:],
                                              sc.lmbda)
    discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], 0), 0).detach()

    # ------------------------------------------------ actor
    _, policies = actor(traj[:-2].detach(), True)
    advantage = (lambda_values[1:] - target_values[:-2]).detach()
    sub_actions = [imagined_actions] if sc.is_continuous else torch.tensor_split(imagined_actions, list(sc.splits), -1)
    reinforce = torch.stack(
        [p.log_prob(a[1:-1].detach())[..., None] for p, a in zip(policies, sub_actions)], -1
    ).sum(-1) * advantage
    objective = objective_mix * reinforce + (1 - objective_mix) * lambda_values[1:]
    try:
        entropy = sc.ent_coef * torch.stack([p.entropy() for p in policies], -1).sum(-1)
    except (AttributeError, NotImplementedError):  # a distribution without entropy
        entropy = torch.zeros_like(objective[..., 0])
    policy_loss = -torch.mean(discount[:-2] * (objective + entropy[..., None]))
    actor_norm = step_(txs[actor_group], params[actor_group], policy_loss, opt_states[actor_group])

    # ------------------------------------------------ critic
    values = critic(traj.detach()[:-1])
    qv = Independent(Normal(values, torch.ones_like(values)), 1)
    value_loss = -torch.mean(discount[:-1, ..., 0] * qv.log_prob(lambda_values.detach()))
    critic_norm = step_(txs[critic_group], params[critic_group], value_loss, opt_states[critic_group])
    aux = {"rewards": rewards.detach(), "target_values": target_values.detach(), "lambda_values": lambda_values.detach()}
    return policy_loss.detach(), value_loss.detach(), actor_norm, critic_norm, aux


def make_train_fn(runtime, agent, txs, cfg, is_continuous: bool, actions_dim):
    """The gradient step: ``train(opt_states, moments, data, noise=None,
    generator=None) -> (opt_states, moments, metrics)``, ``data`` a dict of
    (T, B, *) tensors on the agent's device, ``moments`` passed through
    (DreamerV2 keeps none), ``metrics`` the JAX step's thirteen 0-d tensors."""
    wm, actor = agent.world_model, agent.actor
    sc = step_config(cfg, is_continuous, actions_dim)
    params = {"world_model": _trainable(wm), "actor": _trainable(actor), "critic": _trainable(agent.critic)}

    def train(opt_states, moments, data, noise=None, generator=None):
        T, B = data["rewards"].shape[:2]
        if noise is None:
            noise = draw_noise(cfg, T, B, actor, device=data["rewards"].device, generator=generator)

        # ------------------------------------------------ world model
        rec_loss, aux = world_model_loss(sc, wm, data, noise["dyn"])
        wm_norm = step_(txs["world_model"], params["world_model"], rec_loss, opt_states["world_model"])

        # ------------------------------------------------ behaviour, imagined through the updated world model
        policy_loss, value_loss, actor_norm, critic_norm, _ = behaviour_update(
            sc, wm, actor, agent.critic, agent.target_critic, txs, opt_states, params, ("actor", "critic"),
            imagination_starts(sc, aux, data["terminated"]), noise["img"], noise["act"], sc.objective_mix,
        )

        metrics = {
            **world_model_metrics(rec_loss, aux),
            "Loss/policy_loss": policy_loss,
            "Loss/value_loss": value_loss,
            "Grads/world_model": wm_norm,
            "Grads/actor": actor_norm,
            "Grads/critic": critic_norm,
        }
        return opt_states, moments, metrics

    return train


def make_optimizers(runtime, agent, cfg):
    """An optimizer per group (``build_optimizer`` with the group's clip) and their states."""
    groups = {"world_model": agent.world_model, "actor": agent.actor, "critic": agent.critic}
    txs = {g: build_optimizer(cfg.algo[g].optimizer, cfg.algo[g].clip_gradients, runtime.precision) for g in groups}
    return txs, {g: txs[g].init(_trainable(m)) for g, m in groups.items()}


def make_train_state(runtime, agent, cfg, is_continuous: bool, actions_dim) -> TrainState:
    """Optimizers, their states and the train step for ``agent``; the target
    critic's updates are copies."""
    txs, opt_states = make_optimizers(runtime, agent, cfg)
    train_fn = make_train_fn(runtime, agent, txs, cfg, is_continuous, actions_dim)
    return TrainState(agent, txs, opt_states, {}, train_fn)


def dreamer_setup(keys, build_agent, make_state):
    """A family's ``setup``: ``build_agent`` and ``make_state`` on the run,
    the checkpoint's ``keys`` and Adam states loaded when it resumes; the
    checkpoint holds the same entries in the JAX package's layout."""

    def setup(runtime, cfg, actions_dim, is_continuous, observation_space, state) -> DreamerRun:
        from sheeprl_tpu_torch.utils.convert import adam_state_from_tree, adam_state_to_tree, load_flax_params, torch_to_flax

        agent = build_agent(runtime, actions_dim, is_continuous, cfg, observation_space)
        train_state = make_state(runtime, agent, cfg, is_continuous, actions_dim)
        groups = {"world_model": agent.world_model, "actor": agent.actor, "critic": agent.critic}
        if state is not None:
            load_flax_params(agent, {k: state[k] for k in keys})
            train_state.opt_states = {g: adam_state_from_tree(state["opt_states"][g], m, g) for g, m in groups.items()}

        def ckpt_state():
            params = torch_to_flax(agent)
            return {**{k: params[k] for k in keys},
                    "opt_states": {g: adam_state_to_tree(train_state.opt_states[g], m, g) for g, m in groups.items()}}

        return DreamerRun(train_state, agent.actor, ckpt_state)

    return setup


def make_player(modules, cfg, actions_dim, num_envs):
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2

    wm_cfg = cfg.algo.world_model
    return PlayerDV2(modules, actions_dim, num_envs, wm_cfg.stochastic_size, wm_cfg.recurrent_model.recurrent_state_size,
                     discrete_size=wm_cfg.discrete_size, expl_amount=float(cfg.algo.actor.get("expl_amount", 0.0)))


def _build_agent(*args):
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent

    return build_agent(*args)


DV2_FAMILY = DreamerFamily(
    name="DreamerV2",
    load_state=resume_state,
    setup=dreamer_setup(("world_model", "actor", "critic", "target_critic"), _build_agent, make_train_state),
    restore_rb=lambda cfg, state: state is not None and bool(cfg.buffer.checkpoint),
    make_player=make_player,
    generation=2,
)


@register_algorithm()
def main(runtime, cfg):
    """The DreamerV2 env loop (module docstring).  Returns the run's summary."""
    return run_dreamer(runtime, cfg, DV2_FAMILY)

"""DreamerV1's gradient step and env loop (counterpart of
``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``).

:func:`make_train_fn` builds one gradient step in the JAX step's order
(``dreamer_v1.py:50-316``): the dynamic loop of the Gaussian RSSM (no
``is_first`` resets: sampled windows may cross episode ends), the priors'
means and deviations batched over the stacked recurrent states, the ELBO
with free nats and one world-model step; imagination of ``horizon``
states from the detached posteriors through the *updated* world model
(rows B-major; the start is not part of the trajectory), the actor's
``-mean(discount * lambda)`` through the dynamics, one actor step; the
critic's regression on the lambda returns (no target critic), one critic
step.  JAX's ``world_model.dyn_bptt`` is the plain loop here under
autograd.

:func:`main` is DreamerV3's env loop with DreamerV1's
:class:`~sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.DreamerFamily`:
DreamerV2's rows without the ``is_first`` column, ``PlayerDV1`` with its
exploration half-life (the loop logs ``Params/exploration_amount``),
``env.frame_stack = 1`` and a greedy closing test.

Randomness: standard normals (T, B, S) for the dynamic loop and (H, T*B, S)
for imagination, and the actor's noise (H, T*B, sum(actions))
(``Actor.draw_noise``), drawn up front from a ``torch.Generator`` or
given pre-drawn.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.loss import actor_loss, critic_loss, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import batch_observations, dreamer_setup, make_optimizers, normal_heads
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DreamerFamily, TrainState, resume_state, run_dreamer, step_
from sheeprl_tpu_torch.utils.distribution import Independent, Normal, normal_noise
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import trainable_params as _trainable

__all__ = ["DV1_FAMILY", "behaviour_update", "draw_noise", "imagination_starts", "main", "make_player", "make_train_fn",
           "make_train_state", "step_config", "world_model_loss"]


def draw_noise(cfg, seq_len: int, batch_size: int, actor, *, device, generator=None) -> Dict[str, torch.Tensor]:
    """Every draw of one train step: {"dyn", "img", "act"} (module docstring)."""
    stoch, horizon = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.horizon)
    like = torch.empty((), device=device)
    return {
        "dyn": normal_noise((seq_len, batch_size, stoch), like=like, generator=generator),
        "img": normal_noise((horizon, seq_len * batch_size, stoch), like=like, generator=generator),
        "act": actor.draw_noise((horizon, seq_len * batch_size), like=like, generator=generator),
    }


def step_config(cfg) -> SimpleNamespace:
    """The constants of a DreamerV1 gradient step, read from ``cfg`` once."""
    wm_cfg = cfg.algo.world_model
    return SimpleNamespace(
        cnn_keys=tuple(cfg.algo.cnn_keys.encoder), mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
        decoded_keys=tuple(cfg.algo.cnn_keys.decoder) + tuple(cfg.algo.mlp_keys.decoder), horizon=int(cfg.algo.horizon),
        gamma=float(cfg.algo.gamma), lmbda=float(cfg.algo.lmbda), use_continues=bool(wm_cfg.use_continues),
        stoch=int(wm_cfg.stochastic_size), rec_size=int(wm_cfg.recurrent_model.recurrent_state_size),
        kl=dict(kl_free_nats=float(wm_cfg.kl_free_nats), kl_regularizer=float(wm_cfg.kl_regularizer),
                continue_scale_factor=float(wm_cfg.continue_scale_factor)),
    )


def world_model_loss(sc, wm, data: Dict[str, torch.Tensor], dyn_noise: torch.Tensor, detach_heads: bool = False):
    """The ELBO over a (T, B) batch: -> ``(loss, aux)``, ``aux`` the
    posteriors, recurrent states and embedded observations, and the world
    model's metrics (``detach_heads``: the reward and continue heads read
    the latents detached, as in Plan2Explore's exploration phase)."""
    rssm = wm.rssm
    T, B = data["rewards"].shape[:2]
    device = data["rewards"].device
    batch_obs = batch_observations(sc, data)
    actions = data["actions"].float()
    embedded_obs = wm.encoder(batch_obs)
    emb_proj = rssm.representation_embed_proj(embedded_obs)
    posterior = torch.zeros(B, sc.stoch, device=device)
    recurrent_state = torch.zeros(B, sc.rec_size, device=device)
    recs, posts, means, stds = [], [], [], []
    for t in range(T):
        recurrent_state, posterior, (mean, std) = rssm.dynamic_posterior_from_proj(
            posterior, recurrent_state, actions[t], emb_proj[t], noise=dyn_noise[t]
        )
        recs.append(recurrent_state)
        posts.append(posterior)
        means.append(mean)
        stds.append(std)
    recurrent_states, posteriors = torch.stack(recs), torch.stack(posts)
    (prior_means, prior_stds), _ = rssm._transition(recurrent_states, sample_state=False)
    latent_states = torch.cat([posteriors, recurrent_states], -1)
    qo, qr, qc, continue_targets = normal_heads(sc, wm, latent_states, data["terminated"].float(), detach_heads)
    posteriors_dist = Independent(Normal(torch.stack(means), torch.stack(stds)), 1)
    priors_dist = Independent(Normal(prior_means, prior_stds), 1)
    rec_loss, kl_value, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
        qo, batch_obs, qr, data["rewards"].float(), posteriors_dist, priors_dist, qc=qc,
        continue_targets=continue_targets, **sc.kl,
    )
    metrics = {
        "Loss/world_model_loss": rec_loss.detach(),
        "Loss/observation_loss": observation_loss.detach(),
        "Loss/reward_loss": reward_loss.detach(),
        "Loss/state_loss": state_loss.detach(),
        "Loss/continue_loss": continue_loss.detach(),
        "State/kl": kl_value.detach(),
        "State/post_entropy": posteriors_dist.entropy().mean().detach(),
        "State/prior_entropy": priors_dist.entropy().mean().detach(),
    }
    aux = {"posteriors": posteriors, "recurrent_states": recurrent_states, "embedded_obs": embedded_obs,
           "metrics": metrics}
    return rec_loss, aux


def imagination_starts(sc, aux: Dict[str, torch.Tensor]):
    """The detached (T, B) posteriors and recurrent states flattened B-major
    (row r = b * T + t) as imagination's starts."""
    T, B = aux["posteriors"].shape[:2]
    prior = aux["posteriors"].detach().transpose(0, 1).reshape(T * B, sc.stoch)
    rec = aux["recurrent_states"].detach().transpose(0, 1).reshape(T * B, sc.rec_size)
    return prior, rec


def behaviour_update(sc, wm, actor, critic, txs, opt_states, params, groups, starts, img_noise: torch.Tensor,
                     act_noise: torch.Tensor, reward_fn=None):
    """One actor and one critic step in imagination of ``horizon`` states
    from ``starts`` through the updated world model: the actor's ``-mean(discount
    * lambda)`` through the dynamics, the critic's regression on the lambda
    returns.  ``groups`` names the actor's and the critic's entries of
    ``txs``, ``opt_states`` and ``params``; ``reward_fn(traj, actions)``
    gives the imagined rewards (default: the reward model's), ``actions[i]``
    the one taken before ``traj[i]``.  -> ``(policy loss, value loss, actor
    grad norm, critic grad norm, aux)``, ``aux`` the rewards, the critic's
    values and the lambda returns."""
    rssm = wm.rssm
    actor_group, critic_group = groups
    prior, rec = starts
    latents, actions = [], []
    for i in range(sc.horizon):
        acts, _ = actor(torch.cat([prior, rec], -1).detach(), False, noise=act_noise[i])
        action = torch.cat(acts, -1)
        prior, rec = rssm.imagination(prior, rec, action, noise=img_noise[i])
        latents.append(torch.cat([prior, rec], -1))
        actions.append(action)
    traj = torch.stack(latents)  # (H, T*B, L): the imagined states only
    predicted_values = critic(traj)
    rewards = wm.reward_model(traj) if reward_fn is None else reward_fn(traj, torch.stack(actions))
    if sc.use_continues:
        continues = torch.sigmoid(wm.continue_model(traj))
    else:
        continues = torch.ones_like(rewards) * sc.gamma
    lambda_values = compute_lambda_values(rewards, predicted_values, continues, predicted_values[-1], sc.horizon,
                                          sc.lmbda)
    discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], 0), 0).detach()

    # ------------------------------------------------ actor
    policy_loss = actor_loss(discount * lambda_values)
    actor_norm = step_(txs[actor_group], params[actor_group], policy_loss, opt_states[actor_group])

    # ------------------------------------------------ critic
    values = critic(traj.detach())[:-1]
    qv = Independent(Normal(values, torch.ones_like(values)), 1)
    value_loss = critic_loss(qv, lambda_values.detach(), discount[..., 0])
    critic_norm = step_(txs[critic_group], params[critic_group], value_loss, opt_states[critic_group])
    aux = {"rewards": rewards.detach(), "values": predicted_values.detach(), "lambda_values": lambda_values.detach()}
    return policy_loss.detach(), value_loss.detach(), actor_norm, critic_norm, aux


def make_train_fn(runtime, agent, txs, cfg, is_continuous: bool, actions_dim):
    """The gradient step: ``train(opt_states, moments, data, noise=None,
    generator=None) -> (opt_states, moments, metrics)`` (DreamerV2's
    signature, ``moments`` passed through), ``metrics`` the JAX step's
    thirteen 0-d tensors."""
    wm, actor, critic = agent.world_model, agent.actor, agent.critic
    sc = step_config(cfg)
    params = {"world_model": _trainable(wm), "actor": _trainable(actor), "critic": _trainable(critic)}

    def train(opt_states, moments, data, noise=None, generator=None):
        T, B = data["rewards"].shape[:2]
        if noise is None:
            noise = draw_noise(cfg, T, B, actor, device=data["rewards"].device, generator=generator)

        # ------------------------------------------------ world model
        rec_loss, aux = world_model_loss(sc, wm, data, noise["dyn"])
        wm_norm = step_(txs["world_model"], params["world_model"], rec_loss, opt_states["world_model"])

        # ------------------------------------------------ behaviour, imagined through the updated world model
        policy_loss, value_loss, actor_norm, critic_norm, _ = behaviour_update(
            sc, wm, actor, critic, txs, opt_states, params, ("actor", "critic"), imagination_starts(sc, aux),
            noise["img"], noise["act"],
        )

        metrics = {
            **aux["metrics"],
            "Loss/policy_loss": policy_loss,
            "Loss/value_loss": value_loss,
            "Grads/world_model": wm_norm,
            "Grads/actor": actor_norm,
            "Grads/critic": critic_norm,
        }
        return opt_states, moments, metrics

    return train


def make_train_state(runtime, agent, cfg, is_continuous: bool, actions_dim) -> TrainState:
    """Optimizers, their states and the train step for ``agent``."""
    txs, opt_states = make_optimizers(runtime, agent, cfg)
    return TrainState(agent, txs, opt_states, {}, make_train_fn(runtime, agent, txs, cfg, is_continuous, actions_dim))


def make_player(modules, cfg, actions_dim, num_envs):
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1

    actor_cfg = cfg.algo.actor
    return PlayerDV1(modules, actions_dim, num_envs, cfg.algo.world_model.stochastic_size,
                     cfg.algo.world_model.recurrent_model.recurrent_state_size,
                     expl_amount=float(actor_cfg.get("expl_amount", 0.0)), expl_decay=float(actor_cfg.get("expl_decay", 0.0)),
                     expl_min=float(actor_cfg.get("expl_min", 0.0)))


def _build_agent(*args):
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent

    return build_agent(*args)


DV1_FAMILY = DreamerFamily(
    name="DreamerV1",
    load_state=resume_state,
    setup=dreamer_setup(("world_model", "actor", "critic"), _build_agent, make_train_state),
    restore_rb=lambda cfg, state: state is not None and bool(cfg.buffer.checkpoint),
    make_player=make_player,
    generation=1,
)


@register_algorithm()
def main(runtime, cfg):
    """The DreamerV1 env loop (module docstring).  Returns the run's summary."""
    return run_dreamer(runtime, cfg, DV1_FAMILY)

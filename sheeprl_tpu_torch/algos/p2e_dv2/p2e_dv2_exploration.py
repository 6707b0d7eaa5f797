"""Plan2Explore-DreamerV2's exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``).

:func:`make_train_fn` builds the gradient step of ``make_train_fn``
(``p2e_dv2_exploration.py:67-441``), in JAX's order, from the parts of
DreamerV2's step (``algos/dreamer_v2/dreamer_v2.py``):

1. DreamerV2's world-model loss, its reward and continue heads on detached
   latents, and one step;
2. the ensembles' regression of the next flattened posterior from (z_t,
   h_t, a_t) under a unit-variance Normal (the members' mean log-likelihoods
   summed), and their Adam step (clip ``ensembles.clip_gradients``);
3. the exploration behaviour: DreamerV2's imagination with the exploration
   actor, the intrinsic reward (the members' unbiased variance, averaged
   over the stochastic state, times ``intrinsic_reward_multiplier``),
   lambda returns off the exploration target critic, one actor and one
   critic step;
4. the zero-shot task behaviour: the same on the reward model's rewards
   with the task actor and critics.

The actor's objective is the lambda returns through the dynamics for
continuous actions and reinforce against the target critic's baseline for
discrete ones (DreamerV2's ``objective_mix`` 0 and 1).  Both target critics
are hard copies every ``per_rank_target_network_update_freq`` gradient
steps, step 0 included (``train_steps`` over the agent's ``target_pairs``).

The noise is JAX's streams, drawn up front (:func:`draw_noise`) or fed
through ``noise=``: ``dyn`` (T, B, S, D) Gumbel noise; ``img_e``/``img_t``
(H, T*B, S, D) and ``act_e``/``act_t`` (H, T*B, sum(actions)) for the
exploration's and the task's imagination.

:func:`main` is the Dreamer loop (``dreamer_v3.py:run_dreamer``) with
DreamerV2's conventions and this agent and step: the player acts with the
exploration actor and its ``expl_amount``, the closing test runs the task
actor (zero-shot), and the checkpoint holds the JAX package's keys.
"""

from __future__ import annotations

from typing import Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    behaviour_update,
    imagination_starts,
    make_player,
    step_config,
    world_model_loss,
)
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
from sheeprl_tpu_torch.utils.distribution import Independent, Normal, gumbel_noise
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import trainable_params

__all__ = ["GROUPS", "P2E_DV2_EXPLORATION_FAMILY", "draw_noise", "ensemble_loss", "exploration_setup",
           "intrinsic_reward", "main", "make_train_fn", "make_train_state", "optimizers"]

# the optimizer groups of an exploration step and the config node of each
GROUPS = {"world_model": "world_model", "ensembles": "ensembles", "actor": "actor", "critic": "critic",
          "actor_exploration": "actor", "critic_exploration": "critic"}


def draw_noise(cfg, seq_len: int, batch_size: int, actor, *, device, generator=None) -> Dict[str, torch.Tensor]:
    """Every draw of one step (module docstring)."""
    wm_cfg = cfg.algo.world_model
    horizon, rows = int(cfg.algo.horizon), seq_len * batch_size
    latent = (int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size))
    like = torch.empty((), device=device)
    out = {"dyn": gumbel_noise((seq_len, batch_size, *latent), like=like, generator=generator)}
    for branch in ("e", "t"):
        out[f"img_{branch}"] = gumbel_noise((horizon, rows, *latent), like=like, generator=generator)
        out[f"act_{branch}"] = actor.draw_noise((horizon, rows), like=like, generator=generator)
    return out


def ensemble_loss(ensembles, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each member's prediction from ``inputs`` (T, B, in) at t against
    ``targets`` (T - 1, B, out) at t + 1 under a unit-variance Normal: minus
    the members' mean log-likelihoods, summed."""
    out = ensembles(inputs)[:, :-1]
    log_prob = Independent(Normal(out, torch.ones_like(out)), 1).log_prob(targets)
    return -log_prob.mean((1, 2)).sum()


def intrinsic_reward(ensembles, multiplier: float):
    """``reward_fn(traj, actions)``: the members' unbiased variance of their
    predictions from the detached (latent, action) pairs, averaged over the
    features, times ``multiplier``."""

    def reward_fn(traj: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            preds = ensembles(torch.cat([traj.detach(), actions.detach()], -1))
            return preds.var(0, correction=1).mean(-1, keepdim=True) * multiplier

    return reward_fn


def make_train_fn(runtime, agent, txs, cfg, is_continuous: bool, actions_dim):
    """The gradient step: ``train(opt_states, moments, data, noise=None,
    generator=None) -> (opt_states, moments, metrics)`` (DreamerV2's
    signature, ``moments`` passed through); ``txs`` and ``opt_states`` hold
    the :data:`GROUPS`, ``data`` a dict of (T, B, *) tensors."""
    sc = step_config(cfg, is_continuous, actions_dim)
    wm, ensembles = agent.world_model, agent.ensembles
    mix = 0.0 if is_continuous else 1.0
    reward_fn = intrinsic_reward(ensembles, float(cfg.algo.intrinsic_reward_multiplier))
    params = {g: trainable_params(getattr(agent, g)) for g in GROUPS}

    def train(opt_states, moments, data, noise=None, generator=None):
        T, B = data["rewards"].shape[:2]
        if noise is None:
            noise = draw_noise(cfg, T, B, agent.actor, device=data["rewards"].device, generator=generator)

        # ------------------------------------------------ world model, heads on detached latents
        rec_loss, aux = world_model_loss(sc, wm, data, noise["dyn"], detach_heads=True)
        wm_norm = step_(txs["world_model"], params["world_model"], rec_loss, opt_states["world_model"])

        # ------------------------------------------------ ensembles: the next flattened posterior
        posts = aux["posteriors"].detach().reshape(T, B, sc.stoch_state_size)
        ens_in = torch.cat([posts, aux["recurrent_states"].detach(), data["actions"].float()], -1)
        ens_loss = ensemble_loss(ensembles, ens_in, posts[1:])
        ens_norm = step_(txs["ensembles"], params["ensembles"], ens_loss, opt_states["ensembles"])

        starts = imagination_starts(sc, aux, data["terminated"])
        # ------------------------------------------------ exploration behaviour on the intrinsic reward
        loss_e, value_loss_e, actor_norm_e, critic_norm_e, aux_e = behaviour_update(
            sc, wm, agent.actor_exploration, agent.critic_exploration, agent.target_critic_exploration, txs,
            opt_states, params, ("actor_exploration", "critic_exploration"), starts, noise["img_e"], noise["act_e"],
            mix, reward_fn,
        )
        # ------------------------------------------------ zero-shot task behaviour
        loss_t, value_loss_t, actor_norm_t, critic_norm_t, _ = behaviour_update(
            sc, wm, agent.actor, agent.critic, agent.target_critic, txs, opt_states, params, ("actor", "critic"),
            starts, noise["img_t"], noise["act_t"], mix,
        )

        metrics = {
            **world_model_metrics(rec_loss, aux),
            "Loss/ensemble_loss": ens_loss.detach(),
            "Loss/policy_loss_exploration": loss_e,
            "Loss/value_loss_exploration": value_loss_e,
            "Loss/policy_loss_task": loss_t,
            "Loss/value_loss_task": value_loss_t,
            "Values_exploration/predicted_values": aux_e["target_values"].mean(),
            "Values_exploration/lambda_values": aux_e["lambda_values"].mean(),
            "Rewards/intrinsic": aux_e["rewards"].mean(),
            "Grads/world_model": wm_norm,
            "Grads/ensemble": ens_norm,
            "Grads/actor_exploration": actor_norm_e,
            "Grads/critic_exploration": critic_norm_e,
            "Grads/actor_task": actor_norm_t,
            "Grads/critic_task": critic_norm_t,
        }
        return opt_states, moments, metrics

    return train


def optimizers(runtime, agent, cfg):
    """An optimizer per group of :data:`GROUPS` (``build_optimizer`` with
    its config node's clip) and their states."""
    txs = {g: build_optimizer(cfg.algo[node].optimizer, cfg.algo[node].clip_gradients, runtime.precision)
           for g, node in GROUPS.items()}
    return txs, {g: txs[g].init(trainable_params(getattr(agent, g))) for g in GROUPS}


def make_train_state(runtime, agent, cfg, is_continuous: bool, actions_dim) -> TrainState:
    txs, opt_states = optimizers(runtime, agent, cfg)
    return TrainState(agent, txs, opt_states, {}, make_train_fn(runtime, agent, txs, cfg, is_continuous, actions_dim))


def exploration_setup(build_agent, make_state):
    """A Plan2Explore exploration family's ``setup``: the agent of
    ``build_agent`` and its train state, loaded from the checkpoint when the
    run resumes; the player acts with the exploration actor, the closing
    test runs the task actor, the checkpoint holds JAX's keys."""

    def setup(runtime, cfg, actions_dim, is_continuous, observation_space, state) -> DreamerRun:
        from sheeprl_tpu_torch.utils.convert import load_p2e_state, p2e_state

        cfg.algo.player.actor_type = "exploration"
        agent = build_agent(runtime, actions_dim, is_continuous, cfg, observation_space)
        train_state = make_state(runtime, agent, cfg, is_continuous, actions_dim)
        if state is not None:
            load_p2e_state(agent, train_state, state, runtime.device)
        return DreamerRun(train_state, agent.actor_exploration, lambda: p2e_state(agent, train_state),
                          test_actor=agent.actor)

    return setup


def _build_agent(*args):
    from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent

    return build_agent(*args)


P2E_DV2_EXPLORATION_FAMILY = DreamerFamily(
    name="P2E-DV2",
    load_state=resume_state,
    setup=exploration_setup(_build_agent, make_train_state),
    restore_rb=lambda cfg, state: state is not None and bool(cfg.buffer.checkpoint),
    test_name="zero-shot",
    make_player=make_player,
    generation=2,
)


@register_algorithm()
def main(runtime, cfg):
    """The exploration phase on the Dreamer loop (module docstring).
    Returns the run's summary."""
    return run_dreamer(runtime, cfg, P2E_DV2_EXPLORATION_FAMILY)

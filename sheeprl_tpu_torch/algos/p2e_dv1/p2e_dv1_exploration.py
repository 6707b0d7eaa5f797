"""Plan2Explore-DreamerV1's exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``).

:func:`make_train_fn` builds the gradient step of ``make_train_fn``
(``p2e_dv1_exploration.py:54-368``), in JAX's order, from the parts of
DreamerV1's step (``algos/dreamer_v1/dreamer_v1.py``):

1. DreamerV1's ELBO, its reward and continue heads on detached latents, and
   one step;
2. the ensembles' regression of the next *embedded observation* from (z_t,
   h_t, a_t) under a unit-variance Normal, and their Adam step;
3. the exploration behaviour: DreamerV1's imagination of ``horizon``
   states with the exploration actor, the intrinsic reward (the members'
   unbiased variance over their predictions from each imagined state and
   the action that led to it, averaged, times
   ``intrinsic_reward_multiplier``), one actor step through the dynamics
   and one critic step;
4. the zero-shot task behaviour on the reward model's rewards.

No target critics (DreamerV1 keeps none).  The noise is JAX's streams,
drawn up front (:func:`draw_noise`) or fed through ``noise=``: ``dyn``
(T, B, S) standard normals; ``img_e``/``img_t`` (H, T*B, S) and
``act_e``/``act_t`` (H, T*B, sum(actions)) for the two imaginations.

:func:`main` is the Dreamer loop with DreamerV1's conventions and this
agent and step: the player acts with the exploration actor, its
exploration amount decaying with the policy step (logged as
``Params/exploration_amount``), and the closing test runs the task actor
(zero-shot).
"""

from __future__ import annotations

from typing import Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import (
    behaviour_update,
    imagination_starts,
    make_player,
    step_config,
    world_model_loss,
)
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DreamerFamily, TrainState, resume_state, run_dreamer, step_
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import (
    GROUPS,
    ensemble_loss,
    exploration_setup,
    intrinsic_reward,
    optimizers,
)
from sheeprl_tpu_torch.utils.distribution import normal_noise
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import trainable_params

__all__ = ["P2E_DV1_EXPLORATION_FAMILY", "draw_noise", "main", "make_train_fn", "make_train_state"]


def draw_noise(cfg, seq_len: int, batch_size: int, actor, *, device, generator=None) -> Dict[str, torch.Tensor]:
    """Every draw of one step (module docstring)."""
    stoch, horizon, rows = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.horizon), seq_len * batch_size
    like = torch.empty((), device=device)
    out = {"dyn": normal_noise((seq_len, batch_size, stoch), like=like, generator=generator)}
    for branch in ("e", "t"):
        out[f"img_{branch}"] = normal_noise((horizon, rows, stoch), like=like, generator=generator)
        out[f"act_{branch}"] = actor.draw_noise((horizon, rows), like=like, generator=generator)
    return out


def make_train_fn(runtime, agent, txs, cfg, is_continuous: bool, actions_dim):
    """The gradient step: ``train(opt_states, moments, data, noise=None,
    generator=None) -> (opt_states, moments, metrics)`` (``moments`` passed
    through); ``txs`` and ``opt_states`` hold P2E-DV2's groups."""
    sc = step_config(cfg)
    wm, ensembles = agent.world_model, agent.ensembles
    reward_fn = intrinsic_reward(ensembles, float(cfg.algo.intrinsic_reward_multiplier))
    params = {g: trainable_params(getattr(agent, g)) for g in GROUPS}

    def train(opt_states, moments, data, noise=None, generator=None):
        T, B = data["rewards"].shape[:2]
        if noise is None:
            noise = draw_noise(cfg, T, B, agent.actor, device=data["rewards"].device, generator=generator)

        # ------------------------------------------------ world model, heads on detached latents
        rec_loss, aux = world_model_loss(sc, wm, data, noise["dyn"], detach_heads=True)
        wm_norm = step_(txs["world_model"], params["world_model"], rec_loss, opt_states["world_model"])

        # ------------------------------------------------ ensembles: the next embedded observation
        ens_in = torch.cat([aux["posteriors"].detach(), aux["recurrent_states"].detach(), data["actions"].float()], -1)
        ens_loss = ensemble_loss(ensembles, ens_in, aux["embedded_obs"].detach()[1:])
        ens_norm = step_(txs["ensembles"], params["ensembles"], ens_loss, opt_states["ensembles"])

        starts = imagination_starts(sc, aux)
        # ------------------------------------------------ exploration behaviour on the intrinsic reward
        loss_e, value_loss_e, actor_norm_e, critic_norm_e, aux_e = behaviour_update(
            sc, wm, agent.actor_exploration, agent.critic_exploration, txs, opt_states, params,
            ("actor_exploration", "critic_exploration"), starts, noise["img_e"], noise["act_e"], reward_fn,
        )
        # ------------------------------------------------ zero-shot task behaviour
        loss_t, value_loss_t, actor_norm_t, critic_norm_t, _ = behaviour_update(
            sc, wm, agent.actor, agent.critic, txs, opt_states, params, ("actor", "critic"), starts, noise["img_t"],
            noise["act_t"],
        )

        metrics = {
            **aux["metrics"],
            "Loss/ensemble_loss": ens_loss.detach(),
            "Loss/policy_loss_exploration": loss_e,
            "Loss/value_loss_exploration": value_loss_e,
            "Loss/policy_loss_task": loss_t,
            "Loss/value_loss_task": value_loss_t,
            "Values_exploration/predicted_values": aux_e["values"].mean(),
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


def make_train_state(runtime, agent, cfg, is_continuous: bool, actions_dim) -> TrainState:
    txs, opt_states = optimizers(runtime, agent, cfg)
    return TrainState(agent, txs, opt_states, {}, make_train_fn(runtime, agent, txs, cfg, is_continuous, actions_dim))


def _build_agent(*args):
    from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent

    return build_agent(*args)


P2E_DV1_EXPLORATION_FAMILY = DreamerFamily(
    name="P2E-DV1",
    load_state=resume_state,
    setup=exploration_setup(_build_agent, make_train_state),
    restore_rb=lambda cfg, state: state is not None and bool(cfg.buffer.checkpoint),
    test_name="zero-shot",
    make_player=make_player,
    generation=1,
)


@register_algorithm()
def main(runtime, cfg):
    """The exploration phase on the Dreamer loop (module docstring).
    Returns the run's summary."""
    return run_dreamer(runtime, cfg, P2E_DV1_EXPLORATION_FAMILY)

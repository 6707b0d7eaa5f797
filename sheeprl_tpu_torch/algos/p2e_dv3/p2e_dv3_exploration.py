"""Plan2Explore-DreamerV3's exploration phase (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``).

:func:`make_train_fn` builds the gradient step of ``make_train_fn``
(``p2e_dv3_exploration.py:72-566``), in JAX's order, from the parts of
DreamerV3's step:

1. the world model, its reward and continue heads on detached latents;
2. the ensembles' loss (each member regresses the next posterior from
   (z_t, h_t, a_t), summed over members) and their Adam step;
3. the starts: the (T, B) posteriors and recurrent states flattened B-major;
4. the exploration actor: imagination through the updated world model, and
   for each exploration critic the lambda returns of its reward (the
   ensemble's unbiased variance, averaged over the stochastic state and
   scaled by ``intrinsic_reward_multiplier``, or the reward model's), its own
   Moments, and its normalised advantage weighted by ``weight / sum of
   weights``; one step on the summed advantage;
5. each exploration critic's update;
6. the zero-shot task actor and critic: DreamerV3's behaviour step
   (``dreamer_v3.py:behaviour_step``).

The noise is JAX's five streams, drawn up front (:func:`draw_noise`) or fed
through ``noise=``: ``dyn`` (T, B, S, D); ``img_e``/``img_t`` (H, T*B, S, D)
and ``act_e``/``act_t`` (H + 1, T*B, sum(actions)) for the exploration's and
the task's imagination.  The policies' re-evaluation draws nothing.

:func:`main` is DreamerV3's env loop (``dreamer_v3.py:run_dreamer``) with
this agent and step: the player acts with the exploration actor, the
closing test runs the task actor (zero-shot), and the checkpoint holds the
JAX package's keys.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    DreamerFamily,
    DreamerRun,
    TrainState,
    behaviour_step,
    continues_and_discount,
    critic_update,
    imagination_noise,
    imagination_starts,
    imagine,
    lambda_returns,
    normalised_advantage,
    policy_loss,
    prepare_batch,
    resume_state,
    run_dreamer,
    step_,
    step_config,
    world_model_loss,
    world_model_metrics,
)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.algos.p2e_dv3.agent import P2EDV3Agent
from sheeprl_tpu_torch.optim import Adam, AdamState, build_optimizer
from sheeprl_tpu_torch.utils.distribution import TwoHotEncodingDistribution, gumbel_noise
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import trainable_params

__all__ = ["P2E_EXPLORATION_FAMILY", "draw_noise", "expand_exploration_metric_keys", "main", "make_train_fn",
           "make_train_state"]

GENERIC_KEYS = (
    "Loss/value_loss_exploration",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Grads/critic_exploration",
    "Rewards/intrinsic",
)


def draw_noise(cfg, seq_len: int, batch_size: int, actions_dim: Sequence[int], is_continuous: bool, *, device,
               generator=None) -> Dict[str, torch.Tensor]:
    """Every draw of one step (module docstring)."""
    wm_cfg = cfg.algo.world_model
    dyn = gumbel_noise((seq_len, batch_size, int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)),
                       like=torch.empty((), device=device), generator=generator)
    rows = seq_len * batch_size
    expl = imagination_noise(cfg, rows, actions_dim, is_continuous, device=device, generator=generator)
    task = imagination_noise(cfg, rows, actions_dim, is_continuous, device=device, generator=generator)
    return {"dyn": dyn, "img_e": expl["img"], "act_e": expl["act"], "img_t": task["img"], "act_t": task["act"]}


def make_train_fn(runtime, agent: P2EDV3Agent, txs: Dict[str, Adam], cfg, is_continuous: bool, actions_dim):
    """The gradient step: ``train(opt_states, moments, data, noise=None,
    generator=None) -> (opt_states, moments, metrics)``.  ``opt_states``
    and ``txs`` hold the groups ``world_model``, ``ensembles``, ``actor``
    and ``critic`` (the task's), ``actor_exploration`` and
    ``critics_exploration`` (by critic); ``moments`` is ``{"task": ...,
    "exploration": {critic: ...}}``; ``data`` a dict of (T, B, *) tensors."""
    sc = step_config(runtime, cfg, is_continuous, actions_dim)
    wm, ensembles = agent.world_model, agent.ensembles
    actor_expl = agent.actor_exploration
    critics_cfg = agent.critics_cfg
    weights_sum = sum(c["weight"] for c in critics_cfg.values())
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)
    params = {
        "world_model": trainable_params(wm), "ensembles": trainable_params(ensembles),
        "actor": trainable_params(agent.actor), "critic": trainable_params(agent.critic),
        "actor_exploration": trainable_params(actor_expl),
        "critics_exploration": {n: trainable_params(c["module"]) for n, c in agent.critics_exploration.items()},
    }

    def train(opt_states: Dict[str, AdamState], moments, data, noise=None, generator=None):
        T, B = data["rewards"].shape[:2]
        if noise is None:
            noise = draw_noise(cfg, T, B, actions_dim, is_continuous, device=data["rewards"].device, generator=generator)
        batch = prepare_batch(sc, data)

        # ------------------------------------------------ world model, heads on detached latents
        rec_loss, aux = world_model_loss(sc, wm, batch, noise["dyn"], detach_heads=True)
        wm_norm = step_(txs["world_model"], params["world_model"], rec_loss, opt_states["world_model"])

        # ------------------------------------------------ ensembles
        posts = aux["posteriors"].detach().reshape(T, B, sc.stoch_state_size)
        ens_in = torch.cat([posts, aux["recurrent_states"].detach(), batch["actions"]], -1)
        out = ensembles(ens_in)[:, :-1]
        ens_loss = ((out - posts[1:]) ** 2).sum(-1).mean((1, 2)).sum()
        ens_norm = step_(txs["ensembles"], params["ensembles"], ens_loss, opt_states["ensembles"])

        starts = imagination_starts(sc, aux, batch["terminated"])
        imagined_prior, recurrent_state, true_continue = starts

        # ------------------------------------------------ exploration behaviour
        with torch.set_grad_enabled(is_continuous):
            traj, actions = imagine(sc, wm.rssm, actor_expl, imagined_prior, recurrent_state, noise["img_e"],
                                    noise["act_e"])
            continues, discount = continues_and_discount(sc, wm, traj, true_continue)
            advantages, new_expl_moments, per_critic = [], {}, {}
            for name, ccfg in critics_cfg.items():
                module = agent.critics_exploration[name]["module"]
                predicted_values = TwoHotEncodingDistribution(module(traj), dims=1).mean
                if ccfg["reward_type"] == "intrinsic":
                    with torch.no_grad():
                        preds = ensembles(torch.cat([traj.detach(), actions.detach()], -1))
                        # the unbiased variance over the members, as torch's Tensor.var
                        reward = preds.var(0, correction=1).mean(-1, keepdim=True) * multiplier
                else:
                    reward = TwoHotEncodingDistribution(wm.reward_model(traj), dims=1).mean
                lambda_vals = lambda_returns(sc, reward, predicted_values, continues)
                new_expl_moments[name], adv = normalised_advantage(
                    sc, moments["exploration"][name], lambda_vals, predicted_values[:-1]
                )
                advantages.append(adv * ccfg["weight"] / weights_sum)
                per_critic[name] = {
                    "lambda_values": lambda_vals.detach(),
                    "predicted_values_mean": predicted_values.detach().mean(),
                    "reward_mean": reward.detach().mean() if ccfg["reward_type"] == "intrinsic" else None,
                }
            advantage = torch.stack(advantages, 0).sum(0)
        loss_expl = policy_loss(sc, actor_expl, traj, actions, advantage, discount)
        actor_expl_norm = step_(txs["actor_exploration"], params["actor_exploration"], loss_expl,
                                opt_states["actor_exploration"])

        critic_metrics = {}
        for name in critics_cfg:
            pair = agent.critics_exploration[name]
            v_loss, g_norm = critic_update(
                pair["module"], pair["target_module"], txs["critics_exploration"][name],
                opt_states["critics_exploration"][name], traj, per_critic[name]["lambda_values"], discount,
                params["critics_exploration"][name],
            )
            critic_metrics[f"Loss/value_loss_exploration_{name}"] = v_loss
            critic_metrics[f"Grads/critic_exploration_{name}"] = g_norm
            critic_metrics[f"Values_exploration/predicted_values_{name}"] = per_critic[name]["predicted_values_mean"]
            critic_metrics[f"Values_exploration/lambda_values_{name}"] = per_critic[name]["lambda_values"].mean()
            if per_critic[name]["reward_mean"] is not None:
                critic_metrics[f"Rewards/intrinsic_{name}"] = per_critic[name]["reward_mean"]

        # ------------------------------------------------ zero-shot task behaviour
        new_task_moments, loss_task, value_loss_task, actor_task_norm, critic_task_norm = behaviour_step(
            sc, agent, txs, opt_states, params, moments["task"], starts, noise["img_t"], noise["act_t"]
        )

        metrics = {
            **world_model_metrics(rec_loss, aux),
            "Loss/ensemble_loss": ens_loss.detach(),
            "Loss/policy_loss_exploration": loss_expl.detach(),
            "Loss/policy_loss_task": loss_task,
            "Loss/value_loss_task": value_loss_task,
            "Grads/world_model": wm_norm,
            "Grads/ensemble": ens_norm,
            "Grads/actor_exploration": actor_expl_norm,
            "Grads/actor_task": actor_task_norm,
            "Grads/critic_task": critic_task_norm,
            **critic_metrics,
        }
        return opt_states, {"task": new_task_moments, "exploration": new_expl_moments}, metrics

    return train


def make_train_state(runtime, agent: P2EDV3Agent, cfg, is_continuous: bool, actions_dim) -> TrainState:
    """An Adam per group, with its clip: the world model's, the ensembles',
    the actor's for both actors and the critic's for every critic."""
    precision = runtime.precision

    def tx(node):
        return build_optimizer(node.optimizer, node.clip_gradients, precision)

    algo = cfg.algo
    txs = {"world_model": tx(algo.world_model), "ensembles": tx(algo.ensembles), "actor": tx(algo.actor),
           "critic": tx(algo.critic), "actor_exploration": tx(algo.actor),
           "critics_exploration": {n: tx(algo.critic) for n in agent.critics_cfg}}
    groups = {"world_model": agent.world_model, "ensembles": agent.ensembles, "actor": agent.actor,
              "critic": agent.critic, "actor_exploration": agent.actor_exploration}
    opt_states = {g: txs[g].init(trainable_params(m)) for g, m in groups.items()}
    opt_states["critics_exploration"] = {
        n: txs["critics_exploration"][n].init(trainable_params(c["module"])) for n, c in agent.critics_exploration.items()
    }
    moments = {"task": init_moments(runtime.device),
               "exploration": {n: init_moments(runtime.device) for n in agent.critics_cfg}}
    train_fn = make_train_fn(runtime, agent, txs, cfg, is_continuous, actions_dim)
    return TrainState(agent, txs, opt_states, moments, train_fn)


def expand_exploration_metric_keys(cfg, critics_cfg) -> None:
    """The aggregator's generic exploration keys made one a critic
    (``p2e_dv3_exploration.py:569-586``)."""
    metrics = cfg.metric.aggregator.metrics
    for g in GENERIC_KEYS:
        if g in metrics:
            for name, ccfg in critics_cfg.items():
                if g == "Rewards/intrinsic" and ccfg["reward_type"] != "intrinsic":
                    continue
                metrics[f"{g}_{name}"] = metrics[g]
            metrics.pop(g, None)


def _setup(runtime, cfg, actions_dim, is_continuous, observation_space, state) -> DreamerRun:
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.utils.convert import load_p2e_state, p2e_state

    cfg.algo.player.actor_type = "exploration"
    agent = build_agent(runtime, actions_dim, is_continuous, cfg, observation_space)
    train_state = make_train_state(runtime, agent, cfg, is_continuous, actions_dim)
    if state is not None:
        load_p2e_state(agent, train_state, state, runtime.device)
    if "aggregator" in cfg.metric and "metrics" in cfg.metric.aggregator:
        expand_exploration_metric_keys(cfg, agent.critics_cfg)
    return DreamerRun(train_state, agent.actor_exploration, lambda: p2e_state(agent, train_state),
                      test_actor=agent.actor)


P2E_EXPLORATION_FAMILY = DreamerFamily(
    name="P2E-DV3",
    load_state=resume_state,
    setup=_setup,
    restore_rb=lambda cfg, state: state is not None and bool(cfg.buffer.checkpoint),
    test_name="zero-shot",
)


@register_algorithm()
def main(runtime, cfg):
    """The exploration phase on DreamerV3's env loop (module docstring).
    Returns the run's summary."""
    return run_dreamer(runtime, cfg, P2E_EXPLORATION_FAMILY)

"""DreamerV3 training steps (counterpart of the training half of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``).

:func:`make_train_fn` builds the gradient step of ``make_train_fn``
(``dreamer_v3.py:171-626``) from parts that Plan2Explore's step shares
(:func:`world_model_loss`, :func:`imagine`, :func:`normalised_advantage`,
:func:`policy_loss`, :func:`critic_update`, and :func:`behaviour_step`,
which is the last three steps below): the world-model loss over a dynamic scan of
the RSSM (with ``decoupled_rssm``: the posteriors from the observations
alone, then the recurrent states in one :func:`~sheeprl_tpu_torch.ops.seq_gru.gru_sequence`
where ``RSSM.seq_scan_eligible`` allows, else a loop of gated GRU steps),
one optimizer step of the world model; imagination from the
detached posteriors through the *updated* world model, the actor loss
against Moments-normalised lambda returns, one actor step; the critic loss
against the lambda returns and the target critic, one critic step.
Parameters and optimizer states are updated in place.

:func:`train_steps` is the training block of ``main`` (:913-949): for each
gradient step, the target critic's EMA (tau = 1 on the very first, and
always for DreamerV2's copies), then the step, on batches from :func:`~sheeprl_tpu_torch.data.device_buffer.sequence_batches`.

:func:`main` is the env loop (``dreamer_v3.py:634-1049``),
:func:`run_dreamer`, which DreamerV2, DreamerV1 and Plan2Explore's two
phases on each of the three share through their own :class:`DreamerFamily`
(V2 and V1 with their own replay rows, players and env settings), on the port's stepping
device vector env: random warm-up actions until
``learning_starts``, then the player's; every step's row and, where an
episode ended, a reset row into an ``EnvIndependentReplayBuffer`` of
``SequentialReplayBuffer``s and its device cache; ``Ratio``-granted
gradient steps through :func:`train_steps`; logging, checkpoints (the
replay buffer included, in the JAX package's layout) and the closing test
episode.  Raise, each naming its ROADMAP item: ``fabric.devices > 1``
(A5), the training-health sentinel (A2; ``guard_update`` is not ported),
the observability knobs (A7), ``buffer.memmap`` (A2) and ``bf16-true``
(A2).

Randomness: a step draws every sample's noise up front (:func:`draw_noise`)
from a ``torch.Generator``, or takes it pre-drawn.  The noise layout is
the JAX step's: Gumbel noise (T, B, S, D) for the dynamic scan, (H, T*B,
S, D) for imagination, and the actor's noise (H + 1, T*B, sum(actions))
(Gumbel per discrete head, standard normal for continuous actions).
Imagination rows are B-major: row r = b * T + t.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import DreamerAgent
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import compute_lambda_values, init_moments, update_moments
from sheeprl_tpu_torch.data.device_buffer import sequence_batches
from sheeprl_tpu_torch.optim import Adam, AdamState, build_optimizer, global_norm
from sheeprl_tpu_torch.utils.distribution import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
    gumbel_noise,
    normal_noise,
)
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import ema_
from sheeprl_tpu_torch.utils.utils import grads_or_zeros as _grads
from sheeprl_tpu_torch.utils.utils import trainable_params as _trainable

__all__ = [
    "DV3_FAMILY",
    "DreamerFamily",
    "DreamerRun",
    "StepConfig",
    "TrainState",
    "behaviour_step",
    "continues_and_discount",
    "critic_update",
    "draw_noise",
    "ema_",
    "imagination_noise",
    "imagination_starts",
    "imagine",
    "lambda_returns",
    "main",
    "make_train_fn",
    "make_train_state",
    "normalised_advantage",
    "policy_loss",
    "prepare_batch",
    "resume_state",
    "run_dreamer",
    "step_",
    "step_config",
    "train_steps",
    "world_model_loss",
    "world_model_metrics",
]


def draw_noise(
    cfg, seq_len: int, batch_size: int, actions_dim: Sequence[int], is_continuous: bool, *, device, generator=None
) -> Dict[str, torch.Tensor]:
    """Every draw of one train step: {"dyn", "img", "act"} (module docstring)."""
    wm_cfg = cfg.algo.world_model
    like = torch.empty((), device=device)
    dyn = gumbel_noise((seq_len, batch_size, int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)), like=like,
                       generator=generator)
    return {"dyn": dyn, **imagination_noise(cfg, seq_len * batch_size, actions_dim, is_continuous, device=device,
                                            generator=generator)}


def imagination_noise(cfg, rows: int, actions_dim: Sequence[int], is_continuous: bool, *, device,
                      generator=None) -> Dict[str, torch.Tensor]:
    """The draws of one imagination from ``rows`` starts: {"img", "act"}
    (module docstring)."""
    wm_cfg = cfg.algo.world_model
    horizon = int(cfg.algo.horizon)
    like = torch.empty((), device=device)
    draw = normal_noise if is_continuous else gumbel_noise
    return {
        "img": gumbel_noise((horizon, rows, int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)), like=like,
                            generator=generator),
        "act": draw((horizon + 1, rows, int(np.sum(actions_dim))), like=like, generator=generator),
    }


@dataclass(frozen=True)
class StepConfig:
    """The constants of a DreamerV3 gradient step, read from ``cfg`` once."""

    cnn_keys: tuple
    mlp_keys: tuple
    cnn_keys_dec: tuple
    mlp_keys_dec: tuple
    stochastic_size: int
    discrete_size: int
    recurrent_state_size: int
    horizon: int
    gamma: float
    lmbda: float
    ent_coef: float
    kl: dict
    moments: tuple  # decay, max, percentile low, percentile high
    decoupled: bool
    compute_dtype: torch.dtype
    is_continuous: bool
    splits: tuple

    @property
    def stoch_state_size(self) -> int:
        return self.stochastic_size * self.discrete_size


def step_config(runtime, cfg, is_continuous: bool, actions_dim) -> StepConfig:
    wm_cfg = cfg.algo.world_model
    moments_cfg = cfg.algo.actor.moments
    return StepConfig(
        cnn_keys=tuple(cfg.algo.cnn_keys.encoder),
        mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
        cnn_keys_dec=tuple(cfg.algo.cnn_keys.decoder),
        mlp_keys_dec=tuple(cfg.algo.mlp_keys.decoder),
        stochastic_size=int(wm_cfg.stochastic_size),
        discrete_size=int(wm_cfg.discrete_size),
        recurrent_state_size=int(wm_cfg.recurrent_model.recurrent_state_size),
        horizon=int(cfg.algo.horizon),
        gamma=float(cfg.algo.gamma),
        lmbda=float(cfg.algo.lmbda),
        ent_coef=float(cfg.algo.actor.ent_coef),
        kl=dict(
            kl_dynamic=float(wm_cfg.kl_dynamic),
            kl_representation=float(wm_cfg.kl_representation),
            kl_free_nats=float(wm_cfg.kl_free_nats),
            kl_regularizer=float(wm_cfg.kl_regularizer),
            continue_scale_factor=float(wm_cfg.continue_scale_factor),
        ),
        moments=(float(moments_cfg.decay), float(moments_cfg.max), float(moments_cfg.percentile.low),
                 float(moments_cfg.percentile.high)),
        decoupled=bool(wm_cfg.decoupled_rssm),
        compute_dtype=runtime.compute_dtype,
        is_continuous=bool(is_continuous),
        splits=tuple(int(c) for c in np.cumsum(actions_dim)[:-1]),
    )


def prepare_batch(sc: StepConfig, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's inputs from a (T, B) batch: the observations (images to
    [-0.5, 0.5)), ``is_first`` with its first row set, the previous actions
    (a_t in the buffer acted after o_t; the RSSM input at t is the previous
    action), the rewards and the terminations."""
    batch_obs = {k: data[k].float() / 255.0 - 0.5 for k in sc.cnn_keys}
    batch_obs.update({k: data[k].float() for k in sc.mlp_keys})
    is_first = data["is_first"].float().clone()
    is_first[0] = 1.0
    actions = data["actions"].float()
    return {
        "obs": batch_obs,
        "is_first": is_first,
        "actions": actions,
        "prev_actions": torch.cat([torch.zeros_like(actions[:1]), actions[:-1]], 0),
        "rewards": data["rewards"].float(),
        "terminated": data["terminated"].float(),
    }


def world_model_loss(sc: StepConfig, wm, batch: Dict[str, torch.Tensor], dyn_noise: torch.Tensor,
                     detach_heads: bool = False):
    """The world model's loss over a (T, B) batch (``dreamer_v3.py`` world
    model block): the dynamic scan of the RSSM (with ``decoupled_rssm`` the
    posteriors from the observations alone, then the recurrent states in
    one ``gru_sequence`` where ``RSSM.seq_scan_eligible`` allows, else a
    loop of gated GRU steps), the priors, the reconstruction, reward and
    continue heads and the KL terms.  ``detach_heads``: the reward and
    continue heads read detached latents (Plan2Explore's exploration
    phase).  -> ``(loss, aux)``, ``aux`` the posteriors, recurrent states,
    both logits and the loss terms."""
    rssm = wm.rssm
    T, B = batch["rewards"].shape[:2]
    device = batch["rewards"].device
    batch_obs, is_first, batch_actions = batch["obs"], batch["is_first"], batch["prev_actions"]
    enc_obs = {k: batch_obs[k].to(sc.compute_dtype) for k in sc.cnn_keys}
    enc_obs.update({k: batch_obs[k] for k in sc.mlp_keys})
    embedded_obs = wm.encoder(enc_obs)  # (T, B, E)
    init_rec, init_post = rssm.get_initial_states((B,))
    init_states = (init_rec, init_post.reshape(B, -1))
    if sc.decoupled:
        # the posteriors depend on the observations alone: all of them up
        # front, then the recurrent model on the previous posteriors, its
        # input projection batched over the sequence and only the GRU
        # sequential
        posteriors_logits, posteriors = rssm._representation(embedded_obs, None, noise=dyn_noise)
        prev_posteriors = torch.cat([torch.zeros_like(posteriors[:1]), posteriors[:-1]], 0)
        feats = rssm.recurrent_features_seq(prev_posteriors, batch_actions, is_first, init_states[1])
        if rssm.seq_scan_eligible(int(feats.shape[-1])):
            recurrent_states = rssm.gru_sequence_gated(feats, is_first, init_states[0])
        else:
            recurrent_state = torch.zeros(B, sc.recurrent_state_size, device=device)
            recs = []
            for t in range(T):
                recurrent_state = rssm.gru_step_gated(feats[t], recurrent_state, is_first[t], init_states[0])
                recs.append(recurrent_state)
            recurrent_states = torch.stack(recs)
    else:
        emb_proj = rssm.representation_embed_proj(embedded_obs)
        posterior = torch.zeros(B, sc.stochastic_size, sc.discrete_size, device=device)
        recurrent_state = torch.zeros(B, sc.recurrent_state_size, device=device)
        recs, posts, post_logits = [], [], []
        for t in range(T):
            recurrent_state, posterior, logits = rssm.dynamic_posterior(
                posterior, recurrent_state, batch_actions[t], emb_proj[t], is_first[t], init_states,
                noise=dyn_noise[t],
            )
            recs.append(recurrent_state)
            posts.append(posterior)
            post_logits.append(logits)
        recurrent_states = torch.stack(recs)
        posteriors = torch.stack(posts)  # (T, B, S, D)
        posteriors_logits = torch.stack(post_logits)
    priors_logits, _ = rssm._transition(recurrent_states, sample_state=False)
    latent_states = torch.cat([posteriors.reshape(T, B, -1), recurrent_states], -1)
    reconstructed = wm.observation_model(latent_states)
    po = {k: MSEDistribution(reconstructed[k], dims=reconstructed[k].dim() - 2) for k in sc.cnn_keys_dec}
    po.update({k: SymlogDistribution(reconstructed[k], dims=reconstructed[k].dim() - 2) for k in sc.mlp_keys_dec})
    head_in = latent_states.detach() if detach_heads else latent_states
    pr = TwoHotEncodingDistribution(wm.reward_model(head_in), dims=1)
    pc = Independent(BernoulliSafeMode(logits=wm.continue_model(head_in)), 1)
    pl = priors_logits.reshape(T, B, sc.stochastic_size, sc.discrete_size)
    psl = posteriors_logits.reshape(T, B, sc.stochastic_size, sc.discrete_size)
    rec_loss, kl_value, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
        po, batch_obs, pr, batch["rewards"], pl, psl, pc=pc, continue_targets=1 - batch["terminated"], **sc.kl
    )
    aux = {
        "posteriors": posteriors, "recurrent_states": recurrent_states, "posteriors_logits": psl,
        "priors_logits": pl, "kl": kl_value, "state_loss": state_loss, "reward_loss": reward_loss,
        "observation_loss": observation_loss, "continue_loss": continue_loss,
    }
    return rec_loss, aux


def world_model_metrics(rec_loss: torch.Tensor, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The world model's entries of the step's metrics."""
    with torch.no_grad():
        post_ent = Independent(OneHotCategorical(logits=aux["posteriors_logits"].detach()), 1).entropy().mean()
        prior_ent = Independent(OneHotCategorical(logits=aux["priors_logits"].detach()), 1).entropy().mean()
    return {
        "Loss/world_model_loss": rec_loss.detach(),
        "Loss/observation_loss": aux["observation_loss"].detach(),
        "Loss/reward_loss": aux["reward_loss"].detach(),
        "Loss/state_loss": aux["state_loss"].detach(),
        "Loss/continue_loss": aux["continue_loss"].detach(),
        "State/kl": aux["kl"].detach(),
        "State/post_entropy": post_ent,
        "State/prior_entropy": prior_ent,
    }


def imagination_starts(sc: StepConfig, aux: Dict[str, torch.Tensor], terminated: torch.Tensor):
    """The detached (T, B) posteriors and recurrent states flattened B-major
    (row r = b * T + t) as imagination's starts, and the true continues
    (1, T * B, 1)."""
    T, B = terminated.shape[:2]
    imagined_prior = aux["posteriors"].detach().transpose(0, 1).reshape(T * B, sc.stoch_state_size)
    recurrent_state = aux["recurrent_states"].detach().transpose(0, 1).reshape(T * B, sc.recurrent_state_size)
    true_continue = (1 - terminated).transpose(0, 1).reshape(1, T * B, 1)
    return imagined_prior, recurrent_state, true_continue


def imagine(sc: StepConfig, rssm, actor, imagined_prior: torch.Tensor, recurrent_state: torch.Tensor,
            img_noise: torch.Tensor, act_noise: torch.Tensor):
    """``horizon`` imagined steps from the starts, each action drawn from
    ``actor`` on the detached latent (``_imagine``): -> the trajectories
    (H + 1, T*B, L) and the actions (H + 1, T*B, A).  The caller decides
    whether autograd records it."""
    latent0 = torch.cat([imagined_prior, recurrent_state], -1).to(sc.compute_dtype)
    acts, _ = actor(latent0.detach(), False, noise=act_noise[0])
    action = torch.cat(acts, -1)
    latents, imagined_actions = [latent0], [action]
    for i in range(sc.horizon):
        imagined_prior, recurrent_state = rssm.imagination(imagined_prior, recurrent_state, action, noise=img_noise[i])
        imagined_prior = imagined_prior.reshape(-1, sc.stoch_state_size)
        latent = torch.cat([imagined_prior, recurrent_state], -1)
        acts, _ = actor(latent.detach(), False, noise=act_noise[i + 1])
        action = torch.cat(acts, -1)
        latents.append(latent.to(sc.compute_dtype))
        imagined_actions.append(action)
    return torch.stack(latents), torch.stack(imagined_actions)


def continues_and_discount(sc: StepConfig, wm, traj: torch.Tensor, true_continue: torch.Tensor):
    """The continue head's mode on the trajectories with the true continues
    in the first row, and the discount ``cumprod(continues * gamma) / gamma``
    (detached)."""
    continues = Independent(BernoulliSafeMode(logits=wm.continue_model(traj)), 1).mode
    continues = torch.cat([true_continue, continues[1:]], 0)
    discount = (torch.cumprod(continues * sc.gamma, 0) / sc.gamma).detach()
    return continues, discount


def lambda_returns(sc: StepConfig, rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor) -> torch.Tensor:
    return compute_lambda_values(rewards[1:], values[1:], continues[1:] * sc.gamma, sc.lmbda)


def normalised_advantage(sc: StepConfig, moments: Dict[str, torch.Tensor], lambda_vals: torch.Tensor,
                         baseline: torch.Tensor):
    """The Moments update on the lambda returns and the normalised
    advantage against ``baseline``: -> ``(new_moments, advantage)``."""
    new_moments, offset, invscale = update_moments(moments, lambda_vals, *sc.moments)
    return new_moments, (lambda_vals - offset) / invscale - (baseline - offset) / invscale


def policy_loss(sc: StepConfig, actor, traj: torch.Tensor, imagined_actions: torch.Tensor, advantage: torch.Tensor,
                discount: torch.Tensor) -> torch.Tensor:
    """The actor's objective on the trajectories (``_policy_objective``):
    the advantage itself for continuous actions (it carries the gradient
    through the dynamics), else the log-probs of the detached actions
    times the detached advantage; plus the entropy bonus, discounted."""
    _, policies = actor(traj.detach(), True)
    if sc.is_continuous:
        objective = advantage
    else:
        sub_actions = torch.tensor_split(imagined_actions, list(sc.splits), -1)
        logps = torch.stack(
            [p.log_prob(a.detach())[:-1][..., None] for p, a in zip(policies, sub_actions)], -1
        ).sum(-1)
        objective = logps * advantage.detach()
    try:
        entropy = sc.ent_coef * torch.stack([p.entropy() for p in policies], -1).sum(-1)
    except (AttributeError, NotImplementedError):  # a distribution without entropy
        entropy = torch.zeros(traj.shape[:2], device=traj.device)
    return -torch.mean(discount[:-1] * (objective + entropy[..., None][:-1]))


def critic_update(critic, target_critic, tx, opt_state, traj: torch.Tensor, lambda_vals: torch.Tensor,
                  discount: torch.Tensor, params: Dict[str, torch.Tensor]):
    """One step of ``params`` (the critic's) against the lambda returns and
    its target's values on the detached trajectories (``_critic_update``):
    -> ``(loss, grad norm)``."""
    traj = traj.detach()[:-1]
    lambda_vals = lambda_vals.detach()
    qv = TwoHotEncodingDistribution(critic(traj), dims=1)
    with torch.no_grad():
        predicted_target_values = TwoHotEncodingDistribution(target_critic(traj), dims=1).mean
    value_loss = -qv.log_prob(lambda_vals) - qv.log_prob(predicted_target_values)
    value_loss = torch.mean(value_loss * discount[:-1].squeeze(-1))
    grads = _grads(value_loss, params)
    norm = global_norm(grads.values())
    tx.update(params, grads, opt_state, norm=norm)
    return value_loss.detach(), norm


def step_(tx, params: Dict[str, torch.Tensor], loss: torch.Tensor, opt_state) -> torch.Tensor:
    """One optimizer step of ``params`` on ``loss``: -> the gradients' global norm."""
    grads = _grads(loss, params)
    norm = global_norm(grads.values())
    tx.update(params, grads, opt_state, norm=norm)
    return norm


def behaviour_step(sc: StepConfig, agent: DreamerAgent, txs, opt_states, params, moments: Dict[str, torch.Tensor],
                   starts, img_noise: torch.Tensor, act_noise: torch.Tensor):
    """The task behaviour of one gradient step: imagination from ``starts``
    (:func:`imagination_starts`) through the updated world model with
    ``agent.actor``, one actor step against the Moments-normalised lambda
    returns of ``agent.critic``, one critic step.  ``txs``, ``opt_states``
    and ``params`` hold the groups ``actor`` and ``critic``.  -> ``(new
    moments, policy loss, value loss, actor grad norm, critic grad norm)``."""
    wm, actor, critic = agent.world_model, agent.actor, agent.critic
    imagined_prior, recurrent_state, true_continue = starts
    # with discrete actions nothing differentiable flows through the
    # rollout (the objective is logp * sg(advantage)): build no graph
    with torch.set_grad_enabled(sc.is_continuous):
        traj, imagined_actions = imagine(sc, wm.rssm, actor, imagined_prior, recurrent_state, img_noise, act_noise)
        predicted_values = TwoHotEncodingDistribution(critic(traj), dims=1).mean
        predicted_rewards = TwoHotEncodingDistribution(wm.reward_model(traj), dims=1).mean
        continues, discount = continues_and_discount(sc, wm, traj, true_continue)
        lambda_vals = lambda_returns(sc, predicted_rewards, predicted_values, continues)

    # ------------------------------------------------ actor
    new_moments, advantage = normalised_advantage(sc, moments, lambda_vals, predicted_values[:-1])
    loss = policy_loss(sc, actor, traj, imagined_actions, advantage, discount)
    actor_norm = step_(txs["actor"], params["actor"], loss, opt_states["actor"])

    # ------------------------------------------------ critic
    value_loss, critic_norm = critic_update(critic, agent.target_critic, txs["critic"], opt_states["critic"], traj,
                                            lambda_vals, discount, params["critic"])
    return new_moments, loss.detach(), value_loss, actor_norm, critic_norm


def make_train_fn(runtime, agent: DreamerAgent, txs: Dict[str, Adam], cfg, is_continuous: bool, actions_dim):
    """The gradient step: ``train(opt_states, moments, data, noise=None,
    generator=None) -> (opt_states, moments, metrics)``, ``data`` a dict of
    (T, B, *) tensors on the agent's device, ``metrics`` the JAX step's
    dict of 0-d tensors (nothing is copied to the host)."""
    wm = agent.world_model
    sc = step_config(runtime, cfg, is_continuous, actions_dim)
    params = {"world_model": _trainable(wm), "actor": _trainable(agent.actor), "critic": _trainable(agent.critic)}

    def train(opt_states: Dict[str, AdamState], moments: Dict[str, torch.Tensor], data, noise=None, generator=None):
        T, B = data["rewards"].shape[:2]
        if noise is None:
            noise = draw_noise(cfg, T, B, actions_dim, is_continuous, device=data["rewards"].device, generator=generator)
        batch = prepare_batch(sc, data)

        # ------------------------------------------------ world model
        rec_loss, aux = world_model_loss(sc, wm, batch, noise["dyn"])
        wm_norm = step_(txs["world_model"], params["world_model"], rec_loss, opt_states["world_model"])

        # ------------------------------------------------ behaviour, imagined through the updated world model
        starts = imagination_starts(sc, aux, batch["terminated"])
        new_moments, loss, value_loss, actor_norm, critic_norm = behaviour_step(
            sc, agent, txs, opt_states, params, moments, starts, noise["img"], noise["act"]
        )

        metrics = {
            **world_model_metrics(rec_loss, aux),
            "Loss/policy_loss": loss,
            "Loss/value_loss": value_loss,
            "Grads/world_model": wm_norm,
            "Grads/actor": actor_norm,
            "Grads/critic": critic_norm,
        }
        return opt_states, new_moments, metrics

    return train


@dataclass
class TrainState:
    """What ``main`` carries between gradient steps."""

    agent: DreamerAgent
    txs: Dict[str, Adam]
    opt_states: Dict[str, AdamState]
    moments: Dict[str, torch.Tensor]
    train_fn: Callable
    gradient_steps: int = 0  # cumulative_per_rank_gradient_steps
    metrics: Optional[Dict[str, torch.Tensor]] = None


def make_train_state(runtime, agent: DreamerAgent, cfg, is_continuous: bool, actions_dim) -> TrainState:
    """Optimizers (``build_optimizer`` per group, with its clip), their
    states, the Moments state and the train step for ``agent``."""
    precision = runtime.precision
    groups = {"world_model": agent.world_model, "actor": agent.actor, "critic": agent.critic}
    txs = {
        name: build_optimizer(cfg.algo[name].optimizer, cfg.algo[name].clip_gradients, precision) for name in groups
    }
    opt_states = {name: txs[name].init(_trainable(module)) for name, module in groups.items()}
    train_fn = make_train_fn(runtime, agent, txs, cfg, is_continuous, actions_dim)
    return TrainState(agent, txs, opt_states, init_moments(runtime.device), train_fn)


def train_steps(
    state: TrainState,
    rb,
    device_cache,
    cfg,
    per_rank_gradient_steps: int,
    generator: Optional[torch.Generator] = None,
    noises: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
) -> List[Dict[str, torch.Tensor]]:
    """The training block of ``main``: ``per_rank_gradient_steps`` steps on
    one draw of sequence batches, each after the update of the agent's
    target critics (``target_pairs``) every
    ``per_rank_target_network_update_freq`` steps: an EMA with
    ``critic.tau``, tau 1 on the very first step and wherever the critic's
    config has no ``tau`` (DreamerV2's hard copy).  ``noises`` optionally
    gives each step's pre-drawn noise.  Returns each step's metrics."""
    critic_cfg = cfg.algo.critic
    device = next(state.agent.parameters()).device
    pairs = state.agent.target_pairs()
    out = []
    with sequence_batches(
        rb, device_cache, device, per_rank_gradient_steps, int(cfg.algo.per_rank_batch_size),
        int(cfg.algo.per_rank_sequence_length), generator,
    ) as feed:
        for i, batch in enumerate(feed):
            if pairs and state.gradient_steps % int(critic_cfg.per_rank_target_network_update_freq) == 0:
                tau = 1.0 if state.gradient_steps == 0 else float(critic_cfg.get("tau", 1.0))
                for target, source in pairs:
                    ema_(target, source, tau)
            state.opt_states, state.moments, state.metrics = state.train_fn(
                state.opt_states, state.moments, batch, noise=None if noises is None else noises[i], generator=generator
            )
            state.gradient_steps += 1
            out.append(state.metrics)
    return out


@dataclass
class DreamerRun:
    """What a family's ``setup`` gives :func:`run_dreamer`: the train state,
    the actor the player starts with, the actor it switches to at the first
    gradient step (None: none) and the one the closing test runs (None: the
    player's), and the checkpoint's model, optimizer and Moments entries."""

    train_state: TrainState
    player_actor: torch.nn.Module
    ckpt_state: Callable[[], Dict]
    train_actor: Optional[torch.nn.Module] = None
    test_actor: Optional[torch.nn.Module] = None


@dataclass(frozen=True)
class DreamerFamily:
    """What :func:`run_dreamer` builds for one family of agents: its name in
    messages, the state it starts from (``load_state(cfg)``, which may pin
    ``cfg``; None: a fresh start), its run (``setup(runtime, cfg,
    actions_dim, is_continuous, obs_space, state)`` -> :class:`DreamerRun`),
    whether the replay buffer comes from the state (``restore_rb(cfg,
    state)``), whether the warm-up acts at random, the closing test's name,
    and the player (``make_player(modules, cfg, actions_dim, num_envs)``
    around the run's
    :class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.DreamerPlayer`; None:
    ``PlayerDV3``).  Every family trains through :func:`train_steps` with
    its train state's ``train_fn``.

    ``generation`` (3, 2 or 1) is the Dreamer whose loop conventions the
    family keeps.  DreamerV3 writes row t before the step (o_t, the action
    taken at it, the reward that led to it) and its reset rows from the
    final observations, stacks no frames (``env.frame_stack = -1``), takes
    power-of-two screens and tests sampling.  DreamerV2 seeds the buffer
    with a zero-action row, writes row t after the step (the observation
    reached, the action and reward that led to it), ``is_first`` from the
    previous step's ends and its reset rows from the new episodes' first
    observations (``dreamer_v2.py:565-664``), sets ``env.frame_stack = 1``,
    tests greedily and keeps only the sequential buffer.  DreamerV1 is V2
    without the ``is_first`` column, its player's exploration amount
    decaying with the policy step, which the loop passes it and logs
    (``Params/exploration_amount``)."""

    name: str
    load_state: Callable
    setup: Callable
    restore_rb: Callable
    random_warmup: bool = True
    test_name: str = ""
    make_player: Optional[Callable] = None
    generation: int = 3


def resume_state(cfg):
    """The checkpoint of ``checkpoint.resume_from``, or None."""
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

    return load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None


def _dv3_setup(runtime, cfg, actions_dim, is_continuous, observation_space, state) -> DreamerRun:
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.utils.convert import (
        adam_state_from_tree,
        adam_state_to_tree,
        load_flax_params,
        moments_to_torch,
        torch_to_flax,
    )

    agent = build_agent(runtime, actions_dim, is_continuous, cfg, observation_space)
    train_state = make_train_state(runtime, agent, cfg, is_continuous, actions_dim)
    groups = {"world_model": agent.world_model, "actor": agent.actor, "critic": agent.critic}
    if state is not None:
        load_flax_params(agent, {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")})
        train_state.opt_states = {g: adam_state_from_tree(state["opt_states"][g], m, g) for g, m in groups.items()}
        train_state.moments = moments_to_torch(state["moments"], runtime.device)

    def ckpt_state():
        params = torch_to_flax(agent)
        return {
            **{k: params[k] for k in ("world_model", "actor", "critic", "target_critic")},
            "opt_states": {g: adam_state_to_tree(train_state.opt_states[g], m, g) for g, m in groups.items()},
            "moments": dict(train_state.moments),
        }

    return DreamerRun(train_state, agent.actor, ckpt_state)


DV3_FAMILY = DreamerFamily(
    name="DreamerV3",
    load_state=resume_state,
    setup=_dv3_setup,
    restore_rb=lambda cfg, state: state is not None and bool(cfg.buffer.checkpoint),
)


@register_algorithm()
def main(runtime, cfg):
    """The DreamerV3 env loop (module docstring): :func:`run_dreamer`."""
    return run_dreamer(runtime, cfg, DV3_FAMILY)


def _dv3_player(modules, cfg, actions_dim, num_envs):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3

    wm_cfg = cfg.algo.world_model
    return PlayerDV3(modules, actions_dim, num_envs, wm_cfg.stochastic_size, wm_cfg.recurrent_model.recurrent_state_size,
                     discrete_size=wm_cfg.discrete_size, decoupled_rssm=bool(wm_cfg.decoupled_rssm))


def run_dreamer(runtime, cfg, family: DreamerFamily = DV3_FAMILY):
    """The env loop that DreamerV3, DreamerV2, DreamerV1 and Plan2Explore's
    two phases on each share (module docstring; their differences are fields of
    :class:`DreamerFamily`).  Returns the run's summary: log dir, last
    checkpoint, policy and gradient steps, iterations, test reward, whether
    the player had switched to the run's ``train_actor`` by the end, and the
    seconds spent in the warm-up iterations, in the iterations from
    ``learning_starts`` on and in their gradient steps."""
    import time

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import DreamerPlayer, WorldModel
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import maybe_create_for
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.resilience.manager import CheckpointManager, restore_buffer
    from sheeprl_tpu_torch.utils.env import make_train_envs
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import (
        MetricFetchGate,
        Ratio,
        check_loop_scope,
        fetch_actions,
        fetch_metrics,
        save_configs,
    )

    check_loop_scope(runtime, cfg, family.name, off_policy=True)
    world_size = runtime.world_size
    runtime.seed_everything(cfg.seed)
    state = family.load_state(cfg)
    resumed = bool(cfg.checkpoint.resume_from)

    v3 = family.generation == 3
    cfg.env.frame_stack = -1 if v3 else 1
    if v3 and 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")
    if not v3 and str(cfg.buffer.get("type", "sequential")).lower() != "sequential":
        raise NotImplementedError(
            f"buffer.type={cfg.buffer.type} (the episode buffer, host only) waits for ROADMAP A2 (host envs); "
            "use buffer.type=sequential"
        )

    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    runtime.print(f"Log dir: {log_dir}")
    if logger:
        logger.log_hyperparams(cfg)

    total_envs = cfg.env.num_envs * world_size
    envs = make_train_envs(cfg, runtime, wrapper_chain=True)
    observation_space = envs.single_observation_space
    actions_dim, is_continuous = spaces.action_space_dims(envs.single_action_space)
    clip_rewards_fn = (lambda r: np.tanh(r)) if cfg.env.clip_rewards else (lambda r: r)
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")

    if (
        len(set(cfg.algo.cnn_keys.encoder).intersection(set(cfg.algo.cnn_keys.decoder))) == 0
        and len(set(cfg.algo.mlp_keys.encoder).intersection(set(cfg.algo.mlp_keys.decoder))) == 0
    ):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    if len(set(cfg.algo.cnn_keys.decoder) - set(cfg.algo.cnn_keys.encoder)) > 0:
        raise RuntimeError("The CNN keys of the decoder must be contained in the encoder ones")
    if len(set(cfg.algo.mlp_keys.decoder) - set(cfg.algo.mlp_keys.encoder)) > 0:
        raise RuntimeError("The MLP keys of the decoder must be contained in the encoder ones")
    if cfg.metric.log_level > 0:
        runtime.print("Encoder CNN keys:", cfg.algo.cnn_keys.encoder)
        runtime.print("Encoder MLP keys:", cfg.algo.mlp_keys.encoder)
        runtime.print("Decoder CNN keys:", cfg.algo.cnn_keys.decoder)
        runtime.print("Decoder MLP keys:", cfg.algo.mlp_keys.decoder)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)

    run = family.setup(runtime, cfg, actions_dim, is_continuous, observation_space, state)
    train_state = run.train_state
    wm = train_state.agent.world_model
    make_player = family.make_player or _dv3_player
    player = make_player(DreamerPlayer(WorldModel(wm.encoder, wm.rssm), run.player_actor), cfg, actions_dim, total_envs)
    is_first_column, exploration_decay = family.generation != 1, family.generation == 1
    act_kwargs = (lambda: {"step": policy_step}) if exploration_decay else dict
    save_configs(cfg, log_dir)

    aggregator = None if MetricAggregator.disabled else instantiate(dict(cfg.metric.aggregator))

    buffer_size = cfg.buffer.size // total_envs if not cfg.dry_run else 2
    rb = EnvIndependentReplayBuffer(
        max(buffer_size, 2), n_envs=total_envs, memmap=cfg.buffer.memmap, buffer_cls=SequentialReplayBuffer
    )
    restored_rb = family.restore_rb(cfg, state)
    if restored_rb:
        rb = restore_buffer(state["rb"])
    device_cache = maybe_create_for(cfg, runtime, rb, state if restored_rb else None)

    train_step = 0
    last_train = 0
    start_iter = (state["iter_num"] // world_size) + 1 if resumed else 1
    policy_step = state["iter_num"] * cfg.env.num_envs if resumed else 0
    last_log = state["last_log"] if resumed else 0
    last_checkpoint = state["last_checkpoint"] if resumed else 0
    policy_steps_per_iter = int(total_envs)
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_iter if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if resumed:
        cfg.algo.per_rank_batch_size = state["batch_size"] // world_size
        learning_starts += start_iter
        prefill_steps += start_iter

    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if resumed:
        ratio.load_state_dict(state["ratio"])

    ckpt_mgr = CheckpointManager(runtime, cfg, log_dir, last_checkpoint=last_checkpoint)

    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=cfg.seed)[0]
    for k in obs_keys:
        step_data[k] = obs[k][np.newaxis]
    if v3:
        step_data["rewards"] = np.zeros((1, total_envs, 1))
        step_data["truncated"] = np.zeros((1, total_envs, 1))
        step_data["terminated"] = np.zeros((1, total_envs, 1))
        step_data["is_first"] = np.ones_like(step_data["terminated"])
    else:
        # the zero-action seed row
        step_data["terminated"] = np.zeros((1, total_envs, 1))
        step_data["truncated"] = np.zeros((1, total_envs, 1))
        if cfg.dry_run and family.generation == 2:
            step_data["truncated"] = step_data["truncated"] + 1
            step_data["terminated"] = step_data["terminated"] + 1
        step_data["actions"] = np.zeros((1, total_envs, int(np.sum(actions_dim))))
        step_data["rewards"] = np.zeros((1, total_envs, 1))
        if is_first_column:
            step_data["is_first"] = np.ones_like(step_data["terminated"])
        rb.add(step_data, validate_args=cfg.buffer.validate_args)
        if device_cache is not None:
            device_cache.add(step_data)
    player.init_states()

    metric_fetch_gate = MetricFetchGate(cfg.metric.get("fetch_every", 1))
    heartbeat_t = time.perf_counter()
    seconds = {"warmup_s": 0.0, "training_s": 0.0, "train_s": 0.0}
    last_path = None
    for iter_num in range(start_iter, total_iters + 1):
        iter_t0 = time.perf_counter()
        policy_step += policy_steps_per_iter

        with timer("Time/env_interaction_time", SumMetric, sync_on_compute=False):
            if family.random_warmup and iter_num <= learning_starts and cfg.checkpoint.resume_from is None:
                real_actions = actions = envs.sample_actions().cpu().numpy()
                if not is_continuous:
                    actions = np.concatenate(
                        [
                            np.eye(act_dim, dtype=np.float32)[act]
                            for act, act_dim in zip(actions.reshape(len(actions_dim), -1), actions_dim)
                        ],
                        axis=-1,
                    )
            else:
                prepared = prepare_obs(
                    {k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=total_envs, device=runtime.device
                )
                mask = {k: v for k, v in prepared.items() if k.startswith("mask")} or None
                action_list = player.get_actions(prepared, False, runtime.generator, mask, **act_kwargs())
                actions, real_actions = fetch_actions(action_list, actions_dim, is_continuous, total_envs)

            if v3:
                step_data["actions"] = np.asarray(actions).reshape(1, total_envs, -1)
                rb.add(step_data, validate_args=cfg.buffer.validate_args)
                if device_cache is not None:
                    device_cache.add(step_data)
            elif is_first_column:
                step_data["is_first"] = np.logical_or(step_data["terminated"], step_data["truncated"]).astype(np.float32)

            next_obs, rewards, terminated, truncated, infos = envs.step(
                np.asarray(real_actions).reshape(total_envs, *envs.single_action_space.shape)
            )
            dones = np.logical_or(terminated, truncated).astype(np.uint8)

        if v3:
            step_data["is_first"] = np.zeros_like(step_data["terminated"])

        if cfg.metric.log_level > 0 and "final_info" in infos:
            ep = infos["final_info"]["episode"]
            for i in np.nonzero(infos["final_info"]["_episode"])[0]:
                if aggregator and not aggregator.disabled:
                    aggregator.update("Rewards/rew_avg", float(ep["r"][i]))
                    aggregator.update("Game/ep_len_avg", float(ep["l"][i]))
                runtime.print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={float(ep['r'][i])}")

        real_next_obs = {k: np.array(v) for k, v in next_obs.items()}
        if "final_obs" in infos:
            for idx in np.nonzero(infos["_final_obs"])[0]:
                for k, v in infos["final_obs"][idx].items():
                    real_next_obs[k][idx] = v

        for k in obs_keys:
            step_data[k] = (next_obs if v3 else real_next_obs)[k][np.newaxis]
        obs = next_obs

        rewards = rewards.reshape((1, total_envs, -1))
        step_data["terminated"] = terminated.reshape((1, total_envs, -1)).astype(np.float32)
        step_data["truncated"] = truncated.reshape((1, total_envs, -1)).astype(np.float32)
        step_data["rewards"] = clip_rewards_fn(rewards)
        if not v3:
            step_data["actions"] = np.asarray(actions).reshape(1, total_envs, -1)
            rb.add(step_data, validate_args=cfg.buffer.validate_args)
            if device_cache is not None:
                device_cache.add(step_data)

        dones_idxes = dones.nonzero()[0].tolist()
        reset_envs = len(dones_idxes)
        if reset_envs > 0 and not v3:
            # the new episodes' first rows
            reset_data = {k: (next_obs[k][dones_idxes])[np.newaxis] for k in obs_keys}
            reset_data["terminated"] = np.zeros((1, reset_envs, 1))
            reset_data["truncated"] = np.zeros((1, reset_envs, 1))
            reset_data["actions"] = np.zeros((1, reset_envs, int(np.sum(actions_dim))))
            reset_data["rewards"] = np.zeros((1, reset_envs, 1))
            if is_first_column:
                reset_data["is_first"] = np.ones_like(reset_data["terminated"])
            rb.add(reset_data, dones_idxes, validate_args=cfg.buffer.validate_args)
            if device_cache is not None:
                device_cache.add(reset_data, dones_idxes)
            step_data["terminated"][:, dones_idxes] = 0.0
            step_data["truncated"][:, dones_idxes] = 0.0
            player.init_states(dones_idxes)
        elif reset_envs > 0:
            reset_data = {}
            for k in obs_keys:
                reset_data[k] = (real_next_obs[k][dones_idxes])[np.newaxis]
            reset_data["terminated"] = step_data["terminated"][:, dones_idxes]
            reset_data["truncated"] = step_data["truncated"][:, dones_idxes]
            reset_data["actions"] = np.zeros((1, reset_envs, int(np.sum(actions_dim))))
            reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            rb.add(reset_data, dones_idxes, validate_args=cfg.buffer.validate_args)
            if device_cache is not None:
                device_cache.add(reset_data, dones_idxes)

            step_data["rewards"][:, dones_idxes] = np.zeros_like(reset_data["rewards"])
            step_data["terminated"][:, dones_idxes] = np.zeros_like(step_data["terminated"][:, dones_idxes])
            step_data["truncated"][:, dones_idxes] = np.zeros_like(step_data["truncated"][:, dones_idxes])
            step_data["is_first"][:, dones_idxes] = np.ones_like(step_data["is_first"][:, dones_idxes])
            player.init_states(dones_idxes)

        # ------------------------------------------------------ train
        if iter_num >= learning_starts:
            ratio_steps = policy_step - prefill_steps * policy_steps_per_iter
            per_rank_gradient_steps = ratio(ratio_steps / world_size)
            if per_rank_gradient_steps > 0:
                if run.train_actor is not None:
                    player.agent.actor = run.train_actor
                train_t0 = time.perf_counter()
                with timer("Time/train_time", SumMetric, sync_on_compute=cfg.metric.sync_on_compute):
                    train_steps(train_state, rb, device_cache, cfg, per_rank_gradient_steps, runtime.generator)
                seconds["train_s"] += time.perf_counter() - train_t0
                train_step += world_size
                if aggregator and not aggregator.disabled and metric_fetch_gate():
                    for k, v in fetch_metrics(train_state.metrics).items():
                        aggregator.update(k, v)
                    if exploration_decay:
                        aggregator.update("Params/exploration_amount", player.get_expl_amount(policy_step))

        # ------------------------------------------------------ logging
        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters):
            timer_metrics = {}
            if logger:
                if aggregator and not aggregator.disabled:
                    logger.log_metrics(aggregator.compute(), policy_step)
                    aggregator.reset()
                logger.log_metrics(
                    {"Params/replay_ratio": train_state.gradient_steps * world_size / policy_step}, policy_step
                )
                if not timer.disabled:
                    timer_metrics = timer.compute()
                    if timer_metrics.get("Time/train_time", 0) > 0:
                        logger.log_metrics(
                            {"Time/sps_train": (train_step - last_train) / timer_metrics["Time/train_time"]}, policy_step
                        )
                    if timer_metrics.get("Time/env_interaction_time", 0) > 0:
                        logger.log_metrics(
                            {
                                "Time/sps_env_interaction": ((policy_step - last_log) / world_size * cfg.env.action_repeat)
                                / timer_metrics["Time/env_interaction_time"]
                            },
                            policy_step,
                        )
                    timer.reset()
            heartbeat_now = time.perf_counter()
            split = ""
            if logger and not timer.disabled:
                split = (
                    f", env_s={timer_metrics.get('Time/env_interaction_time', 0):.1f}"
                    f", train_s={timer_metrics.get('Time/train_time', 0):.1f}"
                )
            runtime.print(
                f"Rank-0: heartbeat policy_step={policy_step}, "
                f"sps={(policy_step - last_log) / max(heartbeat_now - heartbeat_t, 1e-9):.2f}, "
                f"gradient_steps={train_state.gradient_steps}" + split
            )
            heartbeat_t = heartbeat_now
            last_log = policy_step
            last_train = train_step

        # ------------------------------------------------------ checkpoint
        def _ckpt_state():
            ckpt_state = {
                **run.ckpt_state(),
                "ratio": ratio.state_dict(),
                "iter_num": iter_num * world_size,
                "batch_size": cfg.algo.per_rank_batch_size * world_size,
                "last_log": last_log,
                "last_checkpoint": ckpt_mgr.last_checkpoint,
            }
            if cfg.buffer.checkpoint:
                ckpt_state["rb"] = rb
            if device_cache is not None and device_cache.prioritized:
                ckpt_state["replay_priority"] = device_cache.priority_state()
            return ckpt_state

        path = ckpt_mgr.maybe_checkpoint(policy_step=policy_step, is_last=iter_num == total_iters, state_fn=_ckpt_state)
        last_path = path or last_path
        seconds["warmup_s" if iter_num < learning_starts else "training_s"] += time.perf_counter() - iter_t0

    ckpt_mgr.close()
    envs.close()
    actor_switched = run.train_actor is not None and player.agent.actor is run.train_actor
    test_rew = None
    if cfg.algo.run_test:
        if run.test_actor is not None:
            player.agent.actor = run.test_actor
        test_rew = test(player, runtime, cfg, log_dir, family.test_name, greedy=not v3)
        if logger:
            logger.log_metrics({"Test/cumulative_reward": test_rew}, policy_step)
    if logger:
        logger.finalize()
    return {"log_dir": log_dir, "checkpoint": last_path, "policy_step": policy_step, "test_reward": test_rew,
            "iterations": total_iters - start_iter + 1, "gradient_steps": train_state.gradient_steps,
            "learning_starts": learning_starts, "actor_switched": actor_switched, **seconds}

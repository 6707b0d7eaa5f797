"""DreamerV3 training steps (counterpart of the training half of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``).

:func:`make_train_fn` builds the gradient step of ``make_train_fn``
(``dreamer_v3.py:171-626``): the world-model loss over a dynamic scan of
the RSSM (with ``decoupled_rssm``: the posteriors from the observations
alone, then the recurrent states in one :func:`~sheeprl_tpu_torch.ops.seq_gru.gru_sequence`
where ``RSSM.seq_scan_eligible`` allows, else a loop of gated GRU steps),
one optimizer step of the world model; imagination from the
detached posteriors through the *updated* world model, the actor loss
against Moments-normalised lambda returns, one actor step; the critic loss
against the lambda returns and the target critic, one critic step.
Parameters and optimizer states are updated in place.

:func:`train_steps` is the training block of ``main`` (:913-949): for each
gradient step, the target critic's EMA (tau = 1 on the very first), then
the step, on batches from :func:`~sheeprl_tpu_torch.data.device_buffer.sequence_batches`.

:func:`main` is the env loop (``dreamer_v3.py:634-1049``) on the port's
stepping device vector env: random warm-up actions until
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

__all__ = ["TrainState", "draw_noise", "ema_", "main", "make_train_fn", "make_train_state", "train_steps"]


def draw_noise(
    cfg, seq_len: int, batch_size: int, actions_dim: Sequence[int], is_continuous: bool, *, device, generator=None
) -> Dict[str, torch.Tensor]:
    """Every draw of one train step: {"dyn", "img", "act"} (module docstring)."""
    wm_cfg = cfg.algo.world_model
    s, d = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    horizon, rows = int(cfg.algo.horizon), seq_len * batch_size
    like = torch.empty((), device=device)
    draw = normal_noise if is_continuous else gumbel_noise
    return {
        "dyn": gumbel_noise((seq_len, batch_size, s, d), like=like, generator=generator),
        "img": gumbel_noise((horizon, rows, s, d), like=like, generator=generator),
        "act": draw((horizon + 1, rows, int(np.sum(actions_dim))), like=like, generator=generator),
    }


def make_train_fn(runtime, agent: DreamerAgent, txs: Dict[str, Adam], cfg, is_continuous: bool, actions_dim):
    """The gradient step: ``train(opt_states, moments, data, noise=None,
    generator=None) -> (opt_states, moments, metrics)``, ``data`` a dict of
    (T, B, *) tensors on the agent's device, ``metrics`` the JAX step's
    dict of 0-d tensors (nothing is copied to the host)."""
    wm, actor, critic, target_critic = agent.world_model, agent.actor, agent.critic, agent.target_critic
    rssm = wm.rssm
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    cnn_keys_dec = tuple(cfg.algo.cnn_keys.decoder)
    mlp_keys_dec = tuple(cfg.algo.mlp_keys.decoder)
    wm_cfg = cfg.algo.world_model
    stochastic_size, discrete_size = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    stoch_state_size = stochastic_size * discrete_size
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon = int(cfg.algo.horizon)
    gamma, lmbda = float(cfg.algo.gamma), float(cfg.algo.lmbda)
    ent_coef = float(cfg.algo.actor.ent_coef)
    kl = dict(
        kl_dynamic=float(wm_cfg.kl_dynamic),
        kl_representation=float(wm_cfg.kl_representation),
        kl_free_nats=float(wm_cfg.kl_free_nats),
        kl_regularizer=float(wm_cfg.kl_regularizer),
        continue_scale_factor=float(wm_cfg.continue_scale_factor),
    )
    moments_cfg = cfg.algo.actor.moments
    decoupled = bool(wm_cfg.decoupled_rssm)
    compute_dtype = runtime.compute_dtype
    splits = [int(c) for c in np.cumsum(actions_dim)[:-1]]
    wm_params, actor_params, critic_params = _trainable(wm), _trainable(actor), _trainable(critic)

    def train(opt_states: Dict[str, AdamState], moments: Dict[str, torch.Tensor], data, noise=None, generator=None):
        T, B = data["rewards"].shape[:2]
        device = data["rewards"].device
        if noise is None:
            noise = draw_noise(cfg, T, B, actions_dim, is_continuous, device=device, generator=generator)
        batch_obs = {k: data[k].float() / 255.0 - 0.5 for k in cnn_keys}
        batch_obs.update({k: data[k].float() for k in mlp_keys})
        is_first = data["is_first"].float().clone()
        is_first[0] = 1.0
        # a_t in the buffer acted after o_t; the RSSM input at t is the previous action
        actions = data["actions"].float()
        batch_actions = torch.cat([torch.zeros_like(actions[:1]), actions[:-1]], 0)
        rewards = data["rewards"].float()
        terminated = data["terminated"].float()

        # ------------------------------------------------ world model
        enc_obs = {k: batch_obs[k].to(compute_dtype) for k in cnn_keys}
        enc_obs.update({k: batch_obs[k] for k in mlp_keys})
        embedded_obs = wm.encoder(enc_obs)  # (T, B, E)
        init_rec, init_post = rssm.get_initial_states((B,))
        init_states = (init_rec, init_post.reshape(B, -1))
        if decoupled:
            # the posteriors depend on the observations alone: all of them up
            # front, then the recurrent model on the previous posteriors, its
            # input projection batched over the sequence and only the GRU
            # sequential
            posteriors_logits, posteriors = rssm._representation(embedded_obs, None, noise=noise["dyn"])
            prev_posteriors = torch.cat([torch.zeros_like(posteriors[:1]), posteriors[:-1]], 0)
            feats = rssm.recurrent_features_seq(prev_posteriors, batch_actions, is_first, init_states[1])
            if rssm.seq_scan_eligible(int(feats.shape[-1])):
                recurrent_states = rssm.gru_sequence_gated(feats, is_first, init_states[0])
            else:
                recurrent_state = torch.zeros(B, recurrent_state_size, device=device)
                recs = []
                for t in range(T):
                    recurrent_state = rssm.gru_step_gated(feats[t], recurrent_state, is_first[t], init_states[0])
                    recs.append(recurrent_state)
                recurrent_states = torch.stack(recs)
        else:
            emb_proj = rssm.representation_embed_proj(embedded_obs)
            posterior = torch.zeros(B, stochastic_size, discrete_size, device=device)
            recurrent_state = torch.zeros(B, recurrent_state_size, device=device)
            recs, posts, post_logits = [], [], []
            for t in range(T):
                recurrent_state, posterior, logits = rssm.dynamic_posterior(
                    posterior, recurrent_state, batch_actions[t], emb_proj[t], is_first[t], init_states,
                    noise=noise["dyn"][t],
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
        po = {k: MSEDistribution(reconstructed[k], dims=reconstructed[k].dim() - 2) for k in cnn_keys_dec}
        po.update({k: SymlogDistribution(reconstructed[k], dims=reconstructed[k].dim() - 2) for k in mlp_keys_dec})
        pr = TwoHotEncodingDistribution(wm.reward_model(latent_states), dims=1)
        pc = Independent(BernoulliSafeMode(logits=wm.continue_model(latent_states)), 1)
        pl = priors_logits.reshape(T, B, stochastic_size, discrete_size)
        psl = posteriors_logits.reshape(T, B, stochastic_size, discrete_size)
        rec_loss, kl_value, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            po, batch_obs, pr, rewards, pl, psl, pc=pc, continue_targets=1 - terminated, **kl
        )
        wm_grads = _grads(rec_loss, wm_params)
        wm_norm = global_norm(wm_grads.values())
        txs["world_model"].update(wm_params, wm_grads, opt_states["world_model"], norm=wm_norm)
        del wm_grads

        # ------------------------------------------------ imagination, through the updated world model
        imagined_prior = posteriors.detach().transpose(0, 1).reshape(T * B, stoch_state_size)
        recurrent_state = recurrent_states.detach().transpose(0, 1).reshape(T * B, recurrent_state_size)
        true_continue = (1 - terminated).transpose(0, 1).reshape(1, T * B, 1)
        # with discrete actions nothing differentiable flows through the
        # rollout (the objective is logp * sg(advantage)): build no graph
        with torch.set_grad_enabled(is_continuous):
            latent0 = torch.cat([imagined_prior, recurrent_state], -1).to(compute_dtype)
            acts, _ = actor(latent0.detach(), False, noise=noise["act"][0])
            action = torch.cat(acts, -1)
            latents, imagined_actions = [latent0], [action]
            for i in range(horizon):
                imagined_prior, recurrent_state = rssm.imagination(
                    imagined_prior, recurrent_state, action, noise=noise["img"][i]
                )
                imagined_prior = imagined_prior.reshape(-1, stoch_state_size)
                latent = torch.cat([imagined_prior, recurrent_state], -1)
                acts, _ = actor(latent.detach(), False, noise=noise["act"][i + 1])
                action = torch.cat(acts, -1)
                latents.append(latent.to(compute_dtype))
                imagined_actions.append(action)
            imagined_trajectories = torch.stack(latents)  # (H + 1, T*B, L)
            imagined_actions = torch.stack(imagined_actions)
            predicted_values = TwoHotEncodingDistribution(critic(imagined_trajectories), dims=1).mean
            predicted_rewards = TwoHotEncodingDistribution(wm.reward_model(imagined_trajectories), dims=1).mean
            continues = Independent(BernoulliSafeMode(logits=wm.continue_model(imagined_trajectories)), 1).mode
            continues = torch.cat([true_continue, continues[1:]], 0)
            lambda_vals = compute_lambda_values(predicted_rewards[1:], predicted_values[1:], continues[1:] * gamma, lmbda)
            discount = (torch.cumprod(continues * gamma, 0) / gamma).detach()

        # ------------------------------------------------ actor
        _, policies = actor(imagined_trajectories.detach(), True)
        baseline = predicted_values[:-1]
        new_moments, offset, invscale = update_moments(
            moments, lambda_vals, float(moments_cfg.decay), float(moments_cfg.max),
            float(moments_cfg.percentile.low), float(moments_cfg.percentile.high),
        )
        advantage = (lambda_vals - offset) / invscale - (baseline - offset) / invscale
        if is_continuous:
            objective = advantage
        else:
            sub_actions = torch.tensor_split(imagined_actions, splits, -1)
            logps = torch.stack(
                [p.log_prob(a.detach())[:-1][..., None] for p, a in zip(policies, sub_actions)], -1
            ).sum(-1)
            objective = logps * advantage.detach()
        try:
            entropy = ent_coef * torch.stack([p.entropy() for p in policies], -1).sum(-1)
        except (AttributeError, NotImplementedError):  # a distribution without entropy
            entropy = torch.zeros(imagined_trajectories.shape[:2], device=device)
        policy_loss = -torch.mean(discount[:-1] * (objective + entropy[..., None][:-1]))
        actor_grads = _grads(policy_loss, actor_params)
        actor_norm = global_norm(actor_grads.values())
        txs["actor"].update(actor_params, actor_grads, opt_states["actor"], norm=actor_norm)
        del actor_grads

        # ------------------------------------------------ critic
        traj = imagined_trajectories.detach()[:-1]
        lambda_vals = lambda_vals.detach()
        qv = TwoHotEncodingDistribution(critic(traj), dims=1)
        with torch.no_grad():
            predicted_target_values = TwoHotEncodingDistribution(target_critic(traj), dims=1).mean
        value_loss = -qv.log_prob(lambda_vals) - qv.log_prob(predicted_target_values)
        value_loss = torch.mean(value_loss * discount[:-1].squeeze(-1))
        critic_grads = _grads(value_loss, critic_params)
        critic_norm = global_norm(critic_grads.values())
        txs["critic"].update(critic_params, critic_grads, opt_states["critic"], norm=critic_norm)

        with torch.no_grad():
            post_ent = Independent(OneHotCategorical(logits=psl.detach()), 1).entropy().mean()
            prior_ent = Independent(OneHotCategorical(logits=pl.detach()), 1).entropy().mean()
        metrics = {
            "Loss/world_model_loss": rec_loss.detach(),
            "Loss/observation_loss": observation_loss.detach(),
            "Loss/reward_loss": reward_loss.detach(),
            "Loss/state_loss": state_loss.detach(),
            "Loss/continue_loss": continue_loss.detach(),
            "State/kl": kl_value.detach(),
            "State/post_entropy": post_ent,
            "State/prior_entropy": prior_ent,
            "Loss/policy_loss": policy_loss.detach(),
            "Loss/value_loss": value_loss.detach(),
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
    one draw of sequence batches, each after the target critic's EMA.
    ``noises`` optionally gives each step's pre-drawn noise.  Returns each
    step's metrics."""
    critic_cfg = cfg.algo.critic
    device = next(state.agent.parameters()).device
    out = []
    with sequence_batches(
        rb, device_cache, device, per_rank_gradient_steps, int(cfg.algo.per_rank_batch_size),
        int(cfg.algo.per_rank_sequence_length), generator,
    ) as feed:
        for i, batch in enumerate(feed):
            if state.gradient_steps % int(critic_cfg.per_rank_target_network_update_freq) == 0:
                tau = 1.0 if state.gradient_steps == 0 else float(critic_cfg.tau)
                ema_(state.agent.target_critic, state.agent.critic, tau)
            state.opt_states, state.moments, state.metrics = state.train_fn(
                state.opt_states, state.moments, batch, noise=None if noises is None else noises[i], generator=generator
            )
            state.gradient_steps += 1
            out.append(state.metrics)
    return out


@register_algorithm()
def main(runtime, cfg):
    """The DreamerV3 env loop (module docstring).  Returns the run's summary:
    log dir, last checkpoint, policy and gradient steps, iterations, test
    reward, and the seconds spent in the warm-up iterations, in the
    iterations from ``learning_starts`` on and in their gradient steps."""
    import time

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3, build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import maybe_create_for
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.resilience.manager import CheckpointManager, restore_buffer
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
    from sheeprl_tpu_torch.utils.convert import (
        adam_state_from_tree,
        adam_state_to_tree,
        load_flax_params,
        moments_to_torch,
        torch_to_flax,
    )
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

    check_loop_scope(runtime, cfg, "DreamerV3", off_policy=True)
    world_size = runtime.world_size
    runtime.seed_everything(cfg.seed)
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    cfg.env.frame_stack = -1
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")

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

    agent = build_agent(runtime, actions_dim, is_continuous, cfg, observation_space)
    train_state = make_train_state(runtime, agent, cfg, is_continuous, actions_dim)
    groups = {"world_model": agent.world_model, "actor": agent.actor, "critic": agent.critic}
    if state is not None:
        load_flax_params(agent, {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")})
        train_state.opt_states = {g: adam_state_from_tree(state["opt_states"][g], m, g) for g, m in groups.items()}
        train_state.moments = moments_to_torch(state["moments"], runtime.device)
    wm_cfg = cfg.algo.world_model
    player = PlayerDV3(
        agent.player(),
        actions_dim,
        total_envs,
        wm_cfg.stochastic_size,
        wm_cfg.recurrent_model.recurrent_state_size,
        discrete_size=wm_cfg.discrete_size,
        decoupled_rssm=bool(wm_cfg.decoupled_rssm),
    )
    save_configs(cfg, log_dir)

    aggregator = None if MetricAggregator.disabled else instantiate(dict(cfg.metric.aggregator))

    buffer_size = cfg.buffer.size // total_envs if not cfg.dry_run else 2
    rb = EnvIndependentReplayBuffer(
        max(buffer_size, 2), n_envs=total_envs, memmap=cfg.buffer.memmap, buffer_cls=SequentialReplayBuffer
    )
    if state and cfg.buffer.checkpoint:
        rb = restore_buffer(state["rb"])
    device_cache = maybe_create_for(cfg, runtime, rb, state if state and cfg.buffer.checkpoint else None)

    train_step = 0
    last_train = 0
    start_iter = (state["iter_num"] // world_size) + 1 if state else 1
    policy_step = state["iter_num"] * cfg.env.num_envs if state else 0
    last_log = state["last_log"] if state else 0
    last_checkpoint = state["last_checkpoint"] if state else 0
    policy_steps_per_iter = int(total_envs)
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_iter if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state:
        cfg.algo.per_rank_batch_size = state["batch_size"] // world_size
        learning_starts += start_iter
        prefill_steps += start_iter

    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if state:
        ratio.load_state_dict(state["ratio"])

    ckpt_mgr = CheckpointManager(runtime, cfg, log_dir, last_checkpoint=last_checkpoint)

    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=cfg.seed)[0]
    for k in obs_keys:
        step_data[k] = obs[k][np.newaxis]
    step_data["rewards"] = np.zeros((1, total_envs, 1))
    step_data["truncated"] = np.zeros((1, total_envs, 1))
    step_data["terminated"] = np.zeros((1, total_envs, 1))
    step_data["is_first"] = np.ones_like(step_data["terminated"])
    player.init_states()

    metric_fetch_gate = MetricFetchGate(cfg.metric.get("fetch_every", 1))
    heartbeat_t = time.perf_counter()
    seconds = {"warmup_s": 0.0, "training_s": 0.0, "train_s": 0.0}
    last_path = None
    for iter_num in range(start_iter, total_iters + 1):
        iter_t0 = time.perf_counter()
        policy_step += policy_steps_per_iter

        with timer("Time/env_interaction_time", SumMetric, sync_on_compute=False):
            if iter_num <= learning_starts and cfg.checkpoint.resume_from is None:
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
                action_list = player.get_actions(prepared, False, runtime.generator, mask)
                actions, real_actions = fetch_actions(action_list, actions_dim, is_continuous, total_envs)

            step_data["actions"] = np.asarray(actions).reshape(1, total_envs, -1)
            rb.add(step_data, validate_args=cfg.buffer.validate_args)
            if device_cache is not None:
                device_cache.add(step_data)

            next_obs, rewards, terminated, truncated, infos = envs.step(
                np.asarray(real_actions).reshape(total_envs, *envs.single_action_space.shape)
            )
            dones = np.logical_or(terminated, truncated).astype(np.uint8)

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
            step_data[k] = next_obs[k][np.newaxis]
        obs = next_obs

        rewards = rewards.reshape((1, total_envs, -1))
        step_data["terminated"] = terminated.reshape((1, total_envs, -1)).astype(np.float32)
        step_data["truncated"] = truncated.reshape((1, total_envs, -1)).astype(np.float32)
        step_data["rewards"] = clip_rewards_fn(rewards)

        dones_idxes = dones.nonzero()[0].tolist()
        reset_envs = len(dones_idxes)
        if reset_envs > 0:
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
                train_t0 = time.perf_counter()
                with timer("Time/train_time", SumMetric, sync_on_compute=cfg.metric.sync_on_compute):
                    train_steps(train_state, rb, device_cache, cfg, per_rank_gradient_steps, runtime.generator)
                seconds["train_s"] += time.perf_counter() - train_t0
                train_step += world_size
                if aggregator and not aggregator.disabled and metric_fetch_gate():
                    for k, v in fetch_metrics(train_state.metrics).items():
                        aggregator.update(k, v)

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
            params = torch_to_flax(agent)
            ckpt_state = {
                "world_model": params["world_model"],
                "actor": params["actor"],
                "critic": params["critic"],
                "target_critic": params["target_critic"],
                "opt_states": {g: adam_state_to_tree(train_state.opt_states[g], m, g) for g, m in groups.items()},
                "moments": dict(train_state.moments),
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
    test_rew = None
    if cfg.algo.run_test:
        test_rew = test(player, runtime, cfg, log_dir, greedy=False)
        if logger:
            logger.log_metrics({"Test/cumulative_reward": test_rew}, policy_step)
    if logger:
        logger.finalize()
    return {"log_dir": log_dir, "checkpoint": last_path, "policy_step": policy_step, "test_reward": test_rew,
            "iterations": total_iters - start_iter + 1, "gradient_steps": train_state.gradient_steps,
            "learning_starts": learning_starts, **seconds}

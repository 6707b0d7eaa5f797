"""SAC gradient dispatches (counterpart of the training half of
``sheeprl_tpu/algos/sac/sac.py``).

:func:`make_train_fn` builds the train function of ``make_train_fn``
(``sac.py:65-232``, the single-device core): G gradient steps over a
(G, B, ...) batch, each one

1. the critic update against the target ``r + (1 - d) gamma (min_i Q'_i(s', a') - alpha log pi(a'|s'))``
   (with prioritized replay each sample's squared error is scaled by its IS
   weight, and the step's |delta| comes back for the priorities);
2. the target critic's EMA, under that step's flag;
3. the actor update against the *updated* critic;
4. the alpha update on the actor's log-probs, their gradient stopped;

with one Adam per component (``build_optimizer``).  ``Grads/agent`` is the
global norm of the three raw gradients; the losses are averaged over G.
Parameters and optimizer states are updated in place.

:func:`train_dispatch` is the training block of ``main`` (``sac.py:492-577``):
flush the rows the env loop held back into the device cache, draw G
batches (prioritized or uniform), cast them to f32, run the train function,
and feed the TD errors back into the priorities.

Randomness: a train function call draws its standard-normal noise
(G, 2, B, A) up front from a ``torch.Generator`` (``[:, 0]`` for the next
actions, ``[:, 1]`` for the actor loss), or takes it pre-drawn.

:func:`main` is the env loop (``sac.py:235-666``), :func:`run_off_policy`,
which DroQ shares through its own :class:`OffPolicyFamily`, on the port's
stepping device vector env: random warm-up actions until ``learning_starts``, then
the actor's; every step's row into a ``ReplayBuffer`` and, held back
``algo.dispatch_batch`` steps at a time, into its device cache; the
``Ratio``-granted gradient steps collected into dispatches of
:func:`train_dispatch` with their iterations' EMA flags; logging,
checkpoints (the replay buffer, the priorities and the pending iterations
included) and the closing greedy test episode.

Not ported yet, and raising with its ROADMAP item: the samples-per-insert
rate limiter (``buffer.rate_limiter``, A2), the training-health sentinel
(``guard_update``, A2), the multi-device loop (A5), ``buffer.memmap`` (A2)
and ``bf16-true`` (A2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import SACAgent, actor_action_and_log_prob, build_agent
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, critic_loss_weighted, entropy_loss, policy_loss, td_error_abs
from sheeprl_tpu_torch.optim import Adam, AdamState, build_optimizer, global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import ema_, grads_or_zeros, trainable_params

__all__ = ["OffPolicyFamily", "SACTrainState", "SAC_FAMILY", "main", "make_train_fn", "make_train_state",
           "run_off_policy", "train_dispatch"]

OBS_KEYS = ("observations",)


def make_train_fn(runtime, agent: SACAgent, txs: Dict[str, Adam], cfg, target_entropy: float, prioritized: bool = False):
    """``train(opt_states, data, do_ema, noise=None, generator=None)`` ->
    ``(opt_states, metrics)``, and ``td_abs`` (G, B) third when
    ``prioritized``.  ``data`` holds (G, B, ...) f32 tensors on the agent's
    device (``is_weights`` (G, B, 1) when ``prioritized``), ``do_ema`` G host
    booleans; ``metrics`` are 0-d tensors (nothing is copied to the host)."""
    gamma = float(cfg.algo.gamma)
    tau = float(cfg.algo.tau)
    num_critics = int(cfg.algo.critic.n)
    actor, critic, target_critic = agent.actor, agent.critic, agent.target_critic
    actor_params, critic_params = trainable_params(actor), trainable_params(critic)
    alpha_params = {"log_alpha": agent.log_alpha}

    def train(opt_states: Dict[str, AdamState], data: Dict[str, torch.Tensor], do_ema: Sequence[bool], noise=None, generator=None):
        g, b = data["rewards"].shape[:2]
        if len(do_ema) != g:
            raise ValueError(f"{len(do_ema)} EMA flags for {g} gradient steps")
        if noise is None:
            noise = torch.randn((g, 2, b, actor.action_dim), generator=generator, device=data["rewards"].device)
        losses, tds = [], []
        for step in range(g):
            batch = {k: v[step] for k, v in data.items()}
            alpha = agent.log_alpha.detach().exp()

            # critic update (Eq. 5)
            with torch.no_grad():
                next_actions, next_logp = actor_action_and_log_prob(actor, batch["next_observations"], noise[step, 0])
                qf_next = target_critic(batch["next_observations"], next_actions)
                min_qf_next = qf_next.min(-1, keepdim=True).values - alpha * next_logp
                next_qf_value = batch["rewards"] + (1 - batch["terminated"]) * gamma * min_qf_next
            qf_values = critic(batch["observations"], batch["actions"])
            if prioritized:
                qf_loss = critic_loss_weighted(qf_values, next_qf_value, num_critics, batch["is_weights"])
                tds.append(td_error_abs(qf_values.detach(), next_qf_value))
            else:
                qf_loss = critic_loss(qf_values, next_qf_value, num_critics)
            qf_grads = grads_or_zeros(qf_loss, critic_params)
            txs["critic"].update(critic_params, qf_grads, opt_states["critic"])

            # EMA target
            if do_ema[step]:
                ema_(target_critic, critic, tau)

            # actor update (Eq. 7), against the updated critic
            actions, logp = actor_action_and_log_prob(actor, batch["observations"], noise[step, 1])
            q = critic(batch["observations"], actions)
            actor_loss = policy_loss(alpha, logp, q.min(-1, keepdim=True).values)
            actor_grads = grads_or_zeros(actor_loss, actor_params)
            txs["actor"].update(actor_params, actor_grads, opt_states["actor"])

            # alpha update (Eq. 17)
            alpha_loss = entropy_loss(agent.log_alpha, logp, target_entropy)
            alpha_grads = grads_or_zeros(alpha_loss, alpha_params)
            txs["alpha"].update(alpha_params, alpha_grads, opt_states["alpha"])

            grad_norm = global_norm([*qf_grads.values(), *actor_grads.values(), *alpha_grads.values()])
            losses.append(torch.stack([qf_loss.detach(), actor_loss.detach(), alpha_loss.detach(), grad_norm]))
        mean = torch.stack(losses).mean(0)
        metrics = {
            "Loss/value_loss": mean[0],
            "Loss/policy_loss": mean[1],
            "Loss/alpha_loss": mean[2],
            "Grads/agent": mean[3],
        }
        if prioritized:
            return opt_states, metrics, torch.stack(tds)
        return opt_states, metrics

    return train


@dataclass
class SACTrainState:
    """What ``main`` carries between dispatches."""

    agent: SACAgent
    txs: Dict[str, Adam]
    opt_states: Dict[str, AdamState]
    train_fn: Callable
    prioritized: bool
    runtime: Any  # the mesh: its world size scales the batch; host-fed batches are split over it
    gradient_steps: int = 0  # cumulative_per_rank_gradient_steps


def make_train_state(runtime, agent: SACAgent, cfg, target_entropy: float, prioritized: bool = False,
                     train_fn_factory: Optional[Callable] = None) -> SACTrainState:
    """An Adam per component (``_make_optimizer``), their states and the
    train function of ``train_fn_factory`` (SAC's :func:`make_train_fn` by
    default; DroQ passes its own)."""
    txs = {name: build_optimizer(cfg.algo[name].optimizer, None, runtime.precision) for name in ("actor", "critic", "alpha")}
    opt_states = {
        "actor": txs["actor"].init(trainable_params(agent.actor)),
        "critic": txs["critic"].init(trainable_params(agent.critic)),
        "alpha": txs["alpha"].init({"log_alpha": agent.log_alpha}),
    }
    train_fn = (train_fn_factory or make_train_fn)(runtime, agent, txs, cfg, target_entropy, prioritized)
    return SACTrainState(agent, txs, opt_states, train_fn, bool(prioritized), runtime)


def train_dispatch(
    state: SACTrainState,
    rb,
    device_cache,
    cfg,
    ema_flags: Sequence[bool],
    policy_step: int,
    beta_fn: Callable[[int], float],
    pending_rows: Optional[List[Dict[str, np.ndarray]]] = None,
    generator: Optional[torch.Generator] = None,
    *,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One dispatch of ``len(ema_flags)`` gradient steps (``sac.py:492-577``).

    ``pending_rows`` are the env steps' rows not yet in the cache (emptied
    here by one windowed add).  The batch comes from the cache when it can
    sample (``sample_transitions_per`` with ``beta_fn(policy_step)`` when
    prioritized, else ``sample_transitions``), else from ``rb`` on the host
    (unit IS weights when prioritized).  ``draws`` optionally gives the
    draw's uniforms (``r01``, or ``envs`` and ``u``), ``noise`` the train
    function's.  Returns the dispatch's metrics.

    On a mesh of several shards the cache is the env-sharded one: its draw
    comes back whole (prioritized) or in shard order (uniform), the train
    function runs once on the whole batch, which is the arithmetic of JAX's
    data-parallel step up to the order of its reductions, and the TD errors
    go to the shards' sub-trees.  A gradient step takes
    ``per_rank_batch_size`` rows for each shard, as JAX's ``main`` scales the
    batch by the world size (``sac.py:479``); its env loop, which also runs
    ``env.num_envs`` envs per shard, is not ported."""
    g = len(ema_flags)
    batch_unit = int(cfg.algo.per_rank_batch_size) * state.runtime.world_size
    sample_next_obs = bool(cfg.buffer.sample_next_obs)
    device = state.agent.log_alpha.device
    draws = draws or {}
    if device_cache is not None and pending_rows:
        device_cache.add({k: np.concatenate([r[k] for r in pending_rows], axis=0) for k in pending_rows[0]})
        pending_rows.clear()
    sample_idx = None
    if device_cache is not None and device_cache.can_sample_transitions(sample_next_obs):
        if state.prioritized:
            sampled, sample_idx = device_cache.sample_transitions_per(
                g, batch_unit, generator, beta_fn(policy_step), sample_next_obs=sample_next_obs, obs_keys=OBS_KEYS,
                r01=draws.get("r01"),
            )
        else:
            sampled = device_cache.sample_transitions(
                g, batch_unit, generator, sample_next_obs=sample_next_obs, obs_keys=OBS_KEYS,
                envs=draws.get("envs"), u=draws.get("u"),
            )
        data = {k: v.float() for k, v in sampled.items()}
    else:
        sample = rb.sample(batch_size=g * batch_unit, sample_next_obs=sample_next_obs)
        data = {
            k: torch.from_numpy(np.asarray(v, dtype=np.float32).reshape(g, batch_unit, *v.shape[2:])).to(device)
            for k, v in sample.items()
        }
        if state.prioritized:
            data["is_weights"] = torch.ones((g, batch_unit, 1), device=device)
        data = state.runtime.shard_batch(data, axis=1)
    out = state.train_fn(state.opt_states, data, [bool(f) for f in ema_flags], noise=noise, generator=generator)
    state.opt_states, metrics = out[0], out[1]
    if sample_idx is not None:
        device_cache.update_priorities(sample_idx, out[2])
    state.gradient_steps += g
    return metrics


@dataclass(frozen=True)
class OffPolicyFamily:
    """What :func:`run_off_policy` builds for one family of agents: its name
    in messages, the agent (``build_agent(runtime, cfg, obs_space,
    action_space)`` -> (agent, target entropy)), its train state
    (``make_train_state(runtime, agent, cfg, target_entropy, prioritized)``)
    and its dispatch (``dispatch(state, rb, device_cache, cfg, ema_flags,
    policy_step, beta_fn, pending_rows, generator)`` -> metrics);
    ``batched``: whether ``algo.dispatch_batch`` applies (else every
    iteration's gradient steps are one dispatch); ``benchmark_pin``: whether
    ``run_benchmarks`` pins one gradient step an iteration (SAC's rule,
    ``sac.py:471``; DroQ's ratio holds under it)."""

    name: str
    build_agent: Callable
    make_train_state: Callable
    dispatch: Callable
    batched: bool = True
    benchmark_pin: bool = False


# the dispatch is looked up at each call, so that a caller may wrap the module's train_dispatch
SAC_FAMILY = OffPolicyFamily("SAC", build_agent, make_train_state, lambda *a, **k: train_dispatch(*a, **k),
                             benchmark_pin=True)


@register_algorithm()
def main(runtime, cfg):
    """The SAC env loop (module docstring): :func:`run_off_policy`."""
    return run_off_policy(runtime, cfg, SAC_FAMILY)


def run_off_policy(runtime, cfg, family: OffPolicyFamily = SAC_FAMILY):
    """The off-policy env loop that SAC and DroQ share (module docstring).
    Returns the run's summary: log dir, last checkpoint, policy and gradient
    steps, iterations, dispatches, test reward, and the seconds spent in the
    warm-up iterations, in the iterations from ``learning_starts`` on and in
    their dispatches."""
    import time
    import warnings

    from sheeprl_tpu_torch.algos.sac.agent import SACPlayer
    from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import maybe_create_for_transitions
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.replay.priority_tree import per_beta_schedule
    from sheeprl_tpu_torch.resilience.manager import CheckpointManager, restore_buffer
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
    from sheeprl_tpu_torch.utils.convert import adam_state_from_tree, adam_state_to_tree, load_flax_params, torch_to_flax
    from sheeprl_tpu_torch.utils.env import make_train_envs
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import MetricFetchGate, Ratio, check_loop_scope, fetch_metrics, save_configs

    if "minedojo" in str(cfg.env.wrapper.get("_target_", "")).lower():
        raise ValueError(f"MineDojo is not supported by the {family.name} agent")
    check_loop_scope(runtime, cfg, family.name, off_policy=True)
    if (cfg.buffer.get("rate_limiter") or {}).get("samples_per_insert") is not None:
        raise NotImplementedError("buffer.rate_limiter.samples_per_insert (replay/rate_limiter.py) waits for ROADMAP A2")

    world_size = runtime.world_size
    runtime.seed_everything(cfg.seed)
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    if len(cfg.algo.cnn_keys.encoder) > 0:
        warnings.warn(f"{family.name} cannot use image observations, the CNN keys will be ignored")
        cfg.algo.cnn_keys.encoder = []

    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    runtime.print(f"Log dir: {log_dir}")
    if logger:
        logger.log_hyperparams(cfg)

    total_envs = cfg.env.num_envs * world_size
    envs = make_train_envs(cfg, runtime)
    action_space = envs.single_action_space
    observation_space = envs.single_observation_space
    if not isinstance(action_space, spaces.Box):
        raise ValueError(f"Only continuous action space is supported for the {family.name} agent")
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    if len(cfg.algo.mlp_keys.encoder) == 0:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    for k in cfg.algo.mlp_keys.encoder:
        if len(observation_space[k].shape) > 1:
            raise ValueError(
                f"Only vector observations are supported by {family.name}; key '{k}' has shape {observation_space[k].shape}"
            )
    mlp_keys = list(cfg.algo.mlp_keys.encoder)

    agent, target_entropy = family.build_agent(runtime, cfg, observation_space, action_space)
    if state is not None:
        load_flax_params(agent, state["agent"])
    player = SACPlayer(agent.actor, lambda o: prepare_obs(o, mlp_keys=mlp_keys, num_envs=total_envs))
    save_configs(cfg, log_dir)

    aggregator = None if MetricAggregator.disabled else instantiate(dict(cfg.metric.aggregator))

    buffer_size = cfg.buffer.size // int(total_envs) if not cfg.dry_run else 1
    rb = ReplayBuffer(max(buffer_size, 1), total_envs, memmap=cfg.buffer.memmap, obs_keys=OBS_KEYS)
    if state and cfg.buffer.checkpoint:
        rb = restore_buffer(state["rb"])
    device_cache = maybe_create_for_transitions(cfg, runtime, rb, state if state and cfg.buffer.checkpoint else None)
    prioritized = device_cache is not None and device_cache.prioritized
    beta_fn = per_beta_schedule(
        cfg.buffer.get("per_beta", 0.4), cfg.buffer.get("per_beta_end", 1.0), int(cfg.algo.total_steps)
    )
    train_state = family.make_train_state(runtime, agent, cfg, target_entropy, prioritized)
    if state is not None:
        modules = {"actor": agent.actor, "critic": agent.critic, "alpha": agent}
        train_state.opt_states = {g: adam_state_from_tree(state["opt_states"][g], m, g) for g, m in modules.items()}

    last_train = 0
    train_step = 0
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
    ema_every = cfg.algo.critic.target_network_frequency // policy_steps_per_iter + 1

    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=cfg.seed)[0]

    # the cache's rows land as one window every dispatch_batch steps, and
    # before every draw (train_dispatch flushes what is left)
    dispatch_batch = max(1, int(cfg.algo.get("dispatch_batch", 1))) if family.batched else 1
    pending_iters = list(state.get("pending_iters", [])) if state else []
    pending_rows: List[Dict[str, np.ndarray]] = []

    metric_fetch_gate = MetricFetchGate(cfg.metric.get("fetch_every", 1))
    seconds = {"warmup_s": 0.0, "training_s": 0.0, "train_s": 0.0}
    dispatches = 0
    last_path = None
    for iter_num in range(start_iter, total_iters + 1):
        iter_t0 = time.perf_counter()
        policy_step += policy_steps_per_iter

        with timer("Time/env_interaction_time", SumMetric, sync_on_compute=False):
            if iter_num <= learning_starts:
                actions = envs.sample_actions().cpu().numpy()
            else:
                actions = player.get_actions(obs, runtime.generator).cpu().numpy()
            next_obs, rewards, terminated, truncated, infos = envs.step(
                actions.reshape(total_envs, *action_space.shape)
            )
            rewards = rewards.reshape(total_envs, -1)

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
        flat_next_obs = np.concatenate([real_next_obs[k] for k in mlp_keys], axis=-1).astype(np.float32)

        step_data["terminated"] = terminated.reshape(1, total_envs, -1).astype(np.uint8)
        step_data["truncated"] = truncated.reshape(1, total_envs, -1).astype(np.uint8)
        step_data["actions"] = actions.reshape(1, total_envs, -1).astype(np.float32)
        step_data["observations"] = np.concatenate([obs[k] for k in mlp_keys], axis=-1).astype(np.float32)[np.newaxis]
        if not cfg.buffer.sample_next_obs:
            step_data["next_observations"] = flat_next_obs[np.newaxis]
        step_data["rewards"] = rewards[np.newaxis].astype(np.float32)
        rb.add(step_data, validate_args=cfg.buffer.validate_args)
        if device_cache is not None:
            if dispatch_batch > 1:
                pending_rows.append(dict(step_data))
                if len(pending_rows) >= dispatch_batch:
                    device_cache.add({k: np.concatenate([r[k] for r in pending_rows], axis=0) for k in pending_rows[0]})
                    pending_rows.clear()
            else:
                device_cache.add(step_data)
        obs = next_obs

        if iter_num >= learning_starts:
            per_rank_gradient_steps = (
                ratio((policy_step - prefill_steps + policy_steps_per_iter) / world_size)
                if not (family.benchmark_pin and cfg.get("run_benchmarks", False))
                else 1
            )
            if per_rank_gradient_steps > 0:
                pending_iters.extend([iter_num] * per_rank_gradient_steps)
            if pending_iters and (len(pending_iters) >= dispatch_batch or iter_num == total_iters):
                g = len(pending_iters)
                ema_flags = [it % ema_every == 0 for it in pending_iters[:g]]
                iters_in_window = len(set(pending_iters[:g]))
                pending_iters = pending_iters[g:]
                train_t0 = time.perf_counter()
                with timer("Time/train_time", SumMetric, sync_on_compute=cfg.metric.sync_on_compute):
                    metrics = family.dispatch(
                        train_state, rb, device_cache, cfg, ema_flags, policy_step, beta_fn, pending_rows,
                        runtime.generator,
                    )
                seconds["train_s"] += time.perf_counter() - train_t0
                dispatches += 1
                train_step += world_size * iters_in_window
                if aggregator and not aggregator.disabled and metric_fetch_gate():
                    for k, v in fetch_metrics(metrics).items():
                        aggregator.update(k, v)

        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters):
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
            last_log = policy_step
            last_train = train_step

        def _ckpt_state():
            modules = {"actor": agent.actor, "critic": agent.critic, "alpha": agent}
            ckpt_state = {
                "agent": torch_to_flax(agent),
                "opt_states": {g: adam_state_to_tree(train_state.opt_states[g], m, g) for g, m in modules.items()},
                "ratio": ratio.state_dict(),
                "pending_iters": list(pending_iters),
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
        test_rew = test(player, runtime, cfg, log_dir)
        if logger:
            logger.log_metrics({"Test/cumulative_reward": test_rew}, policy_step)
    if logger:
        logger.finalize()
    return {"log_dir": log_dir, "checkpoint": last_path, "policy_step": policy_step, "test_reward": test_rew,
            "iterations": total_iters - start_iter + 1, "gradient_steps": train_state.gradient_steps,
            "dispatches": dispatches, "learning_starts": learning_starts, **seconds}

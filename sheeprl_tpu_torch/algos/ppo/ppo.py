"""PPO (coupled) on the device-env backend (counterpart of
``sheeprl_tpu/algos/ppo/ppo.py``).

- ``make_update_fn``: GAE (or V-trace) on the rollout, then
  ``update_epochs`` epochs of ``ceil(T N / batch)`` minibatches over a fresh
  permutation each epoch (wrapped when the last minibatch would run short),
  one optimizer step a minibatch.  The JAX package compiles all of it into
  one program; here it runs as eager torch operations on the agent's
  device, the parameters updated in place.  The permutations come from the
  generator, or the caller supplies them (the tests feed JAX's).
- ``main``: one shard on the runtime's device, the fused collect
  (``envs/device/collect.py``), checkpoints through the
  :class:`~sheeprl_tpu_torch.resilience.manager.CheckpointManager` and a
  greedy test episode at the end.  A port checkpoint also holds the envs'
  state and the run's generator, so a resumed run continues exactly where
  it stopped (the JAX package resets its envs and key stream on resume),
  and the annealed coefficients resume from the checkpoint's iteration.

Raise, each naming its ROADMAP item: ``fabric.devices > 1`` (the DDP core
over shards, A5), ``algo.env_backend=host`` (A2), ``algo.sentinel.enabled``
(A2), the observability knobs (A7), ``buffer.memmap`` and
``buffer.checkpoint_on_policy`` (A2: the loop keeps the rollout on the
device and no host buffer).
"""

from __future__ import annotations

import sys
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOPlayer, build_agent, evaluate_actions, get_values
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs, prepare_obs, test
from sheeprl_tpu_torch.algos.ppo.vtrace import vtrace
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.collect import FusedOnPolicyCollector
from sheeprl_tpu_torch.optim import build_optimizer, global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import check_loop_scope, fetch_metrics, gae, normalize_tensor, trainable_params

__all__ = ["OnPolicyFamily", "PPO_FAMILY", "annealed_coefs", "build_ppo_optimizer", "check_port_scope", "main", "make_update_fn",
           "run_on_policy"]

def check_port_scope(runtime, cfg: Dict[str, Any], algo: str) -> None:
    """Raise for what the on-policy loops of the port do not run yet.  The
    collect/train overlap is off, with a notice where the config turns it
    on, as the JAX package does for ``env_backend=jax`` (``ppo.py:533``):
    the port has no collector thread (ROADMAP A2 brings one for host envs)."""
    check_loop_scope(runtime, cfg, algo)
    overlap = cfg.algo.get("overlap_collect", False)
    if overlap is True or str(overlap).strip().lower() == "auto":
        print(
            "overlap_collect resolved to off: env_backend=jax runs the fused device collect; "
            "no host env stepping left to overlap.",
            file=sys.stderr,
        )
    if cfg.buffer.get("memmap", False) or cfg.buffer.get("checkpoint_on_policy", False):
        raise NotImplementedError(
            "buffer.memmap and buffer.checkpoint_on_policy need a host rollout buffer, which waits for ROADMAP A2; "
            "the port's on-policy loops keep the rollout on the device"
        )


def build_ppo_optimizer(optim_cfg: Dict[str, Any], max_grad_norm: float, precision: str = "32-true"):
    """The optimizer of ``optim_cfg`` behind the global-norm clip; its
    ``learning_rate`` is set before every update (annealing)."""
    return build_optimizer(dict(optim_cfg), max_grad_norm, precision)


def epoch_permutations(n_total: int, n_used: int, epochs: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(epochs, n_used) row orders: a permutation of ``n_total`` rows an
    epoch, tiled when ``n_used`` exceeds it (as the JAX package pads)."""
    perms = torch.stack([torch.randperm(n_total, generator=generator, device=device) for _ in range(epochs)])
    if n_used > n_total:
        perms = perms.repeat(1, -(-n_used // n_total))[:, :n_used]
    return perms


def make_update_fn(runtime, agent, tx, cfg: Dict[str, Any], obs_keys: Sequence[str]):
    """``update(opt_state, data, next_obs, *, clip_coef, ent_coef, lr,
    generator=None, perms=None) -> metrics``: one PPO update of ``agent``
    (in place) on a (T, N, ...) rollout.  ``perms`` are the epochs' row
    orders (``epoch_permutations``' layout); drawn from ``generator`` (the
    runtime's by default) when not supplied."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = list(obs_keys)
    update_epochs = int(cfg.algo.update_epochs)
    mb_size = int(cfg.algo.per_rank_batch_size) * runtime.world_size
    gamma = float(cfg.algo.gamma)
    gae_lambda = float(cfg.algo.gae_lambda)
    vf_coef = float(cfg.algo.vf_coef)
    clip_vloss = bool(cfg.algo.clip_vloss)
    reduction = str(cfg.algo.loss_reduction)
    normalize_adv = bool(cfg.algo.normalize_advantages)
    vt_cfg = cfg.algo.get("vtrace", None) or {}
    use_vtrace = bool(vt_cfg.get("enabled", False))
    vt_rho_clip = float(vt_cfg.get("rho_clip", 1.0))
    vt_c_clip = float(vt_cfg.get("c_clip", 1.0))
    params = trainable_params(agent)

    def norm(obs):
        return normalize_obs({k: obs[k].to(torch.float32) for k in obs_keys}, cnn_keys, obs_keys)

    @torch.no_grad()
    def targets_and_flatten(data, next_obs):
        next_values = get_values(agent, norm(next_obs))
        if use_vtrace:
            t_len, n_env = data["rewards"].shape[:2]
            flat_obs = norm({k: data[k].reshape(t_len * n_env, *data[k].shape[2:]) for k in obs_keys})
            flat_actions = data["actions"].reshape(t_len * n_env, *data["actions"].shape[2:])
            tgt_logprobs, _, _ = evaluate_actions(agent, flat_obs, flat_actions)
            log_rhos = tgt_logprobs.reshape(data["logprobs"].shape).float() - data["logprobs"].float()
            returns, advantages = vtrace(
                data["rewards"], data["values"], data["dones"], next_values, log_rhos, gamma, gae_lambda,
                vt_rho_clip, vt_c_clip,
            )
        else:
            returns, advantages = gae(data["rewards"], data["values"], data["dones"], next_values, gamma, gae_lambda)
        data = {**data, "returns": returns, "advantages": advantages}
        n_total = data["rewards"].shape[0] * data["rewards"].shape[1]
        return {k: v.reshape(n_total, *v.shape[2:]) for k, v in data.items()}, n_total

    def loss_fn(mb, clip_coef, ent_coef):
        new_logprobs, entropy, new_values = evaluate_actions(agent, norm(mb), mb["actions"])
        adv = normalize_tensor(mb["advantages"]) if normalize_adv else mb["advantages"]
        pg = policy_loss(new_logprobs, mb["logprobs"], adv, clip_coef, reduction)
        vl = value_loss(new_values, mb["values"], mb["returns"], clip_coef, clip_vloss, reduction)
        ent = entropy_loss(entropy, reduction)
        return pg + vf_coef * vl + ent_coef * ent, (pg, vl, ent)

    def update(opt_state, data, next_obs, *, clip_coef: float, ent_coef: float, lr: float,
               generator: Optional[torch.Generator] = None, perms=None):
        tx.learning_rate = float(lr)
        flat, n_total = targets_and_flatten(data, next_obs)
        num_minibatches = max(1, -(-n_total // mb_size))
        if perms is None:
            gen = runtime.generator if generator is None else generator
            perms = epoch_permutations(n_total, num_minibatches * mb_size, update_epochs, gen, runtime.device)
        epoch_losses = []
        for epoch in range(update_epochs):
            shuffled = {k: v[perms[epoch]] for k, v in flat.items()}
            mb_losses = []
            for i in range(num_minibatches):
                mb = {k: v[i * mb_size : (i + 1) * mb_size] for k, v in shuffled.items()}
                total, (pg, vl, ent) = loss_fn(mb, clip_coef, ent_coef)
                grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
                grad_norm = global_norm(grads.values())
                tx.update(params, grads, opt_state, grad_norm)
                mb_losses.append(torch.stack([pg.detach(), vl.detach(), ent.detach(), grad_norm]))
            epoch_losses.append(torch.stack(mb_losses).mean(0))
        mean = torch.stack(epoch_losses).mean(0)
        return {
            "Loss/policy_loss": mean[0],
            "Loss/value_loss": mean[1],
            "Loss/entropy_loss": mean[2],
            "Grads/agent": mean[3],
        }

    return update


@dataclass(frozen=True)
class OnPolicyFamily:
    """What :func:`run_on_policy` builds for one family of agents: the
    agent, its collector, its player and closing test, what its update
    bootstraps from (``bootstrap(payload)``), and the checkpoint key of its
    global batch setting with the per-rank ``algo`` key that key restores."""

    build_agent: Callable
    collector: Callable
    make_player: Callable
    test: Callable
    bootstrap: Callable
    batch_key: str
    batch_cfg: str


PPO_FAMILY = OnPolicyFamily(
    build_agent=build_agent,
    collector=FusedOnPolicyCollector,
    make_player=lambda agent, runtime, cnn_keys: PPOPlayer(
        agent, lambda obs: prepare_obs(obs, cnn_keys=cnn_keys, num_envs=1, device=runtime.device)
    ),
    test=test,
    bootstrap=lambda payload: payload.next_obs,
    batch_key="batch_size",
    batch_cfg="per_rank_batch_size",
)


def run_on_policy(runtime, cfg: Dict[str, Any], algo: str, make_update, train_kwargs,
                  family: OnPolicyFamily = PPO_FAMILY) -> Dict[str, Any]:
    """The coupled on-policy loop that PPO, A2C and recurrent PPO share on
    the device backend; ``make_update(runtime, agent, tx, cfg, obs_keys)``
    builds the update, ``train_kwargs(iteration)`` gives its coefficients
    and ``family`` the rest; the update takes the rollout and
    ``family.bootstrap(payload)``.  Returns the run's summary (log dir, last
    checkpoint, policy steps, test reward)."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.resilience.manager import CheckpointManager
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
    from sheeprl_tpu_torch.utils.convert import opt_state_from_tree, opt_state_to_tree, torch_to_flax
    from sheeprl_tpu_torch.utils.env import make_train_envs
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import MetricFetchGate, save_configs

    check_port_scope(runtime, cfg, algo)
    world_size = runtime.world_size
    runtime.seed_everything(cfg.seed)
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    runtime.print(f"Log dir: {log_dir}")
    if logger:
        logger.log_hyperparams(cfg)

    total_envs = cfg.env.num_envs * world_size
    envs = make_train_envs(cfg, runtime)
    observation_space = envs.single_observation_space
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    if not obs_keys:
        raise RuntimeError("Specify at least one of `cnn_keys.encoder` or `mlp_keys.encoder`")
    if cfg.metric.log_level > 0:
        runtime.print("Encoder CNN keys:", cnn_keys)
        runtime.print("Encoder MLP keys:", mlp_keys)
    actions_dim, is_continuous = spaces.action_space_dims(envs.single_action_space)

    agent = family.build_agent(runtime, actions_dim, is_continuous, cfg, observation_space,
                               state["agent"] if state else None)
    tx = build_ppo_optimizer(cfg.algo.optimizer, cfg.algo.max_grad_norm, runtime.precision)
    opt_state = tx.init(trainable_params(agent)) if state is None else opt_state_from_tree(state["optimizer"], agent, tx)
    player = family.make_player(agent, runtime, cnn_keys)
    save_configs(cfg, log_dir)

    aggregator = None if MetricAggregator.disabled else instantiate(dict(cfg.metric.aggregator))
    if cfg.buffer.size < cfg.algo.rollout_steps:
        raise ValueError(
            f"The size of the buffer ({cfg.buffer.size}) cannot be lower than the rollout steps ({cfg.algo.rollout_steps})"
        )

    last_train = 0
    train_step = 0
    start_iter = (state["iter_num"] // world_size) + 1 if state else 1
    policy_step = state["iter_num"] * cfg.env.num_envs * cfg.algo.rollout_steps if state else 0
    last_log = state["last_log"] if state else 0
    last_checkpoint = state["last_checkpoint"] if state else 0
    policy_steps_per_iter = int(cfg.env.num_envs * cfg.algo.rollout_steps * world_size)
    total_iters = cfg.algo.total_steps // policy_steps_per_iter if not cfg.dry_run else 1
    if state:
        cfg.algo[family.batch_cfg] = state[family.batch_key] // world_size
    if cfg.metric.log_level > 0 and cfg.metric.log_every % policy_steps_per_iter != 0:
        warnings.warn(
            f"metric.log_every ({cfg.metric.log_every}) is not a multiple of "
            f"policy_steps_per_iter ({policy_steps_per_iter}); metrics log at the next multiple."
        )

    ckpt_mgr = CheckpointManager(runtime, cfg, log_dir, last_checkpoint=last_checkpoint)
    update_fn = make_update(runtime, agent, tx, cfg, obs_keys)
    collector = family.collector(
        envs=envs, agent=agent, cfg=cfg, runtime=runtime, obs_keys=obs_keys, total_envs=total_envs,
        aggregator=aggregator, policy_step=policy_step,
    )
    if state is not None:
        collector.load_state_dict(state)
    if state is not None and "rng" in state:
        runtime.generator.set_state(torch.from_numpy(state["rng"]))
    metric_fetch_gate = MetricFetchGate(cfg.metric.get("fetch_every", 1))
    last_path = None

    for iter_num in range(start_iter, total_iters + 1):
        payload = collector.collect(iter_num)
        policy_step = payload.policy_step_end
        coefs = train_kwargs(iter_num - 1, total_iters)
        with timer("Time/train_time", SumMetric, sync_on_compute=cfg.metric.sync_on_compute):
            train_metrics = update_fn(opt_state, payload.data, family.bootstrap(payload), **coefs)
        train_step += world_size

        if aggregator and not aggregator.disabled and metric_fetch_gate():
            for k, v in fetch_metrics(train_metrics).items():
                aggregator.update(k, v)

        if cfg.metric.log_level > 0 and logger:
            logger.log_metrics({"Info/learning_rate": coefs["lr"]}, policy_step)
            if "clip_coef" in coefs:
                logger.log_metrics({"Info/clip_coef": coefs["clip_coef"], "Info/ent_coef": coefs["ent_coef"]}, policy_step)
            if policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters:
                if aggregator and not aggregator.disabled:
                    logger.log_metrics(aggregator.compute(), policy_step)
                    aggregator.reset()
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

        path = ckpt_mgr.maybe_checkpoint(
            policy_step=policy_step,
            is_last=iter_num == total_iters,
            state_fn=lambda: {
                "agent": torch_to_flax(agent),
                "optimizer": opt_state_to_tree(opt_state, agent),
                "iter_num": iter_num * world_size,
                family.batch_key: cfg.algo[family.batch_cfg] * world_size,
                "last_log": last_log,
                "last_checkpoint": ckpt_mgr.last_checkpoint,
                **collector.state_dict(),
                "rng": runtime.generator.get_state(),
            },
        )
        last_path = path or last_path

    ckpt_mgr.close()
    test_rew = None
    if cfg.algo.run_test:
        test_rew = family.test(player, runtime, cfg, log_dir)
        if logger:
            logger.log_metrics({"Test/cumulative_reward": test_rew}, policy_step)
    if logger:
        logger.finalize()
    return {"log_dir": log_dir, "checkpoint": last_path, "policy_step": policy_step, "test_reward": test_rew,
            "iterations": total_iters - start_iter + 1}


def annealed(initial: float, anneal: bool, iteration: int, total_iters: int) -> float:
    """A coefficient after ``iteration`` iterations: ``initial``, or its
    linear decay to 0 over ``total_iters`` when annealed."""
    from sheeprl_tpu_torch.utils.utils import polynomial_decay

    if not anneal or iteration == 0:
        return float(initial)
    return polynomial_decay(iteration, initial=float(initial), final=0.0, max_decay_steps=total_iters, power=1.0)


def annealed_coefs(cfg: Dict[str, Any]) -> Callable[[int, int], Dict[str, float]]:
    """``coefs(done_iters, total_iters)``: the learning rate, clip and
    entropy coefficients of PPO and recurrent PPO for an iteration, each
    annealed as its ``algo.anneal_*`` flag says."""
    lr0 = float(cfg.algo.optimizer.get("learning_rate", cfg.algo.optimizer.get("lr", 1e-3)))
    clip0, ent0 = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)

    def coefs(done_iters: int, total_iters: int) -> Dict[str, float]:
        return {
            "lr": annealed(lr0, cfg.algo.anneal_lr, done_iters, total_iters),
            "clip_coef": annealed(clip0, cfg.algo.anneal_clip_coef, done_iters, total_iters),
            "ent_coef": annealed(ent0, cfg.algo.anneal_ent_coef, done_iters, total_iters),
        }

    return coefs


@register_algorithm()
def main(runtime, cfg: Dict[str, Any]):
    return run_on_policy(runtime, cfg, "PPO", make_update_fn, annealed_coefs(cfg))

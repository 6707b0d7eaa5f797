"""Env construction from the config (counterpart of the device branch of
``sheeprl_tpu/utils/env.py``).

The port has one env backend, ``algo.env_backend=jax``: the torch-tensor
envs of ``sheeprl_tpu_torch/envs/device/`` on the runtime's device.  The
gymnasium ``host`` backend waits for ROADMAP A2 and raises.

Of ``make_env``'s chain (``sheeprl_tpu/utils/env.py:40-233``) a device env
keeps what the loops read: its observations are already a ``{key: obs}``
dict, which must hold the encoder's keys; ``env.max_episode_steps`` is the
time limit; the vector env records the episode statistics and, where the
JAX package steps ``make_env``'s chain, repeats each action
``env.action_repeat`` times (:func:`make_vector_env`).  The wrappers that
are not ported raise, each naming its ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["make_device_env_from_cfg", "make_train_envs", "make_vector_env", "resolve_env_backend", "run_test_episode"]

_ENV_BACKENDS = ("host", "jax")


def _unported_wrappers(cfg: Dict[str, Any]) -> list:
    """The ``env`` knobs asking for a host wrapper that the device envs do not have."""
    found = []
    if cfg.env.get("capture_video", False):
        found.append("env.capture_video (RecordVideo)")
    if int((cfg.env.get("actions_as_observation") or {}).get("num_stack", -1)) > 0:
        found.append("env.actions_as_observation (ActionsAsObservationWrapper)")
    if cfg.env.get("reward_as_observation", False):
        found.append("env.reward_as_observation (RewardAsObservationWrapper)")
    if cfg.env.get("mask_velocities", False):
        found.append("env.mask_velocities (MaskVelocityWrapper)")
    if list(cfg.algo.cnn_keys.encoder):
        found.append("algo.cnn_keys.encoder on a vector-observation env (AddRenderObservation)")
    return found


def resolve_env_backend(cfg: Dict[str, Any]) -> str:
    """``algo.env_backend``, validated: ``jax`` needs a registered device env
    family behind ``env.id``, ``env.restart_on_crash`` off (there is no host
    ``env.step`` for the restart guard to guard), ``env.sync_env`` on (there
    are no env processes), the ``env_step_raise`` fault site unarmed (it
    would never fire) and no host wrapper asked for."""
    from sheeprl_tpu_torch.envs.device import DEVICE_ENV_REGISTRY, is_device_env_id

    backend = str(cfg.algo.get("env_backend", "host") or "host").lower()
    if backend not in _ENV_BACKENDS:
        raise ValueError(f"algo.env_backend must be one of {_ENV_BACKENDS}, got '{backend}'")
    if backend == "host":
        raise NotImplementedError(
            "algo.env_backend=host (gymnasium envs) is not ported yet: ROADMAP A2; the port runs "
            "algo.env_backend=jax with env=jax_cartpole, env=jax_pendulum or env=jax_gridworld"
        )
    env_id = str(cfg.env.id)
    if not is_device_env_id(env_id):
        raise ValueError(
            f"algo.env_backend=jax requires a registered device env family, got env.id='{env_id}'; "
            f"available: {', '.join(sorted(DEVICE_ENV_REGISTRY))}"
        )
    if cfg.env.get("restart_on_crash", False):
        raise ValueError(
            "env.restart_on_crash=true is incompatible with algo.env_backend=jax: device-resident envs "
            "have no host env.step to guard. Set env.restart_on_crash=false (the jax_* env configs' default)."
        )
    if not cfg.env.get("sync_env", True):
        raise ValueError(
            "env.sync_env=false (env worker processes) has no meaning on algo.env_backend=jax: the device envs "
            "step in the training process. Set env.sync_env=true (the jax_* env configs' default)."
        )
    unported = _unported_wrappers(cfg)
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: the host env wrappers wait for ROADMAP A2 (the device envs have none)"
        )
    spec = ",".join(s for s in (os.environ.get("SHEEPRL_FAULTS", ""), str(cfg.get("faults") or "")) if s)
    if "env_step_raise" in spec:
        raise ValueError(
            "the env_step_raise fault site is armed but algo.env_backend=jax has no host env step "
            "to raise from; disarm it"
        )
    return backend


def make_device_env_from_cfg(cfg: Dict[str, Any]):
    """The device env family that ``env.id`` and the ``env.wrapper`` node's
    family kwargs describe (the adapter-only keys left out)."""
    from sheeprl_tpu_torch.envs.device import make_device_env

    wrapper = dict(cfg.env.wrapper)
    kwargs = {k: v for k, v in wrapper.items() if k not in ("_target_", "id", "seed", "rank")}
    return make_device_env(str(cfg.env.id), **kwargs)


def make_vector_env(cfg: Dict[str, Any], device, num_envs: int, seed: int, *, wrapper_chain: bool):
    """``num_envs`` envs of the device family on ``device``, their draws
    from a generator of their own seeded with ``seed``.

    ``wrapper_chain=False`` steps as ``JaxVectorEnv`` does, which the JAX
    package's PPO, A2C and SAC loops step on its device backend:
    ``env.max_episode_steps`` replaces the family's limit.  It has no action
    repeat, so ``env.action_repeat > 1`` raises rather than be ignored.

    ``wrapper_chain=True`` steps as ``make_env``'s chain over the gym adapter
    does, which the JAX package's DreamerV3 loop and every test episode
    step: the family's own limit, ``ActionRepeat`` where
    ``env.action_repeat > 1``, ``TimeLimit(env.max_episode_steps)`` counting
    the calls, and rewards and returns summed in float64."""
    import torch

    from sheeprl_tpu_torch.envs.device import DeviceVectorEnv

    resolve_env_backend(cfg)
    env = make_device_env_from_cfg(cfg)
    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    if not keys:
        raise ValueError("`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must not both be empty")
    if not set(keys) & set(env.observation_space.keys()):
        raise ValueError(
            f"The user-specified keys {keys} are not a subset of the environment observation keys "
            f"{list(env.observation_space.keys())}"
        )
    repeat = int(cfg.env.get("action_repeat", 1) or 1)
    if wrapper_chain:
        limit = cfg.env.get("max_episode_steps")
        return DeviceVectorEnv(
            env, num_envs, device=device, seed=seed, action_repeat=max(repeat, 1),
            time_limit=int(limit) if limit and int(limit) > 0 else None, return_dtype=torch.float64,
        )
    if repeat > 1:
        raise ValueError(
            f"env.action_repeat={repeat}: the JAX package's device vector env (JaxVectorEnv), which this "
            "algorithm steps on algo.env_backend=jax, has no action repeat; set env.action_repeat=1"
        )
    max_steps = cfg.env.max_episode_steps if cfg.env.get("max_episode_steps") else None
    return DeviceVectorEnv(env, num_envs, max_episode_steps=max_steps, device=device, seed=seed)


def make_train_envs(cfg: Dict[str, Any], runtime, *, wrapper_chain: bool = False):
    """The training vector env: ``env.num_envs`` envs a shard of the device
    family, on the runtime's device, seeded by ``cfg.seed``
    (:func:`make_vector_env`)."""
    return make_vector_env(
        cfg, runtime.device, cfg.env.num_envs * runtime.world_size, int(cfg.seed), wrapper_chain=wrapper_chain
    )


def run_test_episode(cfg: Dict[str, Any], runtime, act: Callable[[Dict[str, np.ndarray]], Any],
                     seed: Optional[int] = None) -> float:
    """One test episode, one env wide, on the runtime's device: the JAX
    package's ``test`` over ``make_env(cfg, seed)``.  The env steps
    ``make_env``'s chain and is reset with ``seed`` (``cfg.seed`` by
    default); ``act(obs)`` gives the one env's action for its numpy
    observations.  The episode ends where the env's does, or after one step
    with ``dry_run``.  Prints ``Test - Reward:`` and returns the summed
    reward."""
    seed = cfg.seed if seed is None else seed
    env = make_vector_env(cfg, runtime.device, 1, int(seed), wrapper_chain=True)
    obs = env.reset(seed=int(seed))[0]
    done = False
    cumulative_rew = 0.0
    while not done:
        actions = np.asarray(act(obs)).reshape(1, *env.single_action_space.shape)
        obs, reward, terminated, truncated, _ = env.step(actions)
        done = bool(terminated[0] or truncated[0] or cfg.dry_run)
        cumulative_rew += float(reward[0])
    runtime.print("Test - Reward:", cumulative_rew)
    env.close()
    return cumulative_rew

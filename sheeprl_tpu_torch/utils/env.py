"""Env construction from the config (counterpart of the device branch of
``sheeprl_tpu/utils/env.py``).

The port has one env backend, ``algo.env_backend=jax``: the torch-tensor
envs of ``sheeprl_tpu_torch/envs/device/`` on the runtime's device.  The
gymnasium ``host`` backend waits for ROADMAP A2 and raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["make_device_env_from_cfg", "make_train_envs", "resolve_env_backend"]

_ENV_BACKENDS = ("host", "jax")


def resolve_env_backend(cfg: Dict[str, Any]) -> str:
    """``algo.env_backend``, validated: ``jax`` needs a registered device env
    family behind ``env.id``, ``env.restart_on_crash`` off (there is no host
    ``env.step`` for the restart guard to guard) and the ``env_step_raise``
    fault site unarmed (it would never fire)."""
    from sheeprl_tpu_torch.envs.device import DEVICE_ENV_REGISTRY, WAITING, is_device_env_id

    backend = str(cfg.algo.get("env_backend", "host") or "host").lower()
    if backend not in _ENV_BACKENDS:
        raise ValueError(f"algo.env_backend must be one of {_ENV_BACKENDS}, got '{backend}'")
    if backend == "host":
        raise NotImplementedError(
            "algo.env_backend=host (gymnasium envs) is not ported yet: ROADMAP A2; the port runs "
            "algo.env_backend=jax with env=jax_cartpole or env=jax_pendulum"
        )
    env_id = str(cfg.env.id)
    if env_id in WAITING:
        raise NotImplementedError(f"env '{env_id}' is not ported yet: {WAITING[env_id]}")
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


def make_train_envs(cfg: Dict[str, Any], runtime):
    """The training vector env: ``env.num_envs`` envs a shard of the device
    family, on the runtime's device (their noise comes from the runtime's
    generator, seeded by ``cfg.seed``)."""
    from sheeprl_tpu_torch.envs.device import DeviceVectorEnv

    resolve_env_backend(cfg)
    max_steps = cfg.env.max_episode_steps if cfg.env.get("max_episode_steps") else None
    return DeviceVectorEnv(
        make_device_env_from_cfg(cfg),
        cfg.env.num_envs * runtime.world_size,
        max_episode_steps=max_steps,
        device=runtime.device,
    )

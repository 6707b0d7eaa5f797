"""Device-resident environments on torch tensors (counterpart of
``sheeprl_tpu/envs/jax/``), registered under the JAX package's ids.

- :mod:`.core`: the env protocol, ``tree_select``, ``vector_reset`` and
  ``vector_step`` (SAME_STEP auto-reset, truncation, episode totals);
- :mod:`.classic`: CartPole and Pendulum;
- :mod:`.vector`: :class:`DeviceVectorEnv`, N envs of one family as the
  training loop sees them (spaces, count, time limit, device);
- :mod:`.collect`: the fused on-policy collect.

``jax_gridworld`` waits for ROADMAP A2 (with the DV3 loop); the gym
adapter is not ported (the card's machine has no gymnasium).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from sheeprl_tpu_torch.envs.device.classic import CartPole, Pendulum
from sheeprl_tpu_torch.envs.device.core import DeviceEnv, tree_select, vector_reset, vector_step
from sheeprl_tpu_torch.envs.device.vector import DeviceVectorEnv

__all__ = [
    "DEVICE_ENV_REGISTRY",
    "CartPole",
    "DeviceEnv",
    "DeviceVectorEnv",
    "Pendulum",
    "is_device_env_id",
    "make_device_env",
    "tree_select",
    "vector_reset",
    "vector_step",
]

#: id -> constructor, under the JAX package's ids (``env=jax_cartpole``)
DEVICE_ENV_REGISTRY: Dict[str, Callable[..., DeviceEnv]] = {
    "jax_cartpole": CartPole,
    "jax_pendulum": Pendulum,
}
#: ids of the JAX package's registry that the port has not ported yet
WAITING = {"jax_gridworld": "ROADMAP A2 (GridWorld comes with the DV3 env loop)"}


def is_device_env_id(env_id: Any) -> bool:
    return str(env_id) in DEVICE_ENV_REGISTRY


def make_device_env(id: str, **kwargs: Any) -> DeviceEnv:
    """The env family registered under ``id``, built with ``kwargs``
    (``randomize``, ``randomize_scale``, ``max_episode_steps``)."""
    if id in WAITING:
        raise NotImplementedError(f"env '{id}' is not ported yet: {WAITING[id]}")
    if id not in DEVICE_ENV_REGISTRY:
        raise ValueError(f"Unknown device env id {id!r}; registered: {', '.join(sorted(DEVICE_ENV_REGISTRY))}")
    return DEVICE_ENV_REGISTRY[id](**kwargs)

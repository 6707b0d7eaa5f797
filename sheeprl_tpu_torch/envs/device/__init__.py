"""Device-resident environments on torch tensors (counterpart of
``sheeprl_tpu/envs/jax/``), registered under the JAX package's ids.

- :mod:`.core`: the env protocol, ``tree_select``, ``vector_reset`` and
  ``vector_step`` (SAME_STEP auto-reset, truncation, episode totals);
- :mod:`.classic`: CartPole and Pendulum;
- :mod:`.gridworld`: the procedural maze;
- :mod:`.vector`: :class:`DeviceVectorEnv`, N envs of one family as the
  training loops see them, stepping behind the gymnasium vector API;
- :mod:`.collect`: the fused on-policy collect.

The gym adapter is not ported (the card's machine has no gymnasium).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from sheeprl_tpu_torch.envs.device.classic import CartPole, Pendulum
from sheeprl_tpu_torch.envs.device.core import DeviceEnv, tree_select, vector_reset, vector_step
from sheeprl_tpu_torch.envs.device.gridworld import GridWorld
from sheeprl_tpu_torch.envs.device.vector import DeviceVectorEnv

__all__ = [
    "DEVICE_ENV_REGISTRY",
    "CartPole",
    "DeviceEnv",
    "DeviceVectorEnv",
    "GridWorld",
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
    "jax_gridworld": GridWorld,
}


def is_device_env_id(env_id: Any) -> bool:
    return str(env_id) in DEVICE_ENV_REGISTRY


def make_device_env(id: str, **kwargs: Any) -> DeviceEnv:
    """The env family registered under ``id``, built with ``kwargs``
    (``randomize``, ``size``, ``max_episode_steps``, ...)."""
    if id not in DEVICE_ENV_REGISTRY:
        raise ValueError(f"Unknown device env id {id!r}; registered: {', '.join(sorted(DEVICE_ENV_REGISTRY))}")
    return DEVICE_ENV_REGISTRY[id](**kwargs)

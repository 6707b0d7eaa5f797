"""``DeviceVectorEnv``: N envs of one device family, as the training loop
sees them.

Counterpart of ``sheeprl_tpu/envs/jax/vector.py:JaxVectorEnv`` for the
fused collect: the family, the env count, the time limit, the device and
the single-env spaces.  It holds no state and steps nothing: the collector
(``envs/device/collect.py``) keeps the vector state and steps it through
``core.vector_reset`` / ``core.vector_step``, as the greedy test episode
does.
"""

from __future__ import annotations

from typing import Optional

from sheeprl_tpu_torch.envs.device.core import DeviceEnv
from sheeprl_tpu_torch.utils.utils import resolve_device

__all__ = ["DeviceVectorEnv"]


class DeviceVectorEnv:
    def __init__(self, env: DeviceEnv, num_envs: int, max_episode_steps: Optional[int] = None, device=None):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = resolve_device(device)
        self.max_episode_steps = max_episode_steps if max_episode_steps is not None else env.max_episode_steps
        self.single_observation_space = env.observation_space
        self.single_action_space = env.action_space

    def __repr__(self) -> str:
        return f"DeviceVectorEnv({type(self.env).__name__}, num_envs={self.num_envs}, device={self.device})"

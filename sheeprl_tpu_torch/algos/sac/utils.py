"""SAC helpers (counterpart of ``sheeprl_tpu/algos/sac/utils.py``).  ``test``
(a greedy episode in a real env) waits for the env slice."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "prepare_obs"]

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
}
MODELS_TO_REGISTER = {"agent"}


def prepare_obs(obs: Dict[str, np.ndarray], *, mlp_keys: Sequence[str] = (), num_envs: int = 1, **kwargs: Any) -> np.ndarray:
    """The vector observation keys side by side: (num_envs, obs_dim) f32."""
    with_batch = {k: np.asarray(obs[k]).reshape(num_envs, -1) for k in mlp_keys}
    return np.concatenate([with_batch[k] for k in mlp_keys], axis=-1).astype(np.float32)

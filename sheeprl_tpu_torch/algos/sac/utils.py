"""SAC helpers (counterpart of ``sheeprl_tpu/algos/sac/utils.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "prepare_obs", "test"]

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


@torch.no_grad()
def test(
    player,
    runtime,
    cfg: Dict[str, Any],
    log_dir: str,
    test_name: str = "",
    greedy: bool = True,
    seed: Optional[int] = None,
) -> float:
    """One episode of ``player``'s actor, greedy by default, on the port's
    device env, one env wide (``utils/env.py:run_test_episode``), its draws
    from the runtime's generator."""
    from sheeprl_tpu_torch.algos.sac.agent import SACPlayer
    from sheeprl_tpu_torch.utils.env import run_test_episode

    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    player = SACPlayer(player.actor, lambda obs: prepare_obs(obs, mlp_keys=mlp_keys, num_envs=1))

    def act(obs):
        return player.get_actions(obs, runtime.generator, greedy=greedy).cpu().numpy()

    return run_test_episode(cfg, runtime, act, seed)

"""SAC-AE helpers (counterpart of ``sheeprl_tpu/algos/sac_ae/utils.py``):
``preprocess_obs`` (the decoder's pixel targets), ``prepare_obs`` and the
closing ``test`` episode."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "prepare_obs", "preprocess_obs", "test"]

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
    "Loss/reconstruction_loss",
}
MODELS_TO_REGISTER = {"agent", "encoder", "decoder"}


def preprocess_obs(obs: torch.Tensor, noise: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """[0, 255] images quantised to ``bits`` bits, dequantised with the
    uniforms ``noise`` in [0, 1) (obs's shape) and centred (``utils.py:25``,
    arXiv:1807.03039)."""
    bins = 2**bits
    if bits < 8:
        obs = torch.floor(obs / 2 ** (8 - bits))
    return obs / bins + noise / bins - 0.5


def prepare_obs(obs: Dict[str, np.ndarray], *, cnn_keys: Sequence[str] = (), num_envs: int = 1,
                **kwargs: Any) -> Dict[str, np.ndarray]:
    """(num_envs, ...) f32 observations; images NHWC scaled to [0, 1]."""
    out = {}
    for k, v in obs.items():
        arr = np.asarray(v, dtype=np.float32)
        out[k] = arr.reshape(num_envs, *arr.shape[-3:]) / 255.0 if k in cnn_keys else arr.reshape(num_envs, -1)
    return out


@torch.no_grad()
def test(player, runtime, cfg: Dict[str, Any], log_dir: str, test_name: str = "", greedy: bool = True,
         seed: Optional[int] = None) -> float:
    """One episode of ``player``'s policy, greedy by default, on the port's
    device env, one env wide (``utils/env.py:run_test_episode``)."""
    from sheeprl_tpu_torch.algos.sac_ae.agent import SACAEPlayer
    from sheeprl_tpu_torch.utils.env import run_test_episode

    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    player = SACAEPlayer(player.agent, lambda obs: prepare_obs({k: obs[k] for k in keys}, cnn_keys=cnn_keys, num_envs=1))

    def act(obs):
        return player.get_actions(obs, runtime.generator, greedy=greedy).cpu().numpy()

    return run_test_episode(cfg, runtime, act, seed)

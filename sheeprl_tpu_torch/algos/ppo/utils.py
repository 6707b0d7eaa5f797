"""PPO helpers (counterpart of ``sheeprl_tpu/algos/ppo/utils.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
}
MODELS_TO_REGISTER = {"agent"}


def normalize_obs(obs: Dict[str, Any], cnn_keys: Sequence[str], obs_keys: Sequence[str]) -> Dict[str, Any]:
    """uint8 image keys to [-0.5, 0.5] floats; the rest as they are."""
    return {k: obs[k] / 255.0 - 0.5 if k in cnn_keys else obs[k] for k in obs_keys}


def prepare_obs(
    obs: Dict[str, Any], *, cnn_keys: Sequence[str] = (), num_envs: int = 1, device=None, **kwargs: Any
) -> Dict[str, torch.Tensor]:
    """An obs dict as f32 tensors of (num_envs, ...) on ``device``,
    normalised."""
    out = {}
    for k, v in obs.items():
        arr = torch.as_tensor(v, device=device).to(torch.float32)
        out[k] = arr.reshape(num_envs, *arr.shape[-3:]) if k in cnn_keys else arr.reshape(num_envs, -1)
    return normalize_obs(out, cnn_keys, list(out.keys()))


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
    """One episode of the agent, greedy by default, on the port's device
    env, one env wide (``utils/env.py:run_test_episode``), its draws from
    the runtime's generator."""
    from sheeprl_tpu_torch.algos.ppo.agent import sample_actions
    from sheeprl_tpu_torch.utils.env import run_test_episode

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    keys = cnn_keys + tuple(cfg.algo.mlp_keys.encoder)

    def act(obs):
        o = normalize_obs({k: torch.as_tensor(obs[k], device=runtime.device).float() for k in keys}, cnn_keys, keys)
        flat, real, _, _ = sample_actions(player.agent, o, generator=runtime.generator, greedy=greedy)
        return (flat if player.agent.is_continuous else real[..., 0]).cpu().numpy()

    return run_test_episode(cfg, runtime, act, seed)

"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``):
the percentile-EMA return normaliser ("Moments"), the lambda returns,
``prepare_obs`` and the closing ``test`` episode."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.utils.utils import lambda_values as compute_lambda_values  # noqa: F401

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "compute_lambda_values", "init_moments", "prepare_obs", "test",
           "update_moments"]

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic", "moments"}


def init_moments(device=None) -> Dict[str, torch.Tensor]:
    return {"low": torch.zeros((), device=device), "high": torch.zeros((), device=device)}


@torch.no_grad()
def update_moments(
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1e8,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """-> (new_state, offset, invscale).  Quantiles interpolate linearly,
    as ``jnp.quantile`` and ``torch.quantile`` both do by default."""
    x = x.float().reshape(-1)
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state["low"] + (1 - decay) * low
    new_high = decay * state["high"] + (1 - decay) * high
    invscale = torch.clamp(new_high - new_low, min=1.0 / max_)
    return {"low": new_low, "high": new_high}, new_low, invscale


def prepare_obs(
    obs: Dict[str, np.ndarray], *, cnn_keys: Sequence[str] = (), num_envs: int = 1, device=None, **kwargs: Any
) -> Dict[str, torch.Tensor]:
    """(1, num_envs, ...) f32 tensors on ``device``, one upload a key; images
    NHWC scaled to [-0.5, 0.5]."""
    out = {}
    for k, v in obs.items():
        arr = torch.as_tensor(np.asarray(v)).to(device=device, dtype=torch.float32)
        if k in cnn_keys:
            out[k] = arr.reshape(1, num_envs, *arr.shape[-3:]) / 255.0 - 0.5
        else:
            out[k] = arr.reshape(1, num_envs, -1)
    return out


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
    """One episode of ``player`` on the port's device env, one env wide
    (``utils/env.py:run_test_episode``), its draws from the runtime's
    generator.  The player's env count and states are restored after."""
    from sheeprl_tpu_torch.utils.env import run_test_episode

    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)

    def act(obs):
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=1, device=runtime.device)
        mask = {k: v for k, v in prepared.items() if k.startswith("mask")} or None
        real_actions = player.get_actions(prepared, greedy, runtime.generator, mask)
        if player.is_continuous:
            return torch.cat(list(real_actions), -1).cpu().numpy()
        return torch.stack([a.argmax(-1) for a in real_actions], -1).cpu().numpy()

    old_num_envs = player.num_envs
    player.num_envs = 1
    player.init_states()
    cumulative_rew = run_test_episode(cfg, runtime, act, seed)
    player.num_envs = old_num_envs
    player.init_states()
    return cumulative_rew

"""Recurrent-PPO helpers (counterpart of ``sheeprl_tpu/algos/ppo_recurrent/utils.py``).

``evaluate.py`` waits for ``utils/eval_protocol.py`` (ROADMAP A2).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "prepare_obs", "test"]

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
}
MODELS_TO_REGISTER = {"agent"}


def prepare_obs(
    obs: Dict[str, Any], *, cnn_keys: Sequence[str] = (), num_envs: int = 1, device=None, **kwargs: Any
) -> Dict[str, torch.Tensor]:
    """An obs dict as f32 tensors of (T = 1, num_envs, ...) on ``device``,
    normalised: the layout the recurrent agent reads."""
    out = {}
    for k, v in obs.items():
        arr = torch.as_tensor(v, device=device).to(torch.float32)
        out[k] = arr.reshape(1, num_envs, *arr.shape[-3:]) if k in cnn_keys else arr.reshape(1, num_envs, -1)
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
    """One episode of ``player``'s agent with its recurrent state carried
    from step to step (zero at the start), greedy by default, on the port's
    device env, one env wide (``utils/env.py:run_test_episode``), its draws
    from the runtime's generator."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import RecurrentPPOPlayer
    from sheeprl_tpu_torch.utils.env import run_test_episode

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    keys = cnn_keys + tuple(cfg.algo.mlp_keys.encoder)
    one = RecurrentPPOPlayer(
        player.agent,
        lambda obs: prepare_obs({k: obs[k] for k in keys}, cnn_keys=cnn_keys, num_envs=1, device=runtime.device),
        num_envs=1,
    )

    def act(obs):
        flat, real, _, _ = one.get_actions(obs, generator=runtime.generator, greedy=greedy)
        return (flat if one.agent.is_continuous else real[..., 0]).cpu().numpy()

    return run_test_episode(cfg, runtime, act, seed)

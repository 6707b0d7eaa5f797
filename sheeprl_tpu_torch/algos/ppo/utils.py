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
    env, one env wide, on the runtime's device; its reset noise comes from
    a generator seeded with ``seed`` (``cfg.seed`` by default).  The JAX
    package's ``test`` steps a gymnasium env built by ``make_env``, for a
    ``jax_*`` id the gym adapter over the same dynamics."""
    from sheeprl_tpu_torch.envs.device import vector_reset
    from sheeprl_tpu_torch.envs.device.collect import policy_env_step
    from sheeprl_tpu_torch.utils.env import make_device_env_from_cfg

    env = make_device_env_from_cfg(cfg)
    device = runtime.device
    seed = cfg.seed if seed is None else seed
    generator = torch.Generator(device=device).manual_seed(int(seed))
    limit = cfg.env.max_episode_steps if cfg.env.get("max_episode_steps") else env.max_episode_steps
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    keys = tuple(cnn_keys) + tuple(cfg.algo.mlp_keys.encoder)
    vstate = vector_reset(env, 1, generator=generator, device=device)
    cumulative_rew = 0.0
    done = False
    while not done:
        obs = normalize_obs({k: vstate["obs"][k].float() for k in keys}, cnn_keys, keys)
        vstate, out, _, _, _ = policy_env_step(player.agent, env, vstate, obs, limit, generator=generator, greedy=greedy)
        reward, ended = torch.stack([out["reward"][0], out["done"][0].float()]).tolist()
        cumulative_rew += reward
        done = bool(ended) or bool(cfg.dry_run)
    runtime.print("Test - Reward:", cumulative_rew)
    return cumulative_rew

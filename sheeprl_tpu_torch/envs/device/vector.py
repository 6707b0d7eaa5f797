"""``DeviceVectorEnv``: N envs of one device family, as the training loops
see them.

Counterpart of ``sheeprl_tpu/envs/jax/vector.py:JaxVectorEnv``.  It holds
the family, the env count, the time limit, the device and the single-env
spaces, which the fused collect (``envs/device/collect.py``) reads while
keeping the vector state itself, and it steps the envs behind the
gymnasium vector API that the off-policy loops call:

- ``reset(seed=None)`` resets every env (``seed`` re-seeds the env's own
  generator, which its reset noise and action draws come from) and returns
  ``(obs, {})``;
- ``step(actions)`` uploads the actions once, steps every env through
  :func:`~sheeprl_tpu_torch.envs.device.core.vector_step` (SAME_STEP
  auto-reset) and downloads its outputs once, packed into one tensor.  It
  returns JAX's contract: numpy observations, float64 rewards,
  ``terminated``/``truncated``, and where an episode ended ``final_obs``/
  ``_final_obs`` and ``final_info["episode"]`` with ``r``/``l``/``t`` and
  their masks (``t``: seconds since the last ``reset``);
- ``sample_actions()`` draws one action an env from the generator (the
  warm-up's ``envs.action_space.sample()``).

By default a step is ``JaxVectorEnv``'s: ``max_episode_steps`` replaces
the family's limit, float32 sums.  ``action_repeat``, ``time_limit`` and
``return_dtype=torch.float64`` give instead the steps of ``make_env``'s
wrapper chain over the gym adapter (``ActionRepeat``, ``TimeLimit`` and
``RecordEpisodeStatistics``, which sum in Python floats), which the JAX
package's DreamerV3 loop and test episodes step
(``utils/env.py:make_vector_env``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.core import DeviceEnv, vector_reset, vector_step
from sheeprl_tpu_torch.utils.utils import resolve_device

__all__ = ["DeviceVectorEnv"]


class DeviceVectorEnv:
    def __init__(
        self,
        env: DeviceEnv,
        num_envs: int,
        max_episode_steps: Optional[int] = None,
        device=None,
        seed: int = 0,
        *,
        action_repeat: int = 1,
        time_limit: Optional[int] = None,
        return_dtype: torch.dtype = torch.float32,
    ):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = resolve_device(device)
        self.max_episode_steps = max_episode_steps if max_episode_steps is not None else env.max_episode_steps
        self.single_observation_space = env.observation_space
        self.single_action_space = env.action_space
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.action_repeat = int(action_repeat)
        if self.action_repeat < 1:
            raise ValueError(f"env.action_repeat must be a positive integer, got {action_repeat}")
        self.time_limit = time_limit
        self.return_dtype = return_dtype
        self._discrete = isinstance(env.action_space, (spaces.Discrete, spaces.MultiDiscrete))
        self._vstate: Optional[Dict[str, Any]] = None
        self._episode_start_ts = 0.0

    def reset(self, *, seed: Optional[int] = None, noise: Optional[Dict[str, torch.Tensor]] = None):
        """Reset every env from ``noise``, or from the generator's draw."""
        if seed is not None:
            self.generator.manual_seed(int(seed))
        self._vstate = vector_reset(
            self.env, self.num_envs, generator=self.generator, noise=noise, device=self.device,
            return_dtype=self.return_dtype,
        )
        self._episode_start_ts = time.perf_counter()
        return {k: v.cpu().numpy() for k, v in self._vstate["obs"].items()}, {}

    def sample_actions(self) -> torch.Tensor:
        """One action an env, drawn on the device from the generator."""
        return self.single_action_space.sample(self.num_envs, self.generator, self.device)

    def step(self, actions, reset_noise: Optional[Dict[str, torch.Tensor]] = None):
        if self._vstate is None:
            raise RuntimeError("DeviceVectorEnv.step called before reset()")
        n = self.num_envs
        acts = torch.as_tensor(np.asarray(actions)).to(self.device)
        if self._discrete:
            acts = acts.reshape(n, *self.single_action_space.shape).to(torch.int64)
        else:
            acts = acts.reshape(n, *self.single_action_space.shape).to(torch.float32)
        self._vstate, out = vector_step(
            self.env, self._vstate, acts, self.max_episode_steps, reset_noise=reset_noise, generator=self.generator,
            action_repeat=self.action_repeat, time_limit=self.time_limit,
        )
        host = self._download(out)
        obs = host["obs"]
        reward = host["reward"].astype(np.float64)
        terminated = host["terminated"]
        truncated = host["truncated"]
        done = terminated | truncated

        infos: Dict[str, Any] = {}
        if done.any():
            final_obs = np.full(n, None, dtype=object)
            for i in np.nonzero(done)[0]:
                final_obs[i] = {k: v[i] for k, v in host["final_obs"].items()}
            ep_r = np.where(done, host["ep_return"].astype(np.float64), 0.0)
            ep_l = np.where(done, host["ep_length"], 0)
            ep_t = np.where(done, round(time.perf_counter() - self._episode_start_ts, 6), 0.0)
            infos["final_obs"] = final_obs
            infos["_final_obs"] = done.copy()
            infos["final_info"] = {
                "episode": {"r": ep_r, "_r": done.copy(), "l": ep_l, "_l": done.copy(), "t": ep_t, "_t": done.copy()},
                "_episode": done.copy(),
            }
            infos["_final_info"] = done.copy()
        return obs, reward, terminated, truncated, infos

    def _download(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """The step's outputs on the host, from one copy of one float64
        block (exact for every field: float32 and float64 values, flags and
        counts): the observations (before and after the reset), the reward,
        the two end flags and the episode totals."""
        n = self.num_envs
        parts = [("obs", k, v) for k, v in out["obs"].items()]
        parts += [("final_obs", k, v) for k, v in out["final_obs"].items()]
        parts += [(k, None, out[k]) for k in ("reward", "terminated", "truncated", "ep_return", "ep_length")]
        block = torch.cat([v.reshape(n, -1).to(torch.float64) for _, _, v in parts], 1).cpu().numpy()
        host: Dict[str, Any] = {"obs": {}, "final_obs": {}}
        col = 0
        for group, key, v in parts:
            width = int(np.prod(v.shape[1:], dtype=np.int64))
            arr = block[:, col : col + width].reshape(v.shape)
            col += width
            dtype = torch.empty((), dtype=v.dtype).numpy().dtype
            arr = arr > 0.5 if dtype == np.bool_ else arr.astype(dtype)
            if key is None:
                host[group] = arr
            else:
                host[group][key] = arr
        return host

    def close(self) -> None:
        self._vstate = None

    def __repr__(self) -> str:
        return f"DeviceVectorEnv({type(self.env).__name__}, num_envs={self.num_envs}, device={self.device})"

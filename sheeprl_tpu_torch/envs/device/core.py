"""Device-resident environments on torch tensors: the env protocol and the
vectorised auto-reset step.

Counterpart of ``sheeprl_tpu/envs/jax/core.py``.  An env family steps all
of its N instances in one call: every leaf of its state is a tensor whose
first axis is the env axis, and ``reset``/``step`` are elementwise
functions of those tensors (no Python loop over envs).  The
episode-boundary bookkeeping (SAME_STEP auto-reset, time-limit truncation,
``final_obs``, the episode totals) lives here, once for every family.

Randomness.  The JAX package derives every env's keys from the run key by
``fold_in`` chains; here a family draws its reset noise from an explicit
``torch.Generator`` (:meth:`DeviceEnv.reset_noise`), or takes noise that
the caller supplies, which is how the tests feed the JAX package's draws.
The two packages' streams therefore differ; given the same noise they
compute the same states.  Each family's noise is the JAX family's draws
before any further arithmetic (CartPole: the uniforms in [-0.05, 0.05)
and the randomisation factors).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["DeviceEnv", "tree_select", "vector_reset", "vector_step"]

State = Dict[str, torch.Tensor]


class DeviceEnv:
    """Protocol of a device-resident env family, batched over the env axis.

    ``reset(noise) -> (state, obs)`` and ``step(state, action) -> (state,
    obs, reward, terminated, info)`` take and return dicts of tensors whose
    first axis is the env axis.  ``terminated`` is the MDP-terminal signal
    only; time-limit truncation is :func:`vector_step`'s.
    """

    observation_space: Any = None
    action_space: Any = None
    max_episode_steps: Optional[int] = None

    def reset_noise(self, n: int, generator: Optional[torch.Generator] = None, device=None) -> State:
        """The noise that ``reset`` of ``n`` envs consumes."""
        raise NotImplementedError

    def reset(self, noise: State) -> Tuple[State, State]:
        raise NotImplementedError

    def step(self, state: State, action: torch.Tensor) -> Tuple[State, State, torch.Tensor, torch.Tensor, dict]:
        raise NotImplementedError


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)`` on the port's
    generator: ``max(lo, u * (hi - lo) + lo)`` with ``u`` in [0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return torch.clamp_min(u * (hi - lo) + lo, lo)


def tree_select(pred: torch.Tensor, on_true: State, on_false: State) -> State:
    """Per-env ``where`` over matching dicts: ``pred`` is (N,) and
    broadcasts over each leaf's trailing dims.  The auto-reset fold."""

    def sel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim())), a, b)

    return {k: sel(on_true[k], on_false[k]) for k in on_true}


def vector_reset(
    env: DeviceEnv,
    num_envs: int,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[State] = None,
    device=None,
    return_dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """Reset ``num_envs`` envs: the vector state (the env state, the current
    obs and the per-env episode accounting).  ``return_dtype`` is the dtype
    that :func:`vector_step` sums rewards and episode returns in."""
    if noise is None:
        noise = env.reset_noise(num_envs, generator, device)
    state, obs = env.reset(noise)
    dev = next(iter(obs.values())).device
    return {
        "env": state,
        "obs": obs,
        "t": torch.zeros(num_envs, dtype=torch.int32, device=dev),
        "ep_return": torch.zeros(num_envs, dtype=return_dtype, device=dev),
        "ep_length": torch.zeros(num_envs, dtype=torch.int32, device=dev),
    }


def vector_step(
    env: DeviceEnv,
    vstate: Dict[str, Any],
    actions: torch.Tensor,
    max_episode_steps: Optional[int] = None,
    *,
    reset_noise: Optional[State] = None,
    generator: Optional[torch.Generator] = None,
    action_repeat: int = 1,
    time_limit: Optional[int] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One auto-resetting step of every env (gymnasium's SAME_STEP mode).

    Returns ``(new_vstate, out)``; ``out`` holds ``obs`` (the reset obs
    where an episode ended), ``reward``, ``terminated``, ``truncated``,
    ``done``, ``final_obs`` (the obs before the reset) and ``ep_return`` /
    ``ep_length`` (the episode totals including this step; valid where
    done).  Every env draws a reset each step and the done ones take it,
    as in the JAX package; ``reset_noise`` supplies that draw.  Rewards and
    returns are summed in the dtype of ``vstate["ep_return"]``.

    ``max_episode_steps`` (else the family's) truncates an episode where it
    has taken that many steps of the family and not terminated.
    ``action_repeat > 1`` steps each env up to that many times with the
    same action, summing the rewards and stopping an env where its episode
    ends (``envs/wrappers.py:ActionRepeat``).  ``time_limit`` is gymnasium's
    ``TimeLimit`` above the repeat: it counts the calls, and truncates where
    it is reached, terminated or not.  These two are the steps of
    ``make_env``'s wrapper chain over the gym adapter.
    """
    num_envs = vstate["t"].shape[0]
    acc = vstate["ep_return"].dtype
    limit = max_episode_steps if max_episode_steps is not None else env.max_episode_steps

    def clipped(t, terminated):
        return (t >= int(limit)) & ~terminated if limit else torch.zeros_like(terminated)

    new_env, obs, reward, terminated, _info = env.step(vstate["env"], actions)
    reward = reward.to(torch.float32).reshape(num_envs).to(acc)
    terminated = terminated.reshape(num_envs).to(torch.bool)
    t = vstate["t"] + 1
    truncated = clipped(t, terminated)
    for _ in range(int(action_repeat) - 1):
        live = ~(terminated | truncated)
        stepped, obs_i, reward_i, term_i, _info = env.step(new_env, actions)
        new_env = tree_select(live, stepped, new_env)
        obs = tree_select(live, obs_i, obs)
        reward_i = reward_i.to(torch.float32).reshape(num_envs).to(acc)
        reward = reward + torch.where(live, reward_i, torch.zeros_like(reward))
        terminated = terminated | (live & term_i.reshape(num_envs).to(torch.bool))
        t = t + live.to(t.dtype)
        truncated = clipped(t, terminated)
    ep_length = vstate["ep_length"] + 1
    if time_limit:
        truncated = truncated | (ep_length >= int(time_limit))
    done = terminated | truncated

    if reset_noise is None:
        reset_noise = env.reset_noise(num_envs, generator, reward.device)
    reset_env, reset_obs = env.reset(reset_noise)
    next_env = tree_select(done, reset_env, new_env)
    next_obs = tree_select(done, reset_obs, obs)

    ep_return = vstate["ep_return"] + reward
    out = {
        "obs": next_obs,
        "reward": reward,
        "terminated": terminated,
        "truncated": truncated,
        "done": done,
        "final_obs": obs,
        "ep_return": ep_return,
        "ep_length": ep_length,
    }
    new_vstate = {
        "env": next_env,
        "obs": next_obs,
        "t": torch.where(done, torch.zeros_like(t), t),
        "ep_return": torch.where(done, torch.zeros_like(ep_return), ep_return),
        "ep_length": torch.where(done, torch.zeros_like(ep_length), ep_length),
    }
    return new_vstate, out

"""Classic-control dynamics on torch tensors: CartPole and Pendulum.

Counterpart of ``sheeprl_tpu/envs/jax/classic.py`` (``CartPoleJax`` and
``PendulumJax``): the same physics, written elementwise over the env axis
in the JAX package's order of operations.  ``randomize=True`` draws each
episode's physics scale factors at reset (domain randomisation as a noise
axis).  Observations are ``{"state": ...}``, so
``algo.mlp_keys.encoder=[state]`` works as on the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.core import DeviceEnv, _uniform

__all__ = ["CartPole", "Pendulum"]


class CartPole(DeviceEnv):
    """CartPole-v1 (Barto-Sutton-Anderson, Euler integration).

    State: ``{"x": (N, 4), "params": (N, 2)}``, ``params`` the episode's
    (pole length, pole mass) scale factors, ones without randomisation.
    Reset noise: ``x`` uniform in [-0.05, 0.05), and ``params`` in
    [1 - s, 1 + s) when randomised.
    """

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    X_THRESHOLD = 2.4
    THETA_THRESHOLD = 12 * 2 * np.pi / 360

    def __init__(self, randomize: bool = False, randomize_scale: float = 0.3, max_episode_steps: int = 500):
        self.randomize = bool(randomize)
        self.randomize_scale = float(randomize_scale)
        self.max_episode_steps = int(max_episode_steps)
        self.observation_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, shape=(4,), dtype=np.float32)})
        self.action_space = spaces.Discrete(2)

    def reset_noise(self, n: int, generator: Optional[torch.Generator] = None, device=None):
        noise = {"x": _uniform((n, 4), -0.05, 0.05, generator, device)}
        if self.randomize:
            s = self.randomize_scale
            noise["params"] = _uniform((n, 2), 1.0 - s, 1.0 + s, generator, device)
        return noise

    def reset(self, noise):
        x = noise["x"].to(torch.float32)
        params = noise["params"] if self.randomize else torch.ones(x.shape[0], 2, dtype=torch.float32, device=x.device)
        return {"x": x, "params": params}, {"state": x}

    def step(self, state, action):
        x, x_dot, theta, theta_dot = state["x"].unbind(-1)
        params = state["params"]
        length = self.LENGTH * params[:, 0]
        masspole = self.MASSPOLE * params[:, 1]
        total_mass = self.MASSCART + masspole
        polemass_length = masspole * length

        force = torch.where(action.reshape(-1).to(torch.int32) == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        new_x = torch.stack([x, x_dot, theta, theta_dot], -1).to(torch.float32)

        terminated = (torch.abs(x) > self.X_THRESHOLD) | (torch.abs(theta) > self.THETA_THRESHOLD)
        reward = torch.ones_like(x)
        return {"x": new_x, "params": params}, {"state": new_x}, reward, terminated, {}


class Pendulum(DeviceEnv):
    """Pendulum-v1 (torque-limited swing-up; episodes end by truncation).

    State: ``{"th": (N,), "thdot": (N,), "params": (N, 2)}``, ``params`` the
    episode's (gravity, length) scale factors.  Reset noise: ``init``
    uniform in [-1, 1) (scaled by (pi, 1) at reset), and ``params`` when
    randomised.
    """

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self, randomize: bool = False, randomize_scale: float = 0.3, max_episode_steps: int = 200):
        self.randomize = bool(randomize)
        self.randomize_scale = float(randomize_scale)
        self.max_episode_steps = int(max_episode_steps)
        self.observation_space = spaces.Dict(
            {
                "state": spaces.Box(
                    np.array([-1.0, -1.0, -self.MAX_SPEED], np.float32),
                    np.array([1.0, 1.0, self.MAX_SPEED], np.float32),
                    dtype=np.float32,
                )
            }
        )
        self.action_space = spaces.Box(-self.MAX_TORQUE, self.MAX_TORQUE, shape=(1,), dtype=np.float32)

    def _obs(self, th: torch.Tensor, thdot: torch.Tensor):
        return {"state": torch.stack([torch.cos(th), torch.sin(th), thdot], -1).to(torch.float32)}

    def reset_noise(self, n: int, generator: Optional[torch.Generator] = None, device=None):
        noise = {"init": _uniform((n, 2), -1.0, 1.0, generator, device)}
        if self.randomize:
            s = self.randomize_scale
            noise["params"] = _uniform((n, 2), 1.0 - s, 1.0 + s, generator, device)
        return noise

    def reset(self, noise):
        init = noise["init"].to(torch.float32)
        high = torch.tensor([math.pi, 1.0], dtype=torch.float32, device=init.device)
        init = init * high
        n = init.shape[0]
        params = noise["params"] if self.randomize else torch.ones(n, 2, dtype=torch.float32, device=init.device)
        state = {"th": init[:, 0], "thdot": init[:, 1], "params": params}
        return state, self._obs(state["th"], state["thdot"])

    def step(self, state, action):
        th, thdot = state["th"], state["thdot"]
        params = state["params"]
        g = self.G * params[:, 0]
        length = self.L * params[:, 1]
        u = torch.clamp(action.reshape(th.shape[0]).to(torch.float32), -self.MAX_TORQUE, self.MAX_TORQUE)

        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2

        newthdot = thdot + (3.0 * g / (2.0 * length) * torch.sin(th) + 3.0 / (self.M * length**2) * u) * self.DT
        newthdot = torch.clamp(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT

        new_state = {"th": newth, "thdot": newthdot, "params": params}
        reward = (-cost).to(torch.float32)
        terminated = torch.zeros_like(th, dtype=torch.bool)
        return new_state, self._obs(newth, newthdot), reward, terminated, {}

"""Small tensor helpers (counterpart of ``sheeprl_tpu/utils/utils.py``)."""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "MetricFetchGate",
    "Ratio",
    "check_loop_scope",
    "ema_",
    "fetch_actions",
    "fetch_metrics",
    "gae",
    "grads_or_zeros",
    "lambda_values",
    "normalize_tensor",
    "polynomial_decay",
    "resolve_device",
    "save_configs",
    "symexp",
    "symlog",
    "trainable_params",
    "two_hot_encoder",
]


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: Optional[int] = None) -> torch.Tensor:
    """Two-hot encoding of ``x`` (..., 1) over ``num_buckets`` bins evenly
    spanning ``[-support_range, support_range]``: (..., num_buckets).
    The caller applies symlog.  Closed form over the uniform support, as
    the JAX package computes it (no comparison broadcast)."""
    if num_buckets is None:
        num_buckets = support_range * 2 + 1
    x = torch.clamp(x, -support_range, support_range)
    step = (2.0 * support_range) / (num_buckets - 1)
    below = torch.floor((x + support_range) / step).to(torch.int64).clamp(0, num_buckets - 1)
    above = (below + 1).clamp(0, num_buckets - 1)
    sup_below = -support_range + below.to(x.dtype) * step
    sup_above = -support_range + above.to(x.dtype) * step
    equal = below == above
    dist_below = torch.where(equal, torch.ones_like(x), torch.abs(sup_below - x))
    dist_above = torch.where(equal, torch.ones_like(x), torch.abs(sup_above - x))
    total = dist_below + dist_above
    w_below = dist_above / total
    w_above = dist_below / total
    oh_below = F.one_hot(below.squeeze(-1), num_buckets).to(x.dtype) * w_below
    oh_above = F.one_hot(above.squeeze(-1), num_buckets).to(x.dtype) * w_above
    return oh_below + oh_above


def lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """TD(lambda) returns over (T, B, 1) inputs, ``continues`` already
    scaled by gamma: ``R[t] = r[t] + c[t]((1 - lambda) v[t] + lambda R[t+1])``
    seeded with ``R[T] = v[T-1]`` (the JAX package's reverse scan)."""
    interm = rewards + continues * values * (1 - lmbda)
    carry = values[-1]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = interm[t] + continues[t] * lmbda * carry
        out.append(carry)
    return torch.stack(out[::-1], 0)


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over time-major (T, B, 1) inputs,
    ``next_value`` (B, 1): ``(returns, advantages)``, f32.  The TD errors
    are one pass over the rollout; the recursion
    ``A[t] = delta[t] + gamma lambda (1 - done[t]) A[t+1]`` is a reverse
    loop of two operations a step."""
    values = values.float()
    rewards = rewards.float()
    not_done = 1.0 - dones.float()
    next_values = torch.cat([values[1:], next_value.float()[None]], 0)
    delta = rewards + gamma * next_values * not_done - values
    coef = gamma * gae_lambda * not_done
    last = torch.zeros_like(next_value, dtype=torch.float32)
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        last = delta[t] + coef[t] * last
        out.append(last)
    advantages = torch.stack(out[::-1], 0)
    return advantages + values, advantages


def normalize_tensor(x: torch.Tensor, eps: float = 1e-8, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Optionally masked) standardisation with the population std, as
    ``jnp.std`` computes it."""
    if mask is None:
        return (x - x.mean()) / (x.std(correction=0) + eps)
    m = mask.to(x.dtype)
    n = m.sum()
    mean = (x * m).sum() / n
    var = (((x - mean) ** 2) * m).sum() / n
    return torch.where(mask, (x - mean) / (torch.sqrt(var) + eps), x)


def polynomial_decay(
    current_step: int, *, initial: float = 1.0, final: float = 0.0, max_decay_steps: int = 100, power: float = 1.0
) -> float:
    """Host-side scheduler (the reference's ``polynomial_decay``)."""
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final


# metric.* knobs of the JAX package's observability layer (ROADMAP A7)
_OBSERVABILITY = ("profile", "profile_every_n", "telemetry", "telemetry_tb_mirror", "tracing", "live", "ledger")


def _on(value: Any) -> bool:
    return value not in (None, False, 0, "", "off", "false", "False")


def check_loop_scope(runtime, cfg: Any, algo: str, off_policy: bool = False) -> None:
    """Raise, naming its ROADMAP item, for what no training loop of the
    port runs yet: ``fabric.devices > 1`` (A5), the training-health
    sentinel (A2) and the observability knobs (A7); for the off-policy
    loops also ``buffer.memmap`` and ``bf16-true`` (A2)."""
    if runtime.world_size > 1:
        raise NotImplementedError(f"{algo} with fabric.devices > 1 (the DDP core over shards) waits for ROADMAP A5")
    if (cfg.algo.get("sentinel") or {}).get("enabled", False):
        raise NotImplementedError("algo.sentinel.enabled (the training-health sentinel) waits for ROADMAP A2")
    on = [f"metric.{k}" for k in _OBSERVABILITY if _on(cfg.metric.get(k))]
    if on:
        raise NotImplementedError(f"{', '.join(on)}: the port's observability layer waits for ROADMAP A7")
    if off_policy and cfg.buffer.get("memmap", False):
        raise NotImplementedError("buffer.memmap=True (memory-mapped replay) waits for ROADMAP A2; use buffer.memmap=False")
    if off_policy and runtime.precision == "bf16-true":
        raise NotImplementedError("fabric.precision=bf16-true (bf16 parameters with f32 master weights) waits for ROADMAP A2")


class Ratio:
    """Replay-ratio scheduler: how many gradient steps a count of policy
    steps grants (the JAX package's ``Ratio``, from Hafner's dreamerv3).
    Host-side and checkpointable: ``state_dict`` holds ``_ratio``,
    ``_prev`` and ``_pretrain_steps``."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._pretrain_steps = pretrain_steps
        self._ratio = ratio
        self._prev: Optional[float] = None

    def __call__(self, step: int) -> int:
        if self._ratio == 0:
            return 0
        repeats = 0
        if self._prev is None:
            self._prev = step
            repeats = 1
            if self._pretrain_steps > 0:
                if step < self._pretrain_steps:
                    warnings.warn("on the first step, more steps than pretrain_steps have already been done", UserWarning)
                repeats = round(self._pretrain_steps * self._ratio)
        repeats += round((step - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return int(repeats)

    def state_dict(self) -> Dict[str, Any]:
        return {"_ratio": self._ratio, "_prev": self._prev, "_pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state: Dict[str, Any]) -> "Ratio":
        self._ratio = state["_ratio"]
        self._prev = state["_prev"]
        self._pretrain_steps = state["_pretrain_steps"]
        return self


def fetch_actions(
    action_list: Sequence[torch.Tensor], actions_dim: Sequence[int], is_continuous: bool, num_envs: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The player's per-head actions on the host in one copy:
    ``(actions, real_actions)``, the flat ``(1, num_envs, sum(actions_dim))``
    buffer layout and the env-facing form (the concatenated floats for a
    continuous space, each head's argmax for discrete ones)."""
    flat = torch.cat(list(action_list), -1).cpu().numpy()
    actions = flat.reshape(1, num_envs, -1)
    if is_continuous:
        real_actions = flat
    else:
        segments = np.split(flat, np.cumsum(np.asarray(actions_dim))[:-1], axis=-1)
        real_actions = np.stack([seg.argmax(-1) for seg in segments], -1)
    return actions, real_actions


def fetch_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar device metrics to host floats in one copy."""
    if not metrics:
        return {}
    values = torch.stack([v.detach().reshape(()).float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


class MetricFetchGate:
    """Fires on every ``metric.fetch_every``-th call (the first included):
    how often the loops bring losses and episode events to the host.
    ``every > 1`` subsamples: what the skipped calls held is dropped."""

    def __init__(self, every: Any):
        self.every = max(1, int(every or 1))
        self._n = 0

    def __call__(self) -> bool:
        hit = self._n % self.every == 0
        self._n += 1
        return hit


def save_configs(cfg: Any, log_dir: str) -> None:
    """Write the resolved run config to ``<log_dir>/config.yaml``."""
    import yaml

    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg), f)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Without a card, asking for ``cuda`` (or nothing) raises:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sheeprl_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def trainable_params(module: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """``module``'s parameters that take gradients, by name."""
    return {k: p for k, p in module.named_parameters() if p.requires_grad}


def grads_or_zeros(loss: torch.Tensor, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach gets zeros, as in JAX."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), got)}


@torch.no_grad()
def ema_(target: torch.nn.Module, source: torch.nn.Module, tau: float) -> None:
    """``optax.incremental_update``: target = tau * source + (1 - tau) * target."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.mul_(1.0 - tau).add_(s, alpha=tau)

"""Policy adapters for the session server, and checkpoint loaders.

The port's counterpart of ``sheeprl_tpu/serve/policy.py`` for the
DreamerV3 family.  The JAX adapter ``vmap``s a per-row step with a per-row
PRNG key; here the step is written for the whole batch, and per-row
randomness comes from a counter-based hash: every row carries a seed
(``_seed``) and a step counter (``_ctr``) in its session state, and its
noise is a function of those two numbers and of the element index only.
A row's outputs therefore depend only on its own state and observation,
never on which other rows share its batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

__all__ = [
    "DREAMER_OUT_KEYS",
    "agent_params_loader",
    "make_dreamer_session_fns",
    "row_gumbel",
    "row_normal",
    "row_seeds",
    "row_uniforms",
]

DREAMER_OUT_KEYS = ("flat_actions",)

_GOLDEN = 0x9E3779B97F4A7C15
_MUL1 = 0xBF58476D1CE4E5B9
_MUL2 = 0x94D049BB133111EB


def _i64(c: int) -> int:
    """A 64-bit constant as the signed value torch's int64 holds."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 bit patterns (multiplication wraps)."""
    z = (z ^ _srl(z, 30)) * _i64(_MUL1)
    z = (z ^ _srl(z, 27)) * _i64(_MUL2)
    return z ^ _srl(z, 31)


def row_uniforms(seed: torch.Tensor, ctr: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """(R, n) float64 uniforms in (0, 1): element ``i`` of row ``r`` is a
    hash of (seed[r], ctr[r], stream, i) alone."""
    base = _mix64(_mix64(seed.long()) ^ (ctr.long() * _i64(_GOLDEN)))
    base = _mix64(base + _i64((int(stream) * 0x632BE59BD9B4E019) & ((1 << 64) - 1)))
    idx = torch.arange(1, n + 1, device=seed.device, dtype=torch.int64) * _i64(_GOLDEN)
    z = _mix64(base[:, None] ^ idx[None, :])
    return (_srl(z, 11).double() + 0.5) * 2.0**-53


def row_gumbel(seed, ctr, stream: int, n: int) -> torch.Tensor:
    """(R, n) f32 standard Gumbel noise of :func:`row_uniforms`."""
    return (-torch.log(-torch.log(row_uniforms(seed, ctr, stream, n)))).float()


def row_normal(seed, ctr, stream: int, n: int) -> torch.Tensor:
    """(R, n) f32 standard normals (Box-Muller over :func:`row_uniforms`)."""
    u = row_uniforms(seed, ctr, stream, 2 * n)
    r = torch.sqrt(-2.0 * torch.log(u[:, :n]))
    return (r * torch.cos(2.0 * np.pi * u[:, n:])).float()


def row_seeds(rows: int, seed: int) -> np.ndarray:
    """Per-row noise seeds of a session opened with ``seed``."""
    return np.asarray([int(seed) * 1_000_003 + i for i in range(int(rows))], dtype=np.int64)


def make_dreamer_session_fns(
    agent,
    *,
    actions_dim: Sequence[int],
    stochastic_size: int,
    discrete_size: int,
    recurrent_state_size: int,
    decoupled_rssm: bool = False,
    greedy: bool = False,
    device=None,
):
    """``(session_policy_fn, init_state_fn)`` for Dreamer serving: encoder
    -> RSSM recurrent step -> representation -> actor, with (actions,
    recurrent_state, stochastic_state, _seed, _ctr) kept per session.

    ``session_policy_fn(agent, obs, state, noise=None)`` steps a batch;
    ``noise`` (R, stochastic_size, discrete_size) replaces the hashed
    Gumbel noise of the stochastic-state draw (the tests hand both packages
    the same noise).  The served module is the server's ``params``."""
    act_dim = int(np.sum(np.asarray(actions_dim)))
    stoch_flat = int(stochastic_size) * int(discrete_size)
    rec_size = int(recurrent_state_size)
    dev = torch.device(device) if device is not None else next(agent.parameters()).device

    def _t(a, dtype=torch.float32) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    @torch.inference_mode()
    def session_policy_fn(agent, obs: Dict[str, np.ndarray], state: Dict[str, np.ndarray], noise=None):
        wm, actor = agent.world_model, agent.actor
        rows = int(state["_seed"].shape[0])
        seed, ctr = _t(state["_seed"], torch.int64), _t(state["_ctr"], torch.int64)
        if noise is None:
            noise = row_gumbel(seed, ctr, 0, stoch_flat)
        noise = _t(noise).reshape(rows, int(stochastic_size), int(discrete_size))
        actor_noise = None
        if not greedy:
            draw = row_normal if actor.is_continuous else row_gumbel
            actor_noise = draw(seed, ctr, 1, act_dim)
        embedded = wm.encoder({k: _t(v) for k, v in obs.items()})
        rec = wm.rssm.recurrent_step(
            torch.cat([_t(state["stochastic_state"]), _t(state["actions"])], -1), _t(state["recurrent_state"])
        )
        _, stoch = wm.rssm._representation(embedded, None if decoupled_rssm else rec, noise=noise)
        stoch = stoch.reshape(rows, stoch_flat)
        actions, _ = actor(torch.cat([stoch, rec], -1), greedy, noise=actor_noise)
        flat = torch.cat(actions, -1).reshape(rows, act_dim)
        flat_np = flat.cpu().numpy()
        new_state = {
            "actions": flat_np,
            "recurrent_state": rec.reshape(rows, rec_size).cpu().numpy(),
            "stochastic_state": stoch.cpu().numpy(),
            "_seed": np.asarray(state["_seed"]),
            "_ctr": np.asarray(state["_ctr"]) + 1,
        }
        return {"flat_actions": flat_np}, new_state

    @torch.inference_mode()
    def init_state_fn(rows: int, seed: int, agent) -> Dict[str, np.ndarray]:
        rec, stoch = agent.world_model.rssm.get_initial_states((int(rows),))
        return {
            "actions": np.zeros((rows, act_dim), np.float32),
            "recurrent_state": rec.reshape(rows, rec_size).float().cpu().numpy(),
            "stochastic_state": stoch.reshape(rows, stoch_flat).float().cpu().numpy(),
            "_seed": row_seeds(rows, seed),
            "_ctr": np.zeros((rows,), np.int64),
        }

    return session_policy_fn, init_state_fn


def agent_params_loader(subtree: str = "agent") -> Callable[[str], Any]:
    """A loader that pulls one subtree out of a validated v1 checkpoint
    (``"world_model"``; ``"agent/actor"`` for a nested one), as numpy."""
    parts = [p for p in str(subtree).split("/") if p]

    def load(path: str) -> Any:
        node = load_checkpoint(path, select=parts[:1] or None)
        for p in parts:
            node = node[p]
        return node

    return load


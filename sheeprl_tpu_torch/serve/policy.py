"""Policy adapters for the servers, and checkpoint loaders.

The port's counterpart of ``sheeprl_tpu/serve/policy.py``:

- the stateless families, PPO (and A2C) and SAC:
  ``policy_fn(module, obs, key, noise=None)`` acts on a zero-padded batch
  of raw observations; the server's integer ``key`` seeds a
  ``torch.Generator`` that draws the batch's noise;
- the session families, recurrent PPO and DreamerV3:
  ``(session_policy_fn, init_state_fn)``.  The JAX adapters ``vmap`` a
  per-row step with a per-row PRNG key; here the step is written for the
  whole batch, and per-row randomness comes from a counter-based hash:
  every row carries a seed (``_seed``) and a step counter (``_ctr``) in its
  session state, and its noise is a function of those two numbers and of
  the element index only.  A row's outputs therefore depend only on its own
  state and observation, never on which other rows share its batch.

Every adapter takes ``noise=`` in place of its own draws, so that the tests
hand both packages the same noise.  The served module is the server's
``params``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

__all__ = [
    "DREAMER_OUT_KEYS",
    "PPO_OUT_KEYS",
    "RPPO_OUT_KEYS",
    "SAC_OUT_KEYS",
    "agent_params_loader",
    "make_dreamer_session_fns",
    "make_ppo_policy_fn",
    "make_recurrent_ppo_session_fns",
    "make_sac_policy_fn",
    "row_gumbel",
    "row_normal",
    "row_seeds",
    "row_uniforms",
]

# reply-array vocabulary, in the order of the local players' return tuples
PPO_OUT_KEYS = ("flat_actions", "real_actions", "logprobs", "values")
SAC_OUT_KEYS = ("actions",)
RPPO_OUT_KEYS = ("flat_actions", "real_actions", "logprobs", "values")
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


def _noise_on(noise, dev) -> list:
    return [(n if isinstance(n, torch.Tensor) else torch.from_numpy(np.array(n, np.float32))).to(dev, torch.float32)
            for n in noise]


def _numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy() for k, v in tensors.items()}


def make_ppo_policy_fn(agent, cnn_keys: Sequence[str], *, greedy: bool = False):
    """``policy_fn(agent, obs, key, noise=None)``: PPO acting on a batch of
    raw observations, the PPO player's output tuple as named arrays
    (:data:`PPO_OUT_KEYS`).  ``noise`` as ``draw_policy_noise`` gives it for
    the rows; else drawn from a generator seeded with ``key``."""
    from sheeprl_tpu_torch.algos.ppo.agent import draw_policy_noise, sample_actions
    from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs

    dev = next(agent.parameters()).device

    @torch.inference_mode()
    def policy_fn(agent, obs: Dict[str, np.ndarray], key, noise=None) -> Dict[str, np.ndarray]:
        rows = int(next(iter(obs.values())).shape[0])
        prepared = prepare_obs(obs, cnn_keys=list(cnn_keys), num_envs=rows, device=dev)
        if noise is not None:
            noise = _noise_on(noise, dev)
        elif not greedy:
            noise = draw_policy_noise(agent, (rows,), torch.Generator(device=dev).manual_seed(int(key)), dev)
        out = sample_actions(agent, prepared, noise, greedy=greedy)
        return _numpy(dict(zip(PPO_OUT_KEYS, out)))

    return policy_fn


def make_sac_policy_fn(actor, mlp_keys: Sequence[str], *, greedy: bool = False):
    """``policy_fn(actor, obs, key, noise=None)``: SAC acting (the actor
    only; critics never serve), ``{"actions": ...}``.  ``noise`` is the
    (rows, action_dim) standard normal of the squashed draw; else drawn
    from a generator seeded with ``key``."""
    from sheeprl_tpu_torch.algos.sac.agent import actor_action_and_log_prob, actor_greedy_action
    from sheeprl_tpu_torch.algos.sac.utils import prepare_obs

    dev = next(actor.parameters()).device

    @torch.inference_mode()
    def policy_fn(actor, obs: Dict[str, np.ndarray], key, noise=None) -> Dict[str, np.ndarray]:
        rows = int(next(iter(obs.values())).shape[0])
        prepared = torch.from_numpy(prepare_obs(obs, mlp_keys=list(mlp_keys), num_envs=rows)).to(dev)
        if greedy:
            return _numpy({SAC_OUT_KEYS[0]: actor_greedy_action(actor, prepared)})
        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(int(key))
            noise = torch.randn((rows, actor.action_dim), generator=gen, device=dev)
        action = actor_action_and_log_prob(actor, prepared, _noise_on([noise], dev)[0])[0]
        return _numpy({SAC_OUT_KEYS[0]: action})

    return policy_fn


def make_recurrent_ppo_session_fns(agent, *, greedy: bool = False):
    """``(session_policy_fn, init_state_fn)`` for recurrent-PPO sessions:
    one acting step (T = 1) of the agent, with (hx, cx, prev_actions, _seed,
    _ctr) kept per session row, and :data:`RPPO_OUT_KEYS` as the reply.

    ``session_policy_fn(agent, obs, state, noise=None)`` steps a batch of
    raw observations; each row's policy noise (a Gumbel draw of every
    discrete head, or one standard normal of the action width) is the
    hash of its own ``_seed`` and ``_ctr`` unless ``noise`` (one (rows,
    width) array a head) is given."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import sample_actions

    hidden = int(agent.rnn_hidden_size)
    dims = list(agent.actions_dim)
    act_dim = int(sum(dims))
    dev = next(agent.parameters()).device

    def _t(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    @torch.inference_mode()
    def session_policy_fn(agent, obs: Dict[str, np.ndarray], state: Dict[str, np.ndarray], noise=None):
        rows = int(state["_seed"].shape[0])
        if noise is not None:
            noise = _noise_on(noise, dev)
        elif not greedy:
            seed, ctr = (torch.as_tensor(np.asarray(state[k]), dtype=torch.int64, device=dev) for k in ("_seed", "_ctr"))
            if agent.is_continuous:
                noise = [row_normal(seed, ctr, 0, act_dim)]
            else:
                noise = list(torch.split(row_gumbel(seed, ctr, 0, act_dim), dims, dim=-1))
        prepared = {k: _t(v).reshape(1, rows, *np.shape(v)[1:]) for k, v in obs.items()}
        flat, real, logprob, value, (hx, cx) = sample_actions(
            agent, prepared, _t(state["prev_actions"])[None], _t(state["hx"]), _t(state["cx"]), noise, greedy=greedy
        )
        flat = flat.reshape(rows, act_dim)
        out = _numpy({"flat_actions": flat, "real_actions": real.reshape(rows, -1),
                      "logprobs": logprob.reshape(rows, -1), "values": value.reshape(rows, -1)})
        new_state = {
            **_numpy({"hx": hx.reshape(rows, hidden), "cx": cx.reshape(rows, hidden), "prev_actions": flat}),
            "_seed": np.asarray(state["_seed"]),
            "_ctr": np.asarray(state["_ctr"]) + 1,
        }
        return out, new_state

    def init_state_fn(rows: int, seed: int, agent) -> Dict[str, np.ndarray]:
        return {
            "hx": np.zeros((rows, hidden), np.float32),
            "cx": np.zeros((rows, hidden), np.float32),
            "prev_actions": np.zeros((rows, act_dim), np.float32),
            "_seed": row_seeds(rows, seed),
            "_ctr": np.zeros((rows,), np.int64),
        }

    return session_policy_fn, init_state_fn


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


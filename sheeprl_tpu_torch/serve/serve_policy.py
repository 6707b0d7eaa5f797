"""Standalone policy serving on the port.

The port's counterpart of ``scripts/serve_policy.py``.  A checkpoint's run
config names the family (``family_of``, as ``scripts/serve_policy.py:94-104``):

- ``ppo`` (PPO and A2C) and ``sac`` (SAC and DroQ) get the stateless
  :class:`~sheeprl_tpu_torch.serve.service.InferenceServer`
  (``build_ppo_server``, ``build_sac_server``);
- ``ppo_recurrent`` and ``dreamer_v3`` get the session tier
  (``build_recurrent_ppo_server``, ``build_dreamer_server``): clients speak
  the session protocol, because a recurrent policy served statelessly is
  meaningless.

``load_run`` reads a checkpoint and the run's ``config.yaml``: the
player's ``{"world_model", "actor"}`` for DreamerV3, ``"agent"`` for PPO
and recurrent PPO, ``"agent/actor"`` for SAC.  ``run_selftest`` drives a
server with in-process clients.  Run it on a checkpoint with::

    python -m sheeprl_tpu_torch.serve.serve_policy --checkpoint <ckpt> --selftest 4

The server runs on ``cuda`` unless ``--device cpu`` is given.  Outside
DreamerV3 the spaces come from the run's device env (``env.id`` a ``jax_*``
id); a gymnasium env's waits for ROADMAP A2.  The TCP listener and the
checkpoint hot-swap are still to be ported.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import namedtuple
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_player
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.parallel.transport import make_transport
from sheeprl_tpu_torch.serve.client import InferenceClient
from sheeprl_tpu_torch.serve.policy import (
    agent_params_loader,
    make_dreamer_session_fns,
    make_ppo_policy_fn,
    make_recurrent_ppo_session_fns,
    make_sac_policy_fn,
)
from sheeprl_tpu_torch.serve.service import InferenceServer
from sheeprl_tpu_torch.serve.sessions import SessionClient, SessionInferenceServer, build_server
from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
from sheeprl_tpu_torch.utils.convert import load_flax_params, load_group_params

__all__ = [
    "FAMILY_LOADERS",
    "ObsSpec",
    "build_dreamer_server",
    "build_ppo_server",
    "build_recurrent_ppo_server",
    "build_sac_server",
    "device_env_spaces",
    "family_of",
    "load_run",
    "main",
    "run_selftest",
    "spaces_from_params",
]

#: the checkpoint subtree each family serves (``agent_params_loader``'s spelling)
FAMILY_LOADERS = {"ppo": "agent", "ppo_recurrent": "agent", "sac": "agent/actor"}

ObsSpec = namedtuple("ObsSpec", ["shape", "dtype"])


def _run_cfg_path(ckpt_path: str) -> str:
    """``<run>/config.yaml`` two levels above the checkpoint, else next to it."""
    ckpt = os.path.abspath(ckpt_path)
    for cand in (
        os.path.join(os.path.dirname(os.path.dirname(ckpt)), "config.yaml"),
        os.path.join(os.path.dirname(ckpt), "config.yaml"),
    ):
        if os.path.exists(cand):
            return cand
    raise RuntimeError(f"Cannot find the run config next to the checkpoint {ckpt_path}")


def family_of(cfg) -> str:
    """The serving family of a run's ``algo.name``."""
    algo = str(cfg.algo.name)
    for prefixes, family in ((("ppo_recurrent",), "ppo_recurrent"), (("dreamer_v3",), "dreamer_v3"),
                             (("ppo", "a2c"), "ppo"), (("sac", "droq"), "sac")):
        if algo.startswith(prefixes):
            return family
    raise ValueError(f"serve_policy supports the PPO/SAC/recurrent-PPO/Dreamer-v3 families, got algo={algo!r}")


def load_run(ckpt_path: str) -> Tuple[dotdict, Dict[str, Any]]:
    """``(cfg, params)``: the run's config and the parameter tree its family
    serves, as numpy arrays, from a v1 checkpoint (written by either
    package): the player's ``{"world_model": ..., "actor": ...}`` for
    DreamerV3, else the subtree of :data:`FAMILY_LOADERS`."""
    from sheeprl_tpu_torch.config.compose import yaml_load

    with open(_run_cfg_path(ckpt_path)) as f:
        cfg = dotdict(yaml_load(f.read()))
    family = family_of(cfg)
    if family != "dreamer_v3":
        return cfg, agent_params_loader(FAMILY_LOADERS[family])(ckpt_path)
    state = load_checkpoint(ckpt_path, select=("world_model", "actor"))
    return cfg, {"world_model": state["world_model"], "actor": state["actor"]}


def device_env_spaces(cfg):
    """``(observation_space, action_space)`` of the run's device env; the
    spaces of a gymnasium env wait for ROADMAP A2."""
    from sheeprl_tpu_torch.envs.device import is_device_env_id
    from sheeprl_tpu_torch.utils.env import make_device_env_from_cfg

    if not is_device_env_id(cfg.env.id):
        raise NotImplementedError(
            f"serving a {cfg.algo.name} policy of env.id={cfg.env.id!r} needs its gymnasium env's spaces, "
            "which wait for ROADMAP A2; the port reads the spaces of its device envs (jax_*)"
        )
    env = make_device_env_from_cfg(cfg)
    return env.observation_space, env.action_space


def _runtime(cfg, device) -> MeshRuntime:
    fabric = cfg.get("fabric", {}) or {}
    return MeshRuntime(precision=fabric.get("precision", "32-true"), seed=int(cfg.get("seed", 0)), device=device).launch()


def _stateless_server(policy_fn, module, cfg, deadline_ms: float, max_batch: int) -> InferenceServer:
    server = InferenceServer(policy_fn, module, deadline_ms=deadline_ms, max_batch=max_batch,
                             seed=int(cfg.get("seed", 0)), name=str(cfg.algo.name))
    server.policy_fn = policy_fn
    return server


def build_ppo_server(cfg, params: Optional[Dict[str, Any]], obs_space, actions_dim: Sequence[int], *,
                     is_continuous: bool = False, device=None, greedy: bool = True, deadline_ms: float = 5.0,
                     max_batch: int = 64):
    """A ready (not yet started) stateless PPO/A2C server and the
    observation keys its requests carry.  ``params`` is the JAX package's
    ``"agent"`` tree, or None for weights drawn from the torch RNG seeded
    with ``cfg.seed``.  Runs on ``device`` (``cuda`` when None)."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent

    agent = build_agent(_runtime(cfg, device), actions_dim, is_continuous, cfg, obs_space, params)
    policy_fn = make_ppo_policy_fn(agent, list(cfg.algo.cnn_keys.encoder), greedy=greedy)
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    return _stateless_server(policy_fn, agent, cfg, deadline_ms, max_batch), obs_keys


def build_sac_server(cfg, actor_params: Optional[Dict[str, Any]], obs_space, action_space, *, device=None,
                     greedy: bool = True, deadline_ms: float = 5.0, max_batch: int = 64):
    """A ready stateless SAC server over the actor alone, and its
    observation keys.  ``actor_params`` is the checkpoint's
    ``"agent/actor"`` tree (or None); ``action_space`` gives the bounds."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent

    actor = build_agent(_runtime(cfg, device), cfg, obs_space, action_space)[0].actor
    if actor_params is not None:
        load_group_params(actor, actor_params, "actor")
    policy_fn = make_sac_policy_fn(actor, list(cfg.algo.mlp_keys.encoder), greedy=greedy)
    return _stateless_server(policy_fn, actor, cfg, deadline_ms, max_batch), list(cfg.algo.mlp_keys.encoder)


def build_recurrent_ppo_server(cfg, params: Optional[Dict[str, Any]], obs_space, actions_dim: Sequence[int], *,
                               is_continuous: bool = False, device=None, greedy: bool = True, deadline_ms: float = 5.0,
                               max_batch: int = 64, session_capacity: int = 1024, session_ttl_s: float = 300.0):
    """A ready recurrent-PPO session server (``hx``, ``cx`` and the previous
    actions kept per session) and its observation keys; ``params`` as for
    :func:`build_ppo_server`."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent

    agent = build_agent(_runtime(cfg, device), actions_dim, is_continuous, cfg, obs_space, params)
    session_fn, init_fn = make_recurrent_ppo_session_fns(agent, greedy=greedy)
    server = build_server(
        None,
        agent,
        session={"enabled": True, "capacity": int(session_capacity), "idle_ttl_s": float(session_ttl_s)},
        session_policy_fn=session_fn,
        init_state_fn=init_fn,
        deadline_ms=deadline_ms,
        max_batch=max_batch,
        seed=int(cfg.get("seed", 0)),
        name=str(cfg.algo.name),
    )
    server.session_fn, server.init_fn = session_fn, init_fn
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    return server, obs_keys


def spaces_from_params(cfg, params: Dict[str, Any], *, continuous: bool = False):
    """``(obs_space, actions_dim)`` read off the run config and the weights:
    image keys are (screen, screen, 1 or 3) float32, the vector keys share
    the MLP encoder's input width (one key), and the actor's heads give
    the action sizes (one head of 2*n outputs for continuous actions)."""
    space: Dict[str, ObsSpec] = {}
    channels = 1 if cfg.env.get("grayscale", False) else 3
    for k in cfg.algo.cnn_keys.encoder:
        space[k] = ObsSpec((int(cfg.env.screen_size), int(cfg.env.screen_size), channels), np.float32)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    if len(mlp_keys) > 1:
        raise ValueError(f"cannot split the MLP encoder's input width over {mlp_keys}")
    if mlp_keys:
        enc = params["world_model"]["encoder"]["params"]["mlp_encoder"]["DreamerMLP_0"]
        space[mlp_keys[0]] = ObsSpec((int(enc["LinearLnAct_0"]["Dense_0"]["kernel"].shape[0]),), np.float32)
    actor = params["actor"]["params"]
    heads = sorted((k for k in actor if k.startswith("Dense_")), key=lambda k: int(k.split("_")[1]))
    outs = [int(actor[h]["kernel"].shape[1]) for h in heads]
    actions_dim = (outs[0] // 2,) if continuous else tuple(outs)
    return space, actions_dim


def build_dreamer_server(
    cfg,
    params: Optional[Dict[str, Any]],
    obs_space,
    actions_dim: Sequence[int],
    *,
    is_continuous: bool = False,
    device=None,
    greedy: bool = True,
    deadline_ms: float = 5.0,
    max_batch: int = 64,
    session_capacity: int = 1024,
    session_ttl_s: float = 300.0,
):
    """A ready (not yet started) DreamerV3 session server and the
    observation keys its requests carry.

    ``params`` is the JAX player tree (converted with ``flax_to_torch``)
    or None for weights drawn from the torch RNG seeded with ``cfg.seed``.
    ``obs_space`` maps each key to anything with a ``shape``.  The server
    runs on ``device`` (``cuda`` when None; raises without a card)."""
    runtime = _runtime(cfg, device)
    agent = build_player(runtime, actions_dim, is_continuous, cfg, obs_space)
    if params is not None:
        load_flax_params(agent, params)
    wm_cfg = cfg.algo.world_model
    session_fn, init_fn = make_dreamer_session_fns(
        agent,
        actions_dim=actions_dim,
        stochastic_size=int(wm_cfg.stochastic_size),
        discrete_size=int(wm_cfg.discrete_size),
        recurrent_state_size=int(wm_cfg.recurrent_model.recurrent_state_size),
        decoupled_rssm=bool(wm_cfg.get("decoupled_rssm", False)),
        greedy=greedy,
        device=runtime.device,
    )
    server = build_server(
        None,
        agent,
        session={"enabled": True, "capacity": int(session_capacity), "idle_ttl_s": float(session_ttl_s)},
        session_policy_fn=session_fn,
        init_state_fn=init_fn,
        deadline_ms=deadline_ms,
        max_batch=max_batch,
        seed=int(cfg.get("seed", 0)),
        name=str(cfg.algo.get("name", "dreamer_v3")),
    )
    server.session_fn, server.init_fn = session_fn, init_fn
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    return server, obs_keys


def run_selftest(
    server,
    obs_keys: Sequence[str],
    obs_space,
    n_clients: int,
    n_requests: int,
    *,
    rows: Any = 1,
    close_sessions: bool = True,
) -> Dict[str, Any]:
    """Drive ``server`` with ``n_clients`` in-process clients over queue
    channels, ``n_requests`` requests each: session clients (steps) for a
    session server, stateless ones otherwise.  ``rows`` is the rows per
    request (an int, or one per client).  Observations are seeded normals
    (client ``i`` draws from seed ``i``).  Returns the server's stats with a
    ``selftest`` summary, each client's ``log`` (observations and replies
    per request) and ``session_ids``.  The server is closed at the end; with
    ``close_sessions=False`` the clients leave their sessions open, so the
    caller can read their state from ``server.sessions``."""
    per_client = [int(rows)] * n_clients if np.isscalar(rows) else [int(r) for r in rows]
    sessions = isinstance(server, SessionInferenceServer)
    hub, specs = make_transport(n_clients, window=4)
    if sessions:
        clients = [SessionClient(specs[i].player_channel(), i, seed=i, request_timeout_s=60.0) for i in range(n_clients)]
    else:
        clients = [InferenceClient(specs[i].player_channel(), i, request_timeout_s=60.0) for i in range(n_clients)]
    for i in range(n_clients):
        server.attach(i, hub.channel(i))
    server.start()
    failures: List[int] = []
    logs: List[List[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]] = [[] for _ in range(n_clients)]

    def drive(cid: int) -> None:
        rng = np.random.default_rng(cid)
        for _ in range(n_requests):
            obs = {
                k: rng.normal(size=(per_client[cid],) + tuple(obs_space[k].shape)).astype(np.float32)
                for k in obs_keys
            }
            send = clients[cid].step if sessions else clients[cid].infer
            out, src = send(list(obs.items()), per_client[cid])
            if src != "remote" or out is None:
                failures.append(cid)
                return
            logs[cid].append((obs, out))
        if sessions and close_sessions:
            clients[cid].close_session()

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    stats = server.stats()
    stats["selftest"] = {
        "clients": n_clients,
        "requests_per_client": n_requests,
        "rows_per_request": per_client,
        "wall_s": wall,
        "rows_per_s": sum(per_client) * n_requests / wall,
        "failures": len(failures),
        "dead_reason": server.dead_reason,
        "client_latency_ms": [c.stats()["latency_ms"] for c in clients],
    }
    server.close()
    hub.close()
    return dict(stats, log=logs, session_ids=[getattr(c, "session_id", None) for c in clients])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True, help="ckpt_*.ckpt (sheeprl_tpu_ckpt_v1) to serve")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deadline-ms", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--sample", action="store_true", help="sample actions instead of greedy")
    ap.add_argument("--continuous", action="store_true", help="the actor has a continuous head")
    ap.add_argument("--session-capacity", type=int, default=1024)
    ap.add_argument("--session-ttl", type=float, default=300.0)
    ap.add_argument("--selftest", type=int, default=0, metavar="N", help="drive with N in-process clients and exit")
    ap.add_argument("--selftest-requests", type=int, default=64)
    ap.add_argument("--selftest-rows", type=int, default=1, help="rows per selftest request")
    args = ap.parse_args(argv)
    if args.selftest <= 0:
        ap.error("only --selftest N is ported so far (the TCP listener is not)")
    cfg, params = load_run(args.checkpoint)
    family = family_of(cfg)
    common = {"device": args.device, "greedy": not args.sample, "deadline_ms": args.deadline_ms,
              "max_batch": args.max_batch}
    sessions = {"session_capacity": args.session_capacity, "session_ttl_s": args.session_ttl}
    if family == "dreamer_v3":
        obs_space, actions_dim = spaces_from_params(cfg, params, continuous=args.continuous)
        server, obs_keys = build_dreamer_server(cfg, params, obs_space, actions_dim, is_continuous=args.continuous,
                                                **common, **sessions)
    else:
        obs_space, action_space = device_env_spaces(cfg)
        if family == "sac":
            server, obs_keys = build_sac_server(cfg, params, obs_space, action_space, **common)
        else:
            from sheeprl_tpu_torch.envs.spaces import action_space_dims

            actions_dim, cont = action_space_dims(action_space)
            if family == "ppo":
                server, obs_keys = build_ppo_server(cfg, params, obs_space, actions_dim, is_continuous=cont, **common)
            else:
                server, obs_keys = build_recurrent_ppo_server(cfg, params, obs_space, actions_dim, is_continuous=cont,
                                                              **common, **sessions)
    res = run_selftest(
        server, obs_keys, obs_space, args.selftest, args.selftest_requests, rows=args.selftest_rows
    )
    print(json.dumps({k: v for k, v in res.items() if k != "log"}, default=str))
    return 1 if res["selftest"]["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

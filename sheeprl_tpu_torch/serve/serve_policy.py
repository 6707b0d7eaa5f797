"""Standalone DreamerV3 session serving on the port.

The port's counterpart of ``scripts/serve_policy.py`` for the DreamerV3
family.  ``load_run`` reads a JAX-package checkpoint and the run's
``config.yaml``; ``build_dreamer_server`` builds the session server around
the port's player modules; ``run_selftest`` drives it with in-process
clients.  Run it on a checkpoint with::

    python -m sheeprl_tpu_torch.serve.serve_policy --checkpoint <ckpt> --selftest 4

The server runs on ``cuda`` unless ``--device cpu`` is given.  The TCP
listener and the checkpoint hot-swap are still to be ported.
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

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
from sheeprl_tpu_torch.parallel.transport import make_transport
from sheeprl_tpu_torch.serve.policy import make_dreamer_session_fns
from sheeprl_tpu_torch.serve.sessions import SessionClient, build_server
from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
from sheeprl_tpu_torch.utils.convert import load_flax_params

__all__ = ["ObsSpec", "build_dreamer_server", "load_run", "main", "run_selftest", "spaces_from_params"]

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


def load_run(ckpt_path: str) -> Tuple[dotdict, Dict[str, Any]]:
    """``(cfg, params)``: the run's config and the player's parameter tree
    ``{"world_model": ..., "actor": ...}`` as numpy arrays, from a v1
    checkpoint written by the JAX package."""
    from sheeprl_tpu_torch.config.compose import yaml_load

    with open(_run_cfg_path(ckpt_path)) as f:
        cfg = dotdict(yaml_load(f.read()))
    state = load_checkpoint(ckpt_path, select=("world_model", "actor"))
    return cfg, {"world_model": state["world_model"], "actor": state["actor"]}


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
    fabric = cfg.get("fabric", {}) or {}
    runtime = MeshRuntime(precision=fabric.get("precision", "32-true"), seed=int(cfg.get("seed", 0)), device=device)
    runtime.launch()
    agent = build_agent(runtime, actions_dim, is_continuous, cfg, obs_space)
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
    """Drive ``server`` with ``n_clients`` in-process session clients over
    queue channels, ``n_requests`` steps each.  ``rows`` is the rows per
    request (an int, or one per client).  Observations are seeded normals
    (client ``i`` draws from seed ``i``).  Returns the server's stats with a
    ``selftest`` summary, each client's ``log`` (observations and replies
    per step) and ``session_ids``.  The server is closed at the end; with
    ``close_sessions=False`` the clients leave their sessions open, so the
    caller can read their state from ``server.sessions``."""
    per_client = [int(rows)] * n_clients if np.isscalar(rows) else [int(r) for r in rows]
    hub, specs = make_transport(n_clients, window=4)
    clients = [SessionClient(specs[i].player_channel(), i, seed=i, request_timeout_s=60.0) for i in range(n_clients)]
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
            out, src = clients[cid].step(list(obs.items()), per_client[cid])
            if src != "remote" or out is None:
                failures.append(cid)
                return
            logs[cid].append((obs, out))
        if close_sessions:
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
    return dict(stats, log=logs, session_ids=[c.session_id for c in clients])


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
    if not str(cfg.algo.name).startswith("dreamer_v3"):
        ap.error(f"the port serves the DreamerV3 family, got algo={cfg.algo.name!r}")
    obs_space, actions_dim = spaces_from_params(cfg, params, continuous=args.continuous)
    server, obs_keys = build_dreamer_server(
        cfg,
        params,
        obs_space,
        actions_dim,
        is_continuous=args.continuous,
        device=args.device,
        greedy=not args.sample,
        deadline_ms=args.deadline_ms,
        max_batch=args.max_batch,
        session_capacity=args.session_capacity,
        session_ttl_s=args.session_ttl,
    )
    res = run_selftest(
        server, obs_keys, obs_space, args.selftest, args.selftest_requests, rows=args.selftest_rows
    )
    print(json.dumps({k: v for k, v in res.items() if k != "log"}, default=str))
    return 1 if res["selftest"]["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sheeprl_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``sheeprl_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes the serving path
gives it, serves DreamerV3-XL sessions (Crafter observations, 17 actions,
random weights drawn from a seed) through the port's session server, replays
the served sessions through the plain version, and prints one line per phase.
The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero; without a CUDA device it exits 2 and prints no result.

``python3 chip_smoke.py --profile [STEPS]`` instead measures the serving step
at DV3-XL: a ``torch.profiler`` window over STEPS 64-row session steps
(device time by kernel, the device's idle share, a chrome trace in
``chiprun_out/serve_trace.json``) and a longer selftest for rows/s and
latency.  It checks nothing and prints no ``ok`` line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# The DreamerV3-XL Crafter configuration, as the port composes it from
# `exp=dreamer_v3_XL_crafter algo.world_model.recurrent_model.fused=True`
# (a CPU test pins the two together): the sizes build_agent reads.
_LN = {"cls": "LayerNorm", "kw": {"eps": 0.001}}
XL_CRAFTER = {
    "seed": 5,
    "env": {"screen_size": 64, "grayscale": False},
    "fabric": {"precision": "32-true"},
    "distribution": {"type": "auto"},
    "algo": {
        "name": "dreamer_v3",
        "unimix": 0.01,
        "cnn_keys": {"encoder": ["rgb"]},
        "mlp_keys": {"encoder": ["reward"]},
        "world_model": {
            "stochastic_size": 32,
            "discrete_size": 32,
            "decoupled_rssm": False,
            "learnable_initial_recurrent_state": True,
            "encoder": {
                "cnn_channels_multiplier": 96,
                "mlp_layers": 5,
                "dense_units": 1024,
                "cnn_layer_norm": {"cls": "LayerNormChannelLast", "kw": {"eps": 0.001}},
                "mlp_layer_norm": _LN,
            },
            "recurrent_model": {"recurrent_state_size": 4096, "dense_units": 1024, "layer_norm": _LN, "fused": True},
            "transition_model": {"hidden_size": 1024},
        },
        "actor": {
            "init_std": 2.0,
            "min_std": 0.1,
            "max_std": 1.0,
            "dense_units": 1024,
            "mlp_layers": 5,
            "layer_norm": _LN,
            "action_clip": 1.0,
        },
    },
}
CRAFTER_OBS = {"rgb": (64, 64, 3), "reward": (1,)}
CRAFTER_ACTIONS = (17,)

# H100 SXM (NVIDIA data sheet, dense): HBM3 rate, FP32 outside the tensor
# cores, bf16 tensor cores.  The power limit printed beside the numbers says
# whether the card ran at the 700 W these rates assume.
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# kernel vs plain version: only the summation order differs (K = 5120
# products summed before a LayerNorm), so f32 agrees to a few ulps of the
# normalised parts; bf16 operands are rounded identically on both sides.
TOL = {"float32": 2e-5, "bfloat16": 2e-3}
STATE_TOL = 1e-4  # recurrent state, served (kernel) vs replayed (plain), after all steps


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + json.dumps(fields, default=str), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gru_bound_ms(batch: int, hidden: int, xdim: int, wdtype: str) -> tuple:
    """Least time for one step: every input read once and the output
    written once at the memory rate, against the product's 2*B*K*3H
    operations at the operand type's peak plus ~12 f32 operations per
    element of the (B, 3H) LayerNorm and gates."""
    k, n = hidden + xdim, 3 * hidden
    wsize = 4 if wdtype == "float32" else 2
    nbytes = 4 * batch * hidden + 4 * batch * xdim + wsize * k * n + 8 * n + 4 * batch * hidden
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = (2 * batch * k * n / PEAK_FLOPS[wdtype] + 12 * batch * n / PEAK_FLOPS["float32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gru_kernel(torch, gru_cell, gru_cell_plain) -> list:
    """The kernel against its plain version at the XL widths the serving
    path gives it (H=4096, X=1024), B in {1, 7, 64}, f32 and bf16 W."""
    hidden, xdim = 4096, 1024
    g = torch.Generator(device="cuda").manual_seed(0)
    w32 = torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5
    gamma = 1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    beta = 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    rows = []
    for wdtype in ("float32", "bfloat16"):
        w = w32 if wdtype == "float32" else w32.to(torch.bfloat16)
        for batch in (1, 7, 64):
            h = torch.tanh(torch.randn(batch, hidden, device="cuda", generator=g))
            x = torch.randn(batch, xdim, device="cuda", generator=g)
            err = 0.0
            for two_pass in (True, False):
                out = gru_cell(h, x, w, gamma, beta, two_pass=two_pass)
                ref = gru_cell_plain(h, x, w, gamma, beta, two_pass=two_pass)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"gru_cell B={batch} {wdtype}: non-finite output")
                err = max(err, float((out - ref).abs().max()))
            if err > TOL[wdtype]:
                raise AssertionError(f"gru_cell B={batch} {wdtype}: max abs err {err} > {TOL[wdtype]}")
            inp = torch.cat([h, x], -1).to(w.dtype)
            bound, bound_by = gru_bound_ms(batch, hidden, xdim, wdtype)
            row = {
                "batch": batch,
                "wdtype": wdtype,
                "max_abs_err": err,
                "tol": TOL[wdtype],
                "ms": time_ms(torch, lambda: gru_cell(h, x, w, gamma, beta)),
                "plain_ms": time_ms(torch, lambda: gru_cell_plain(h, x, w, gamma, beta)),
                "library_ms": time_ms(torch, lambda: torch.matmul(inp, w)),
                "bound_ms": bound,
                "bound_by": bound_by,
            }
            phase("gru_cell", **row)
            rows.append(row)
    del w32
    return rows


def serve_sessions(cfg, obs_shapes, actions_dim, device, *, steps: int = 3) -> dict:
    """The serving phase: build the session server with
    ``build_dreamer_server``, warm it at the buckets it will use, then run
    the selftest twice through the port's server: 4 clients x 16 rows (the
    64-row bucket) and, on a second server over the same module, 2 clients
    of 1 and 2 rows (small buckets).  The GRU launch counter is set to 0
    just before the served runs.  Raises unless every request was answered
    remote and a batch filled 64 rows."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.ops.gru_cell import gru_cell
    from sheeprl_tpu_torch.serve.serve_policy import ObsSpec, build_dreamer_server, run_selftest
    from sheeprl_tpu_torch.serve.sessions import build_server

    space = {k: ObsSpec(tuple(s), np.float32) for k, s in obs_shapes.items()}
    server, obs_keys = build_dreamer_server(cfg, None, space, actions_dim, device=device, deadline_ms=50.0, max_batch=64)
    agent, session_fn, init_fn = server.params, server.session_fn, server.init_fn
    for rows in (64, 4, 2):  # warm the libraries at the buckets served below
        session_fn(agent, {k: np.zeros((rows,) + tuple(s), np.float32) for k, s in obs_shapes.items()}, init_fn(rows, 99, agent))
    small = build_server(
        None, agent, session={"enabled": True}, session_policy_fn=session_fn, init_state_fn=init_fn,
        deadline_ms=50.0, max_batch=64,
    )
    if device != "cpu":
        torch.cuda.synchronize()
    gru_cell.launches = 0
    big = run_selftest(server, obs_keys, space, 4, steps, rows=16, close_sessions=False)
    little = run_selftest(small, obs_keys, space, 2, steps, rows=[1, 2], close_sessions=False)
    if device != "cpu":
        torch.cuda.synchronize()
    for res in (big, little):
        st = res["selftest"]
        if st["failures"] or st["dead_reason"]:
            raise AssertionError(f"serving failed: {st}")
        if res["acted"] != st["clients"] * st["requests_per_client"]:
            raise AssertionError(f"not every request was answered remote: {st}")
    if big["rows_hist"].get("64", 0) < 1:
        raise AssertionError(f"no batch filled the 64-row bucket: {big['rows_hist']}")
    return {
        "bucket64": big, "small": little, "servers": (server, small), "agent": agent,
        "session_fn": session_fn, "init_fn": init_fn, "obs_keys": obs_keys,
        "batches": server.batches + small.batches,
    }


def replay_plain(served: dict) -> float:
    """Replay every served session alone through the plain GRU version on
    the same device, with the same observations and the same per-row noise:
    the greedy actions must be identical at every step and the final
    recurrent states agree to ``STATE_TOL``.  Returns the largest state
    difference."""
    import numpy as np

    from sheeprl_tpu_torch.ops.gru_cell import gru_cell, gru_cell_plain

    agent, session_fn, init_fn = served["agent"], served["session_fn"], served["init_fn"]
    cell = agent.world_model.rssm.recurrent_model.gru
    cell.impl = gru_cell_plain
    worst = 0.0
    try:
        for srv, res in zip(served["servers"], (served["bucket64"], served["small"])):
            for cid, log in enumerate(res["log"]):
                rows = log[0][0][served["obs_keys"][0]].shape[0]
                st = init_fn(rows, cid, agent)
                for t, (obs, reply) in enumerate(log):
                    out, st = session_fn(agent, obs, st)
                    if not np.array_equal(out["flat_actions"].argmax(-1), reply["flat_actions"].argmax(-1)):
                        raise AssertionError(f"client {cid} step {t}: greedy actions differ from the plain replay")
                final = srv.sessions.lookup(res["session_ids"][cid]).state["recurrent_state"]
                if not np.isfinite(final).all():
                    raise AssertionError(f"client {cid}: non-finite served recurrent state")
                worst = max(worst, float(np.abs(final - st["recurrent_state"]).max()))
    finally:
        cell.impl = gru_cell
    if worst > STATE_TOL:
        raise AssertionError(f"served vs plain recurrent state differ by {worst} > {STATE_TOL}")
    return worst


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "gru_" in n:
        return "gru_cell (hand-written)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "conv" in n or "implicit" in n or "winograd" in n or "fft" in n:
        return "convolutions (cuDNN)"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n:
        return "matmuls (cuBLAS)"
    return "elementwise/reductions"


def profile_serving(steps: int) -> dict:
    """Where a 64-row DV3-XL session step spends its time, and the
    selftest's rows/s and latency over more steps than the smoke runs."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.config import dotdict
    from sheeprl_tpu_torch.serve.serve_policy import ObsSpec, build_dreamer_server, run_selftest

    space = {k: ObsSpec(s, np.float32) for k, s in CRAFTER_OBS.items()}
    server, keys = build_dreamer_server(dotdict(XL_CRAFTER), None, space, CRAFTER_ACTIONS, device="cuda", deadline_ms=50.0)
    agent, session_fn, init_fn = server.params, server.session_fn, server.init_fn
    rng = np.random.default_rng(0)
    obs = {k: rng.normal(size=(64,) + s).astype(np.float32) for k, s in CRAFTER_OBS.items()}
    st = init_fn(64, 0, agent)
    for _ in range(3):
        _, st = session_fn(agent, obs, st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, st = session_fn(agent, obs, st)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _, st = session_fn(agent, obs, st)
        torch.cuda.synchronize()
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", "serve_trace.json"))
    kernels, groups = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        kernels[ev.key] = kernels.get(ev.key, 0.0) + t / 1e3 / steps
    for name, ms in kernels.items():
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    res = {
        "rows": 64,
        "step_ms": step_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / step_ms),
        "groups_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [[k[:90], v] for k, v in top],
    }
    phase("profile_step", **res)
    big = run_selftest(server, keys, space, 4, steps, rows=16)
    one = build_dreamer_server(dotdict(XL_CRAFTER), None, space, CRAFTER_ACTIONS, device="cuda", deadline_ms=5.0)[0]
    single = run_selftest(one, keys, space, 1, steps, rows=1)
    for label, r in (("4x16", big), ("1x1", single)):
        phase(
            "profile_selftest", clients_x_rows=label, rows_per_s=r["selftest"]["rows_per_s"],
            latency_ms=r["latency_ms"], busy_ms_per_batch=1e3 * r["busy_s"] / max(1, r["batches"]),
            rows_hist=r["rows_hist"], failures=r["selftest"]["failures"],
        )
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.config import dotdict
    from sheeprl_tpu_torch.ops.gru_cell import build_library, gru_cell, gru_cell_plain

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    phase("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    build_library()
    ptxas = [ln.strip() for ln in build_library.log.splitlines() if "registers" in ln or "spill" in ln]
    phase("build", seconds=time.perf_counter() - t0, nvcc_seconds=build_library.seconds, ptxas=ptxas)

    if "--profile" in sys.argv:
        i = sys.argv.index("--profile")
        steps = int(sys.argv[i + 1]) if len(sys.argv) > i + 1 else 20
        profile_serving(steps)
        print(smi, flush=True)
        return 0

    # 3. kernel against plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gru_rows = check_gru_kernel(torch, gru_cell, gru_cell_plain)

    # 4. serving: DV3-XL sessions through the port's server
    gru_cell.launches = 0  # set again inside, just before the served run
    served = serve_sessions(dotdict(XL_CRAFTER), CRAFTER_OBS, CRAFTER_ACTIONS, "cuda")
    launches = gru_cell.launches
    if launches != served["batches"] or launches == 0:
        raise AssertionError(f"gru_cell launched {launches} times for {served['batches']} session batches")
    for label in ("bucket64", "small"):
        res = served[label]
        st = res["selftest"]
        phase(
            "serving", run=label, rows_per_s=st["rows_per_s"], wall_s=st["wall_s"],
            batches=res["batches"], batch_hist=res["batch_hist"], rows_hist=res["rows_hist"],
            latency_ms=res["latency_ms"], busy_ms_per_batch=1e3 * res["busy_s"] / max(1, res["batches"]),
        )
    phase("serving_kernel_launches", gru_cell=launches, session_batches=served["batches"])

    # 5. serving against plain
    worst = replay_plain(served)
    phase("serving_vs_plain", max_abs_state_err=worst, tol=STATE_TOL, actions="identical")

    # 6. purity
    bad = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")
    )
    if bad:
        raise AssertionError(f"the port imported JAX-side modules: {bad[:5]}")
    phase("purity", jax_modules=0)

    main_row = next(r for r in gru_rows if r["batch"] == 64 and r["wdtype"] == "float32")
    kernels = [
        {
            "name": "gru_cell",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/gru_cell.cu",
            "replaces": "sheeprl_tpu/ops/pallas_gru.py:134",
            "launches": launches,
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        }
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sheeprl_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``sheeprl_tpu_torch/csrc``
(one ``nvcc`` per source, side by side), holds each against its plain
PyTorch version at the shapes the serving and training paths give it, and
drives both paths at DreamerV3-XL width (Crafter observations, 17 actions,
random weights drawn from a seed):

- serving: DV3-XL sessions through the port's session server, replayed
  through the plain version;
- training: ``train_steps`` on a replay window filled with seeded,
  Crafter-shaped transitions (host buffer, then the device cache), three
  gradient steps with the fused GRU kernel and the window-gather kernel,
  then the same steps from the same state with the plain GRU and
  ``buffer.per_kernel=lax``.

It prints one line per phase.  The line before the last is a JSON object
with each kernel's numbers; the last line is ``{"ok": true, "device":
{...}}``.  Any failure raises and the script exits non-zero; without a CUDA
device it exits 2 and prints no result.

``python3 chip_smoke.py --profile [STEPS]`` instead measures the serving step
at DV3-XL: a ``torch.profiler`` window over STEPS 64-row session steps
(device time by kernel, the device's idle share, a chrome trace in
``chiprun_out/serve_trace.json``) and a longer selftest for rows/s and
latency.  ``--profile-train [STEPS]`` prints the same breakdown for the XL
train step (no trace: a train step's is too large to bring back).  Neither
checks anything or prints an ``ok`` line.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import threading
import time

# The DreamerV3-XL Crafter configuration, as the port composes it from
# `exp=dreamer_v3_XL_crafter algo.world_model.recurrent_model.fused=True
# buffer.device_cache=True buffer.per_kernel=pallas buffer.memmap=False`
# (a CPU test pins the two together): the keys build_agent and the train
# step read.  The card's machine has no YAML parser, hence a dict.
_LN = {"cls": "LayerNorm", "kw": {"eps": 0.001}}
_CNN_LN = {"cls": "LayerNormChannelLast", "kw": {"eps": 0.001}}


def _adam(lr: float, eps: float) -> dict:
    return {"_target_": "optax.adam", "learning_rate": lr, "eps": eps, "b1": 0.9, "b2": 0.999, "weight_decay": 0.0}


def _mlp(**extra) -> dict:
    return {"mlp_layers": 5, "dense_units": 1024, "layer_norm": _LN, **extra}

XL_CRAFTER = {
    "seed": 5,
    "env": {"screen_size": 64, "grayscale": False},
    "fabric": {"precision": "32-true"},
    "distribution": {"type": "auto"},
    "algo": {
        "name": "dreamer_v3",
        "unimix": 0.01,
        "horizon": 15,
        "gamma": 0.996996996996997,
        "lmbda": 0.95,
        "per_rank_batch_size": 16,
        "per_rank_sequence_length": 64,
        "cnn_keys": {"encoder": ["rgb"], "decoder": ["rgb"]},
        "mlp_keys": {"encoder": ["reward"], "decoder": []},
        "world_model": {
            "stochastic_size": 32,
            "discrete_size": 32,
            "decoupled_rssm": False,
            "learnable_initial_recurrent_state": True,
            "kl_dynamic": 0.5,
            "kl_representation": 0.1,
            "kl_free_nats": 1.0,
            "kl_regularizer": 1.0,
            "continue_scale_factor": 1.0,
            "clip_gradients": 1000.0,
            "optimizer": _adam(1e-4, 1e-8),
            "encoder": {
                "cnn_channels_multiplier": 96,
                "mlp_layers": 5,
                "dense_units": 1024,
                "cnn_layer_norm": _CNN_LN,
                "mlp_layer_norm": _LN,
            },
            "recurrent_model": {"recurrent_state_size": 4096, "dense_units": 1024, "layer_norm": _LN, "fused": True},
            "transition_model": {"hidden_size": 1024},
            "observation_model": {
                "cnn_channels_multiplier": 96,
                "mlp_layers": 5,
                "dense_units": 1024,
                "cnn_layer_norm": _CNN_LN,
                "mlp_layer_norm": _LN,
            },
            "reward_model": _mlp(bins=255),
            "discount_model": _mlp(),
        },
        "actor": {
            "init_std": 2.0,
            "min_std": 0.1,
            "max_std": 1.0,
            "dense_units": 1024,
            "mlp_layers": 5,
            "layer_norm": _LN,
            "action_clip": 1.0,
            "ent_coef": 3e-4,
            "clip_gradients": 100.0,
            "moments": {"decay": 0.99, "max": 1.0, "percentile": {"low": 0.05, "high": 0.95}},
            "optimizer": _adam(8e-5, 1e-5),
        },
        "critic": _mlp(
            bins=255, per_rank_target_network_update_freq=1, tau=0.02, clip_gradients=100.0, optimizer=_adam(8e-5, 1e-5)
        ),
    },
    "buffer": {"size": 1000000, "memmap": False, "device_cache": True, "per_kernel": "pallas", "prioritized": False},
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
# GRU backward, autograd op vs autograd through the plain version: both
# differentiate the same formulas; only the saved forward differs
GRAD_RTOL = 1e-4  # of each gradient's largest magnitude

# The training phase.  The one cut: a single-env replay ring of 2^15 rows
# (0.4 GB of rgb) instead of the configured 1M (12 GB), filled with seeded,
# Crafter-shaped transitions.
TRAIN_CAPACITY = 2**15
TRAIN_STEPS = 3
# kernel run vs plain rerun (plain GRU, per_kernel=lax), from the same state
# with the same draws.  The gather is bytes exact and the GRU step differs by
# summation order (~1e-6), so world-model losses agree closely; a Gumbel
# argmax near a tie can flip (about 5e5 draws a step), and the actor's loss
# rides on near-zero values while the reward and critic heads start at zero.
LOSS_RTOL = {"Loss/policy_loss": 0.1, "Grads/actor": 0.1}
LOSS_RTOL_DEFAULT = 1e-3
LOSS_ATOL = 1e-4
# Adam moves each weight by about lr (<= 1e-4) a step whatever the gradient's
# size, so a sign that differs moves a weight by 2 lr: 3 steps, 2 runs
PARAM_ATOL = 1e-3


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


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: the kernels ``fn`` launches, summed over a
    ``torch.profiler`` window of ``iters`` calls.  Unlike :func:`time_ms` it
    leaves out the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            total += ev.self_cuda_time_total if t is None else t
    return total / 1e3 / iters


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
    """The kernel against its plain version at the XL widths (H=4096,
    X=1024): the serving path's B in {1, 7, 64} with f32 and bf16 W, and the
    training path's B = 16 (dynamic scan) and 1024 (imagination) in f32."""
    hidden, xdim = 4096, 1024
    g = torch.Generator(device="cuda").manual_seed(0)
    w32 = torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5
    gamma = 1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    beta = 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)
    rows = []
    for wdtype in ("float32", "bfloat16"):
        w = w32 if wdtype == "float32" else w32.to(torch.bfloat16)
        for batch in (1, 7, 64, 16, 1024) if wdtype == "float32" else (1, 7, 64):
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
                "device_ms": device_ms(torch, lambda: gru_cell(h, x, w, gamma, beta)),
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


def build_kernels(libraries) -> dict:
    """Build every kernel library at once, one nvcc process each."""
    errors = []

    def build(lib):
        try:
            lib.load()
        except Exception as e:  # re-raised below, on the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(lib,)) for lib in libraries]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {
        "seconds": time.perf_counter() - t0,
        "nvcc_seconds": {lib.source.name: lib.seconds for lib in libraries},
        "ptxas": {
            lib.source.name: [ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln]
            for lib in libraries
        },
    }


def check_gru_backward(torch, gru_cell, gru_cell_plain) -> list:
    """The autograd op's gradients (kernel forward, backward through the
    plain formulas) against autograd through the plain version, at the
    training shapes: B = 16 (dynamic scan) and 1024 (imagination)."""
    hidden, xdim = 4096, 1024
    g = torch.Generator(device="cuda").manual_seed(1)
    w = (torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5).requires_grad_()
    gamma = (1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g)).requires_grad_()
    beta = (0.1 * torch.randn(3 * hidden, device="cuda", generator=g)).requires_grad_()
    rows = []
    for batch in (16, 1024):
        h = torch.tanh(torch.randn(batch, hidden, device="cuda", generator=g)).requires_grad_()
        x = torch.randn(batch, xdim, device="cuda", generator=g).requires_grad_()
        up = torch.randn(batch, hidden, device="cuda", generator=g)
        leaves = (h, x, w, gamma, beta)
        got = torch.autograd.grad(gru_cell(*leaves), leaves, up)
        ref = torch.autograd.grad(gru_cell_plain(*leaves), leaves, up)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("h", "x", "w", "gamma", "beta"), got, ref):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"gru_cell backward B={batch}: non-finite d{name}")
            errs[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(errs.values())
        if worst > GRAD_RTOL:
            raise AssertionError(f"gru_cell backward B={batch}: relative error {errs} > {GRAD_RTOL}")

        def step(fn):
            out = fn(*leaves)
            torch.autograd.grad(out, leaves, up)

        row = {
            "batch": batch,
            "max_rel_err": errs,
            "rtol": GRAD_RTOL,
            "fwd_bwd_ms": time_ms(torch, lambda: step(gru_cell), iters=5, warmup=1),
            "plain_fwd_bwd_ms": time_ms(torch, lambda: step(gru_cell_plain), iters=5, warmup=1),
        }
        phase("gru_cell_backward", **row)
        rows.append(row)
    return rows


def crafter_transitions(rng, rows: int, actions: int) -> dict:
    """Seeded transitions shaped like Crafter's, in the layout ``main``
    stores: (rows, 1 env, ...), uint8 frames, f32 the rest."""
    import numpy as np

    rgb = rng.integers(0, 256, size=(rows, 1, 64, 64, 3), dtype=np.uint8)
    act = np.zeros((rows, 1, actions), np.float32)
    act[np.arange(rows), 0, rng.integers(0, actions, rows)] = 1.0
    terminated = (rng.random((rows, 1, 1)) < 1e-3).astype(np.float32)
    is_first = np.roll(terminated, 1, axis=0)
    return {
        "rgb": rgb,
        "reward": (rng.random((rows, 1, 1)) < 0.02).astype(np.float32),
        "actions": act,
        "rewards": (rng.random((rows, 1, 1)) < 0.02).astype(np.float32),
        "terminated": terminated,
        "truncated": np.zeros((rows, 1, 1), np.float32),
        "is_first": is_first,
    }


def fill_replay(cfg, device, capacity: int, *, seed: int = 5, chunk: int = 4096, tail: int = 96):
    """The replay window the training phase samples: the host buffer's
    ``add`` in chunks, more rows than fit (the ring wraps), then the device
    cache's ``load_from``, then ``tail`` single rows through both ``add``s
    as the env loop writes them.  Raises unless the cache's rings equal the
    host buffer byte for byte."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayCache

    rng = np.random.default_rng(seed)
    rb = EnvIndependentReplayBuffer(capacity, n_envs=1, memmap=bool(cfg.buffer.memmap), buffer_cls=SequentialReplayBuffer)
    rb.seed(seed)
    t0 = time.perf_counter()
    total = capacity + capacity // 4
    for start in range(0, total, chunk):
        rb.add(crafter_transitions(rng, min(chunk, total - start), 17))
    cache = DeviceReplayCache(capacity, 1, device=device, kernel=str(cfg.buffer.per_kernel))
    cache.load_from(rb)
    for _ in range(tail):
        row = crafter_transitions(rng, 1, 17)
        rb.add(row)
        cache.add(row)
    if device != "cpu":
        torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    host = rb.buffer[0].buffer
    for k, ring in cache.buffers.items():
        if not torch.equal(ring.cpu(), torch.from_numpy(np.ascontiguousarray(host[k]))):
            raise AssertionError(f"device ring '{k}' differs from the host buffer after add/load_from")
    if int(cache._pos[0]) != rb.buffer[0]._pos:
        raise AssertionError("device cache and host buffer write heads differ")
    return rb, cache, {"rows": capacity, "written": total + tail, "write_head": int(cache._pos[0]), "fill_s": fill_s,
                       "ring_bytes": sum(t.numel() * t.element_size() for t in cache.buffers.values())}


def gather_bound_ms(n_rows: int, row_bytes: int) -> float:
    """Every output row read once and written once, at the memory rate."""
    return 2 * n_rows * row_bytes / MEM_BYTES_PER_S * 1e3


def check_gather_kernel(torch, cache, seq_len: int, batch: int) -> dict:
    """The window gather against its plain version on the training ring,
    bytes exact, with windows that wrap the ring, and its times."""
    from sheeprl_tpu_torch.data.device_buffer import sample_window_starts
    from sheeprl_tpu_torch.ops.gather import gather_windows, gather_windows_plain, window_cells

    bufs = cache.buffers
    cap = cache.capacity
    g = torch.Generator(device="cuda").manual_seed(2)
    envs, u = cache.draw(batch, g)
    pos = torch.from_numpy(cache._pos).cuda()
    filled = torch.from_numpy(cache._filled).cuda()
    starts = sample_window_starts(pos, filled, envs, u, seq_len=seq_len, cap=cap)
    # force ring wrap-around on a few rows: starts in the ring's last L - 1 rows
    starts[:4] = torch.tensor([cap - 1, cap - 2, cap - seq_len // 2, cap - seq_len + 1], dtype=torch.int32, device="cuda")
    out = gather_windows(bufs, starts, envs, seq_len=seq_len, batch_size=batch)
    ref = gather_windows_plain(bufs, starts, envs, seq_len=seq_len, batch_size=batch)
    torch.cuda.synchronize()
    for k in bufs:
        if out[k].dtype != bufs[k].dtype or out[k].shape != ref[k].shape or not torch.equal(out[k], ref[k]):
            raise AssertionError(f"gather_windows '{k}': not byte-identical to the plain version")
    cells = window_cells(starts, envs, seq_len=seq_len, batch_size=batch, cap=cap, n_envs=cache.n_envs)
    flat = {k: v.reshape(cap * cache.n_envs, -1) for k, v in bufs.items()}
    row_bytes = sum(v[0, 0].numel() * v.element_size() for v in bufs.values())
    def kernel():
        return gather_windows(bufs, starts, envs, seq_len=seq_len, batch_size=batch)

    def plain():
        return gather_windows_plain(bufs, starts, envs, seq_len=seq_len, batch_size=batch)

    def library():
        return [v.index_select(0, cells) for v in flat.values()]

    res = {
        "rows": int(cells.numel()),
        "row_bytes": row_bytes,
        "dtypes": {k: str(v.dtype).replace("torch.", "") for k, v in bufs.items()},
        "wrapping_windows": 4,
        "max_abs_err": 0.0,
        "ms": time_ms(torch, kernel, iters=50),
        "plain_ms": time_ms(torch, plain, iters=50),
        "library_ms": time_ms(torch, library, iters=50),
        "device_ms": device_ms(torch, kernel),
        "plain_device_ms": device_ms(torch, plain),
        "library_device_ms": device_ms(torch, library),
        "bound_ms": gather_bound_ms(int(cells.numel()), row_bytes),
        "bound_by": "bytes",
    }
    phase("gather_windows", **res)
    return res


class _DrawRecorder:
    """Records the argmax of every categorical latent sample the RSSM draws
    (``compute_stochastic_state``), to count samples that differ between
    two runs."""

    def __init__(self, agent_module):
        self.module = agent_module
        self.inner = agent_module.compute_stochastic_state
        self.draws = []

    def __enter__(self):
        import torch

        def recording(logits, discrete, sample=True, noise=None, generator=None):
            out = self.inner(logits, discrete, sample, noise, generator)
            if sample:
                self.draws.append(out.detach().argmax(-1).to(torch.uint8).reshape(-1))
            return out

        self.module.compute_stochastic_state = recording
        return self

    def __exit__(self, *exc):
        self.module.compute_stochastic_state = self.inner


def run_training(cfg, obs_shapes, actions_dim, device, *, steps: int = TRAIN_STEPS, capacity: int = TRAIN_CAPACITY) -> dict:
    """The training phase: the XL agent from ``cfg.seed``, the replay window
    of :func:`fill_replay`, ``steps`` calls of ``train_steps`` (one gradient
    step and one draw each, as the env loop makes them) with the kernels,
    then the same calls from the same state with the plain GRU and
    ``per_kernel=lax``.  The launch counters are set to 0 just before the
    kernel run and read just after it."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3 import agent as agent_module
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_state, train_steps
    from sheeprl_tpu_torch.ops.gather import gather_windows
    from sheeprl_tpu_torch.ops.gru_cell import gru_cell, gru_cell_plain
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime

    class _Space:
        def __init__(self, shape):
            self.shape = tuple(shape)

    runtime = MeshRuntime(device=device, precision=cfg.fabric.precision, seed=int(cfg.seed)).launch()
    agent = build_agent(runtime, actions_dim, False, cfg, {k: _Space(s) for k, s in obs_shapes.items()})
    initial = copy.deepcopy(agent.state_dict())
    rb, cache, fill = fill_replay(cfg, device, capacity)
    phase("replay_fill", **fill)
    seq_len, batch = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    gather_row = check_gather_kernel(torch, cache, seq_len, batch) if device != "cpu" else None
    n_params = sum(p.numel() for p in agent.parameters())

    def run(kernels: bool, n: int) -> dict:
        agent.load_state_dict(initial)
        agent.world_model.rssm.recurrent_model.gru.impl = gru_cell if kernels else gru_cell_plain
        cache.kernel = "pallas" if kernels else "lax"
        state = make_train_state(runtime, agent, cfg, False, actions_dim)
        gen = torch.Generator(device=device).manual_seed(int(cfg.seed))
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        gru_cell.launches = 0
        gather_windows.launches = 0
        metrics, step_ms = [], []
        with _DrawRecorder(agent_module) as rec:
            for _ in range(n):
                t0 = time.perf_counter()
                out = train_steps(state, rb, cache, cfg, 1, gen)
                if device != "cpu":
                    torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                metrics.extend({k: float(v) for k, v in m.items()} for m in out)
        launches = {"gru_cell": gru_cell.launches, "gather_windows": gather_windows.launches}
        for i, m in enumerate(metrics):
            bad = [k for k, v in m.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"training step {i}: non-finite {bad}")
        return {
            "metrics": metrics,
            "step_ms": step_ms,
            "launches": launches,
            "draws": rec.draws,
            "params": {k: v.detach().clone() for k, v in agent.state_dict().items()},
            "max_memory_allocated": torch.cuda.max_memory_allocated() if device != "cpu" else None,
        }

    run(False, 1)  # warm the libraries' per-shape state for both runs
    run(True, 1)
    fast = run(True, steps)
    plain = run(False, steps)
    agent.world_model.rssm.recurrent_model.gru.impl = gru_cell
    cache.kernel = str(cfg.buffer.per_kernel)

    want_gru = (seq_len + int(cfg.algo.horizon)) * steps
    if device != "cpu":
        if fast["launches"]["gru_cell"] != want_gru:
            raise AssertionError(f"gru_cell launched {fast['launches']['gru_cell']} times, want {want_gru}")
        if fast["launches"]["gather_windows"] != steps:
            raise AssertionError(f"gather_windows launched {fast['launches']['gather_windows']} times for {steps} draws")
    worst_loss = {}
    for i, (a, b) in enumerate(zip(fast["metrics"], plain["metrics"])):
        for k in a:
            rtol = LOSS_RTOL.get(k, LOSS_RTOL_DEFAULT)
            diff = abs(a[k] - b[k])
            if diff > rtol * abs(b[k]) + LOSS_ATOL:
                raise AssertionError(f"step {i} {k}: kernels {a[k]} vs plain {b[k]} (rtol {rtol}, atol {LOSS_ATOL})")
            worst_loss[k] = max(worst_loss.get(k, 0.0), diff / max(abs(b[k]), 1e-30))
    worst_param = max(float((fast["params"][k] - plain["params"][k]).abs().max()) for k in fast["params"])
    if worst_param > PARAM_ATOL:
        raise AssertionError(f"parameters after {steps} steps differ by {worst_param} > {PARAM_ATOL}")
    draws = sum(int(d.numel()) for d in fast["draws"])
    flips = sum(int((a != b).sum()) for a, b in zip(fast["draws"], plain["draws"]))
    res = {
        "steps": steps,
        "params": n_params,
        "losses_kernels": fast["metrics"],
        "losses_plain": plain["metrics"],
        "max_rel_diff": worst_loss,
        "max_abs_param_diff": worst_param,
        "param_atol": PARAM_ATOL,
        "categorical_samples": draws,
        "categorical_samples_differing": flips,
        "step_ms_kernels": fast["step_ms"],
        "step_ms_plain": plain["step_ms"],
        "launches": fast["launches"],
        "gru_launches_expected": want_gru,
        "max_memory_allocated": fast["max_memory_allocated"],
        "max_memory_allocated_plain": plain["max_memory_allocated"],
        "gather": gather_row,
    }
    return res


def profile_training(steps: int) -> dict:
    """Where a DV3-XL train step spends its time: ``steps`` steps under
    ``torch.profiler`` after one warm step (device time by group and the
    device's idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_state, train_steps
    from sheeprl_tpu_torch.config import dotdict
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime

    class _Space:
        def __init__(self, shape):
            self.shape = tuple(shape)

    cfg = dotdict(XL_CRAFTER)
    runtime = MeshRuntime(device="cuda", precision="32-true", seed=5).launch()
    agent = build_agent(runtime, CRAFTER_ACTIONS, False, cfg, {k: _Space(s) for k, s in CRAFTER_OBS.items()})
    rb, cache, _ = fill_replay(cfg, "cuda", TRAIN_CAPACITY)
    state = make_train_state(runtime, agent, cfg, False, CRAFTER_ACTIONS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    train_steps(state, rb, cache, cfg, 1, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        train_steps(state, rb, cache, cfg, 1, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            train_steps(state, rb, cache, cfg, 1, gen)
        torch.cuda.synchronize()
    res = _device_time(torch, prof, steps, step_ms)
    phase("profile_train_step", **res)
    return res


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "gru_" in n:
        return "gru_cell (hand-written)"
    if "gather_windows" in n:
        return "gather_windows (hand-written)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "conv" in n or "implicit" in n or "winograd" in n or "fft" in n:
        return "convolutions (cuDNN)"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n:
        return "matmuls (cuBLAS)"
    return "elementwise/reductions"


def _device_time(torch, prof, steps: int, step_ms: float) -> dict:
    """Device time per step by kernel and by group from a profiler window
    of ``steps`` steps, and the device's idle share of ``step_ms``."""
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
    return {
        "step_ms": step_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / step_ms),
        "groups_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [[k[:90], v] for k, v in top],
    }


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
    res = {"rows": 64, **_device_time(torch, prof, steps, step_ms)}
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
    from sheeprl_tpu_torch.ops import gather as gather_ops
    from sheeprl_tpu_torch.ops import gru_cell as gru_ops

    gru_cell, gru_cell_plain = gru_ops.gru_cell, gru_ops.gru_cell_plain

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    phase("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: every kernel of both paths, side by side
    phase("build", **build_kernels([gru_ops.LIBRARY, gather_ops.LIBRARY]))

    if "--profile" in sys.argv:
        i = sys.argv.index("--profile")
        steps = int(sys.argv[i + 1]) if len(sys.argv) > i + 1 else 20
        profile_serving(steps)
        print(smi, flush=True)
        return 0
    if "--profile-train" in sys.argv:
        i = sys.argv.index("--profile-train")
        steps = int(sys.argv[i + 1]) if len(sys.argv) > i + 1 else 3
        profile_training(steps)
        print(smi, flush=True)
        return 0

    # 3. kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gru_rows = check_gru_kernel(torch, gru_cell, gru_cell_plain)
    check_gru_backward(torch, gru_cell, gru_cell_plain)

    # 4. serving: DV3-XL sessions through the port's server
    gru_cell.launches = 0  # set again inside, just before the served run
    served = serve_sessions(dotdict(XL_CRAFTER), CRAFTER_OBS, CRAFTER_ACTIONS, "cuda")
    serve_launches = gru_cell.launches
    if serve_launches != served["batches"] or serve_launches == 0:
        raise AssertionError(f"gru_cell launched {serve_launches} times for {served['batches']} session batches")
    for label in ("bucket64", "small"):
        res = served[label]
        st = res["selftest"]
        phase(
            "serving", run=label, rows_per_s=st["rows_per_s"], wall_s=st["wall_s"],
            batches=res["batches"], batch_hist=res["batch_hist"], rows_hist=res["rows_hist"],
            latency_ms=res["latency_ms"], busy_ms_per_batch=1e3 * res["busy_s"] / max(1, res["batches"]),
        )
    phase("serving_kernel_launches", gru_cell=serve_launches, session_batches=served["batches"])

    # 5. serving against plain
    worst = replay_plain(served)
    phase("serving_vs_plain", max_abs_state_err=worst, tol=STATE_TOL, actions="identical")
    del served
    torch.cuda.empty_cache()

    # 6. training: train_steps at DV3-XL with both kernels, then plain
    train = run_training(dotdict(XL_CRAFTER), CRAFTER_OBS, CRAFTER_ACTIONS, "cuda")
    gather_row = train.pop("gather")
    phase("training_losses", kernels=train.pop("losses_kernels"), plain=train.pop("losses_plain"))
    phase("training", **train)

    # 7. purity
    bad = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")
    )
    if bad:
        raise AssertionError(f"the port imported JAX-side modules: {bad[:5]}")
    phase("purity", jax_modules=0)

    # the GRU row at the training path's largest shape (imagination, B = 1024)
    main_row = next(r for r in gru_rows if r["batch"] == 1024 and r["wdtype"] == "float32")
    kernels = [
        {
            "name": "gru_cell",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/gru_cell.cu",
            "replaces": "sheeprl_tpu/ops/pallas_gru.py:134",
            "launches": serve_launches + train["launches"]["gru_cell"],
            "launches_by_path": {"serving": serve_launches, "training": train["launches"]["gru_cell"]},
            "max_abs_err": max(r["max_abs_err"] for r in gru_rows if r["wdtype"] == "float32"),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms": main_row["device_ms"],
            "shape": "B=1024, H=4096, X=1024, f32",
        },
        {
            "name": "gather_windows",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/gather_windows.cu",
            "replaces": "sheeprl_tpu/ops/pallas_gather.py:84",
            "launches": train["launches"]["gather_windows"],
            "max_abs_err": gather_row["max_abs_err"],
            "ms": gather_row["ms"],
            "plain_ms": gather_row["plain_ms"],
            "bound_ms": gather_row["bound_ms"],
            "bound_by": gather_row["bound_by"],
            "library_ms": gather_row["library_ms"],
            "device_ms": gather_row["device_ms"],
            "plain_device_ms": gather_row["plain_device_ms"],
            "library_device_ms": gather_row["library_device_ms"],
            "shape": f"{gather_row['rows']} rows x {gather_row['row_bytes']} B",
        },
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

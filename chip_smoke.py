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
  ``buffer.per_kernel=lax``; then prioritized sequence starts
  (``buffer.prioritized=True``) through the sum-tree kernels against the
  plain tree, and one XL train step on a prioritized draw;
- SAC: three dispatches of G = 64 gradient steps of B = 256 (DMC
  walker-walk shapes, 1,000,000 transitions of prioritized replay at full
  size) through ``train_dispatch`` with the sum-tree and transition-gather
  kernels, then again from the same state with ``per_kernel=lax``;
- sharded SAC: the same dispatches on a mesh of 4 shards on the one card
  (``fabric.devices=4``, one env a shard): the env-sharded cache and its
  per-shard sum-trees, with the descent and scatter kernels, against a
  single-device tree of the same cells and then against ``per_kernel=lax``,
  and the sharded window draw (63 exclusions a shard, decay after);
- decoupled DV3-S: ``train_steps`` of DreamerV3-S with the decoupled RSSM
  (MsPacman 100K shapes: 64x64 RGB, 9 actions) on the full 100,000-row
  ring, three gradient steps with the sequence GRU kernel (the dynamic
  recurrence, one launch a step), the GRU step kernel (imagination) and the
  window gather, then the same steps plain;
- PPO and A2C (no kernel on this path): ``exp=ppo env=jax_cartpole
  algo.env_backend=jax`` at its published config (4 envs, rollout 128,
  10 epochs, minibatches of 64, dense 64 x 2) on the port's torch-tensor
  envs with the fused collect; the card's first rollout and update
  against the same on the CPU (same parameters, noise, data and
  permutations), timed iterations with a profiled one, a collect at 256
  envs; then PPO and A2C through ``sheeprl_tpu_torch.cli.run`` (two
  iterations, a resume for one more) and one PPO iteration on Pendulum;
- DreamerV3 and SAC through ``sheeprl_tpu_torch.cli.run`` (the off-policy
  env loops on the device envs): DV3-S with MLP keys on GridWorld (the
  fused GRU step, the device cache) and on CartPole (decoupled RSSM,
  prioritized replay), 1,024 warm-up steps and 64 training iterations
  each, then a resume, and the checkpoint's player on the card against the
  plain CPU player; SAC on Pendulum, about 30 dispatches of 64 x 256 with
  prioritized replay, then a resume.  Each run's kernel counts are set to
  0 just before it and read after it: every kernel its configuration
  reaches must have launched;
- DroQ and Plan2Explore-DreamerV3 through the CLI: DroQ on Pendulum at its
  published replay ratio 20 (80 critic steps a training iteration on the
  prioritized cache), then a resume; P2E-DV3 exploration at DV3-S widths
  with 8 ensemble members on GridWorld (fused, cached) and on CartPole
  (decoupled, prioritized), the exploration player against the plain CPU
  player, a resume, and finetuning from the GridWorld run's checkpoint,
  which must switch the player to the task actor.

Before the paths it checks the sum-tree kernels (sample, write, update) on a
1,000,000-leaf tree, the per-shard descent and scatter on a 250,000-leaf
sub-tree, the transition gather and the sequence GRU (forward and
backward), each against its plain version.

It prints one line per phase.  The line before the last is a JSON object
with each kernel's numbers; the last line is ``{"ok": true, "device":
{...}}``.  Any failure raises and the script exits non-zero; without a CUDA
device it exits 2 and prints no result.

``python3 chip_smoke.py --profile [STEPS]`` instead measures the serving step
at DV3-XL: a ``torch.profiler`` window over STEPS 64-row session steps
(device time by kernel, the device's idle share, a chrome trace in
``chiprun_out/serve_trace.json``) and a longer selftest for rows/s and
latency.  ``--profile-train [STEPS]`` prints the same breakdown for the XL
train step (no trace: a train step's is too large to bring back).
``--gru-bench [--root DIR]`` builds only the GRU step kernel of the package
under DIR (default: this checkout) and prints its check and timing rows, so
that two checkouts can be timed in turns on one card, and the card's
``mma.sync`` rates (phase ``mma_sync_peak``).  ``--tree-bench DIR`` runs
the sum-tree kernels' checks and rows (draws, writes, updates, scatters and
the writes' lane-count cases) and the transition gather's row at the SAC
shape of the checkout under DIR and of this one in turns, each by its own
script (``chiprun_out/tree_bench.json``).
None of these prints an ``ok`` line.
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
# step read, kept as a dict (the PPO phase composes the port's YAML tree).
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
    "buffer": {
        "size": 1000000, "memmap": False, "device_cache": True, "per_kernel": "pallas", "prioritized": False,
        "per_alpha": 0.6, "per_eps": 1e-6, "per_decay_on_sample": 0.5,
    },
}
CRAFTER_OBS = {"rgb": (64, 64, 3), "reward": (1,)}
CRAFTER_ACTIONS = (17,)


def _ms_pacman() -> dict:
    """DreamerV3-S on Atari MsPacman 100K with the decoupled RSSM, as the port
    composes `exp=dreamer_v3_100k_ms_pacman algo.world_model.decoupled_rssm=True
    algo.world_model.recurrent_model.fused_seq=True
    algo.world_model.recurrent_model.fused=True algo.cnn_keys.encoder=[rgb]
    algo.mlp_keys.encoder=[] fabric.precision=32-true buffer.device_cache=True
    buffer.per_kernel=pallas buffer.memmap=False` (a CPU test pins the two
    together): canonical config 4 of BASELINE.md with the window-gather kernel on."""
    cfg = copy.deepcopy(XL_CRAFTER)
    algo, wm = cfg["algo"], cfg["algo"]["world_model"]
    algo["mlp_keys"] = {"encoder": [], "decoder": []}
    wm["decoupled_rssm"] = True
    for node in (wm["encoder"], wm["observation_model"]):
        node.update(cnn_channels_multiplier=32, mlp_layers=2, dense_units=512)
    wm["recurrent_model"].update(recurrent_state_size=512, dense_units=512, fused_seq=True)
    wm["transition_model"]["hidden_size"] = 512
    for node in (wm["reward_model"], wm["discount_model"], algo["actor"], algo["critic"]):
        node.update(mlp_layers=2, dense_units=512)
    cfg["buffer"]["size"] = 100000
    return cfg


S_PACMAN = _ms_pacman()
PACMAN_OBS = {"rgb": (64, 64, 3)}
PACMAN_ACTIONS = (9,)

# H100 SXM (NVIDIA data sheet, dense): HBM3 rate, FP32 outside the tensor
# cores, bf16 and TF32 tensor cores.  The power limit printed beside the
# numbers says whether the card ran at the 700 W these rates assume.
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}

# GRU step kernel vs plain version.  f32: the kernel multiplies in 3xTF32
# (each operand split into a TF32 big and small part, three tensor-core
# products), which leaves ~2^-22 of each product out and sums K = 5120 of
# them in another order than the plain f32 product; that stays within a few
# ulps of the normalised parts (tests/test_torch_gru_cell.py emulates it on
# the CPU at K = 5120: 7.5e-7).  bf16: the operands are rounded identically
# on both sides and their products are exact in f32; only the order differs.
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

# The decoupled DV3-S phase: the full 100,000-row MsPacman ring (no cut), and
# the XL phase's tolerances for kernels against plain (LOSS_RTOL, PARAM_ATOL).
PACMAN_CAPACITY = 100000
# gru_sequence against its plain loop, at T = 64: each step's sum of K = 1024
# products in another order (~1e-6 of the state, as the cell's 2e-5), carried
# through 64 steps whose update gate mixes old and new state
SEQ_TOL = 1e-4
# its backward (efficient BPTT from the kernel's states) against autograd
# through the plain loop: two formulations of the same gradient, 64 steps
# deep, each from its own forward; of each gradient's largest magnitude
SEQ_GRAD_RTOL = 1e-3
# the same forward against the plain loop in float64 (gru_sequence_f64): at
# the DV3-S cell's shape the f32 loop itself reads 0.77-0.97e-6 and the
# cluster route emulated in 3xTF32 0.74-0.95e-6, where the same route with a
# ~16-bit product (split bf16, h1 (w1 + w2) + h2 w1) reads 3.3-4.1e-6
# (tests/test_torch_seq_gru_routes.py, on the CPU, seeds 0-2): the bound
# that holds the kernels' products to f32 accuracy, which SEQ_TOL cannot
SEQ_F32_TOL = 2e-6
# the cluster route's input product (3xTF32, K = X in one slice) against the
# f32 product: sums in another order, of the largest magnitude of the result
INPUT_PRODUCT_RTOL = 1e-5
# the sequence shapes: the decoupled DV3-S cell (T = 64, B = 16, H = X = 512)
# and T = 16 for the per-step slope; the smallest cluster width at an odd
# batch; and the grid route at H = 768, X = 256 (eligible for the scan,
# W[:H] too large for 16 blocks)
SEQ_SHAPES = ((64, 16, 512, 512), (16, 16, 512, 512), (5, 3, 128, 128), (5, 3, 768, 256), (64, 16, 768, 256))

# SAC on DMC walker-walk, as the port composes `exp=sac_dmc_walker_walk
# buffer.prioritized=True buffer.per_kernel=pallas buffer.device_cache=True
# buffer.memmap=False fabric.precision=32-true` (a CPU test pins the two
# together): the keys build_agent, the train function and the dispatch read.
SAC_WALKER = {
    "seed": 5,
    "env": {"num_envs": 4},
    "fabric": {"precision": "32-true"},
    "algo": {
        "name": "sac",
        "total_steps": 500000,
        "per_rank_batch_size": 256,
        "dispatch_batch": 64,
        "gamma": 0.99,
        "tau": 0.005,
        "hidden_size": 256,
        "mlp_keys": {"encoder": ["state"]},
        "actor": {"hidden_size": 256, "optimizer": _adam(3e-4, 1e-4)},
        "critic": {"n": 2, "hidden_size": 256, "target_network_frequency": 1, "optimizer": _adam(3e-4, 1e-4)},
        "alpha": {"alpha": 1.0, "optimizer": _adam(3e-4, 1e-4)},
    },
    "buffer": {
        "size": 1000000, "memmap": False, "device_cache": True, "per_kernel": "pallas", "prioritized": True,
        "sample_next_obs": False, "per_alpha": 0.6, "per_beta": 0.4, "per_beta_end": 1.0, "per_eps": 1e-6,
        "per_decay_on_sample": 0.5,
    },
}
WALKER_OBS, WALKER_ACTIONS = 24, 6
SAC_DISPATCHES = 3
# kernels vs per_kernel=lax, from the same state with the same draws: the
# draws are identical (no exclusions on this path: op for op the lax
# descent) and the batches bytes equal, so both runs compute the same
# torch ops on the same data; cuBLAS may still pick another reduction order
SAC_LOSS_RTOL = 1e-5
SAC_PARAM_ATOL = 1e-6  # a three-hundredth of one Adam step (lr 3e-4)
SAC_TREE_RTOL = 1e-5
# the sum-tree phase: the SAC dispatch's draws on the full-size tree
TREE_LEAVES, TREE_DRAWS = 1000000, 16384
W_RTOL = 1e-6  # IS weights: powf on the card against torch's pow

# The env-sharded SAC phase: the same configuration on a mesh of 4 shards
# (`fabric.devices=4`) on the one card.  As JAX's `main` does, each shard
# runs `env.num_envs` envs and takes `per_rank_batch_size` rows a gradient
# step: 16 envs of 62,500 rows (`buffer.size` over the envs), a sub-tree of
# 4 envs' 250,000 leaves (depth 18) per shard, 1,024 rows a step and
# 65,536 draws a dispatch.  No cut.
SAC_WALKER_SHARDED = copy.deepcopy(SAC_WALKER)
SAC_WALKER_SHARDED["fabric"]["devices"] = 4
SHARD_LEAVES = 250000
SHARDED_DRAWS = 4 * TREE_DRAWS
SHARE_SIGMAS = 4  # a shard's share of the draws against its share of the mass, in binomial standard errors
SHARE_DRAWS = 25


# The PPO phase: configuration #1 of `BASELINE.md`, `exp=ppo env=jax_cartpole
# algo.env_backend=jax` as published: 4 envs, rollout 128, 10 epochs,
# minibatches of 64, dense 64 x 2, tanh, Adam 1e-3 / eps 1e-4.  No cut.
PPO_EXP = ["exp=ppo", "env=jax_cartpole", "algo.env_backend=jax", "metric.log_level=0"]
PPO_ITERS = 3
PPO_COLLECT_ENVS = 256  # the size at which howto/jax-envs.md quotes its collect rates
PPO_RUN_TOL = 1e-5  # values and log-probs, the card's first rollout against the CPU's
# Parameters after one update (80 Adam steps) on the same data, card against
# CPU.  The limit lies between what a sound card reads and what an update
# with one small fault reads: two samples exchanged between the first two
# minibatches of the last epoch, which moves parameters by a fraction of an
# Adam step.  The phase makes that faulted update on the CPU, reports it
# (`max_abs_param_err_faulted_update`) and fails if the limit cannot see it.
PPO_PARAM_TOL = 1e-5

# The recurrent-PPO phases: `exp=ppo_recurrent env=jax_cartpole
# algo.env_backend=jax` as published: 16 envs, rollout 512, sequences of
# 16, 8 minibatches, 8 epochs, LSTM 64, dense 64, AdamW 3e-4 / eps 1e-4.
# No cut.  The card's first rollout against the CPU's from the same
# parameters and noise: actions and dones identical, values, log-probs,
# the recorded carry and the bootstrap values within RPPO_RUN_TOL.  Its
# first update (64 AdamW steps, each a 16-step BPTT over 64 sequences)
# step-locked: each step's gradient taken on the CPU at the card's state
# before it; the median over the steps of its error relative to the
# gradient's largest magnitude within RPPO_GRAD_RTOL, a limit that the same
# with every sequence started from the carry stored one step late must
# exceed.  The median, because a ReLU or the surrogate's clip that flips
# on a rounding difference moves one step's gradient by a few percent; so
# also at most one step in RPPO_STEPS_ABOVE_SHARE_INV above RPPO_GRAD_RTOL,
# a count that the same with the last epoch's sequences taken in another
# order must exceed, and the parameters of each AdamW step, taken on the
# CPU from the card's state before it, within RPPO_STEP_PARAM_TOL of the
# card's after it (which holds the card's AdamW step too).
# Free-running, two sound updates part for the same reason (the phase
# prints the CPU against itself with its inputs perturbed by 1e-6
# relative beside the card's reading): RPPO_FREE_TOL only bounds that.
RPPO_EXP = ["exp=ppo_recurrent", "env=jax_cartpole", "algo.env_backend=jax", "metric.log_level=0"]
RPPO_ITERS = 3
RPPO_RUN_TOL = 1e-5
RPPO_GRAD_RTOL = 1e-4
RPPO_STEPS_ABOVE_SHARE_INV = 16
RPPO_STEP_PARAM_TOL = 1e-5
RPPO_FREE_TOL = 2e-3
RPPO_CLI_RUNS = {"jax_cartpole": [], "jax_pendulum": ["env.id=jax_pendulum"]}
# The serving families (PPO, SAC, recurrent PPO) at their exps' widths,
# random weights from cfg.seed: served on the card, replayed on the CPU.
SERVE_FAMILIES = {
    "ppo": ["exp=ppo", "env=jax_cartpole", "algo.env_backend=jax"],
    "sac": ["exp=sac", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax", "algo.mlp_keys.encoder=[state]"],
    "ppo_recurrent": ["exp=ppo_recurrent", "env=jax_cartpole", "algo.env_backend=jax"],
}
SERVE_FAMILY_STEPS = 3
SERVE_FAMILY_TOL = 1e-5
SERVE_LATENCY_CALLS = 20

# The off-policy CLI phases: DreamerV3 (exp=dreamer_v3, DreamerV3-S widths,
# MLP keys only) and SAC (exp=sac) through sheeprl_tpu_torch.cli.run on the
# port's device envs.  DV3 steps one env, as the DV3 exps' published
# configs do (env.num_envs: 1), so that a training iteration is one
# gradient step at replay_ratio 1; SAC the env config's 4.
DV3_CLI_EXP = ["exp=dreamer_v3", "algo.env_backend=jax", "algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]",
               "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]", "env.num_envs=1", "metric.log_level=0"]
DV3_CLI_RUNS = {
    "gridworld": ["env=jax_gridworld", "algo.world_model.recurrent_model.fused=True", "buffer.device_cache=True",
                  "buffer.per_kernel=pallas"],
    "cartpole": ["env=jax_cartpole", "algo.world_model.decoupled_rssm=True",
                 "algo.world_model.recurrent_model.fused_seq=True", "buffer.prioritized=True", "buffer.per_kernel=pallas"],
}
# the kernels each run's configuration reaches (PERF.md's kernel table: #1, #2/#2a, #3, #5, #6)
DV3_CLI_KERNELS = {
    "gridworld": ("gru_cell", "gather_windows"),
    "cartpole": ("gru_sequence", "gru_input_product", "gather_windows", "sum_tree_sample", "sum_tree_write"),
}
DV3_CLI_LEARNING_STARTS = 1024
DV3_CLI_TRAIN_ITERS = 64
SAC_CLI_EXP = ["exp=sac", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax",
               "algo.mlp_keys.encoder=[state]", "algo.hidden_size=256", "algo.per_rank_batch_size=256",
               "buffer.device_cache=True", "buffer.prioritized=True", "buffer.per_kernel=pallas",
               "algo.dispatch_batch=64", "metric.log_level=0"]
SAC_CLI_KERNELS = ("gather_transitions", "sum_tree_sample", "sum_tree_write", "sum_tree_update")
SAC_CLI_DISPATCHES = 30
# DroQ (exp=droq) on Pendulum at its published replay ratio 20, with SAC's
# widths and batch and the env config's 4 envs: a training iteration is one
# dispatch of 80 critic steps (#5 and #4 for their batches, #7 for their TD
# errors), one uniform actor batch (#4) and one actor step; the cache's
# rows go in every step (#6)
DROQ_CLI_EXP = ["exp=droq", "env=jax_pendulum", "env.id=jax_pendulum", "algo.env_backend=jax",
                "algo.mlp_keys.encoder=[state]", "algo.hidden_size=256", "algo.per_rank_batch_size=256",
                "env.num_envs=4", "buffer.device_cache=True", "buffer.prioritized=True", "buffer.per_kernel=pallas",
                "metric.log_level=0"]
DROQ_CLI_ITERS = 20
# Plan2Explore-DreamerV3: exploration at DreamerV3-S widths with the MLP keys
# of DV3_CLI_EXP and the published ensembles.n 8, on the two DV3 runs'
# configurations (GridWorld with the fused GRU step and the device cache;
# CartPole decoupled and prioritized), each about as deep as its
# P2E_CLI_TRAIN_ITERS; then finetuning from the GridWorld run's checkpoint
# exp=dreamer_v3 composes algo=dreamer_v3_S; the P2E exps compose algo=p2e_dv3 over XL's widths, so set S's
DV3_S_WIDTHS = ["algo.dense_units=512", "algo.mlp_layers=2", "algo.world_model.recurrent_model.recurrent_state_size=512",
                "algo.world_model.transition_model.hidden_size=512",
                "algo.world_model.representation_model.hidden_size=512"]
P2E_CLI_EXP = ["exp=p2e_dv3_exploration", *DV3_CLI_EXP[1:], *DV3_S_WIDTHS]
P2E_FINETUNE_EXP = ["exp=p2e_dv3_finetuning", *DV3_CLI_EXP[1:]]
P2E_CLI_TRAIN_ITERS = {"gridworld": 16, "cartpole": 8}
P2E_FINETUNE_LEARNING_STARTS = 512
P2E_FINETUNE_ITERS = 8
# DreamerV2 (exp=dreamer_v2) and DreamerV1 (exp=dreamer_v1) through the CLI
# at their published widths (DV2: 400 x 4 ELU, recurrent 600 with the biased
# LayerNorm GRU, stochastic 32 x 32, hidden 600, T 50, B 16, horizon 15,
# replay ratio 0.2; DV1: 400 x 4, recurrent 200 with flax's GRU cell,
# stochastic 30, T 50, B 50, horizon 15), MLP keys only and one env.  Only
# depth is cut: learning_starts, total_steps and DV2's pretrain steps
# (published 1000, 5M and 100; DV1's learning_starts 5000), and the ring to
# 100,000 rows of 5M (a run writes under 400; a 5M ring makes each
# checkpoint about 0.9 GB).  DV2 runs on
# GridWorld through the device cache (#3) and on CartPole with prioritized
# starts (#3, #5, #6); DV1 on Pendulum (continuous, the truncated-normal
# head) through the device cache (#3).
DV2_CLI_EXP = ["exp=dreamer_v2", *DV3_CLI_EXP[1:], "algo.per_rank_pretrain_steps=10", "buffer.size=100000"]
DV2_CLI_RUNS = {
    "gridworld": ["env=jax_gridworld", "buffer.device_cache=True", "buffer.per_kernel=pallas"],
    "cartpole": ["env=jax_cartpole", "buffer.prioritized=True", "buffer.per_kernel=pallas"],
}
DV2_CLI_KERNELS = {"gridworld": ("gather_windows",),
                   "cartpole": ("gather_windows", "sum_tree_sample", "sum_tree_write")}
DV1_CLI_EXP = ["exp=dreamer_v1", *DV3_CLI_EXP[1:], "env=jax_pendulum", "env.id=jax_pendulum", "buffer.size=100000"]
DV1_CLI_RUNS = {"pendulum": ["buffer.device_cache=True", "buffer.per_kernel=pallas"]}
DV1_CLI_KERNELS = {"pendulum": ("gather_windows",)}
DREAMER_CLI_LEARNING_STARTS = 256
DREAMER_CLI_TRAIN_ITERS = {"dreamer_v2": 60, "dreamer_v1": 40}
# Each CLI configuration runs once more, short, for a torch.profiler window
# over CLI_PROFILE_ITERS training calls after CLI_PROFILE_START warm ones,
# so that the profiler's cost stays out of the measured run's rates.
CLI_PROFILE_START = 3
CLI_PROFILE_ITERS = 4

_T0 = time.perf_counter()


def phase(tag: str, **fields) -> None:
    """One line per phase, with ``t_s``: seconds since the script started."""
    fields["t_s"] = round(time.perf_counter() - _T0, 1)
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


def device_ms(torch, fn, iters: int = 20, warmup: int = 3, ops: bool = False, windows: int = 1):
    """Device time per call: the kernels ``fn`` launches, summed over a
    ``torch.profiler`` window of ``iters`` calls.  Unlike :func:`time_ms` it
    leaves out the host's time between launches.  With ``ops``, also the
    device operations (kernels, fills, copies) a call makes in that window.
    A window can drop records (PERF.md 7): with ``windows`` > 1, that many
    are taken and the one with the most records is kept."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    best = (-1, 0.0)
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(ev, "self_device_time_total", None)
                total += ev.self_cuda_time_total if t is None else t
                count += ev.count
        best = max(best, (count, total), key=lambda r: r[0])
    count, total = best
    return (total / 1e3 / iters, count / iters) if ops else total / 1e3 / iters


def host_us(torch, fn, calls: int = 1000, batches: int = 5) -> float:
    """The host's time to enqueue one call of ``fn``: a host clock over
    ``calls`` calls with no synchronise between them, the median of
    ``batches`` such batches (the card's host is shared: one batch can take
    half as long again as the next)."""
    fn()
    torch.cuda.synchronize()
    per_batch = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_batch.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(per_batch)[batches // 2]


_LAUNCH_FLOOR_SOURCE = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
_LAUNCH_FLOOR = []


def launch_floor_library():
    """An empty kernel behind a plain C entry, written next to the port's
    built libraries and built and loaded as they are (``CudaLibrary``: the
    same ``nvcc`` flags, ``ctypes``): the launch floor of a wrapper call."""
    import ctypes

    from sheeprl_tpu_torch.ops.build import BUILD_DIR, CudaLibrary

    if not _LAUNCH_FLOOR:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = BUILD_DIR / "launch_floor.cu"
        src.write_text(_LAUNCH_FLOOR_SOURCE)

        def bind(lib):
            lib.launch_empty.argtypes = [ctypes.c_void_p]
            lib.launch_empty.restype = ctypes.c_int

        _LAUNCH_FLOOR.append(CudaLibrary(str(src), "liblaunch_floor", bind))
    return _LAUNCH_FLOOR[0]


def launch_floor_ms(torch) -> float:
    """Event time a call of an empty kernel launched through ``ctypes``
    (:func:`launch_floor_library`): what any wrapper call of that route
    costs at least."""
    lib = launch_floor_library().load()

    def launch():
        if lib.launch_empty(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("empty kernel launch failed")

    return time_ms(torch, launch, iters=200)


def gru_bound_ms(batch: int, hidden: int, xdim: int, wdtype: str) -> tuple:
    """Least time for one step: every input read once and the output
    written once at the memory rate, against the product's 2*B*K*3H
    operations on the tensor cores (three TF32 passes for an f32-accurate
    product of f32 W, one bf16 pass for bf16 W) plus ~12 f32 operations per
    element of the (B, 3H) LayerNorm and gates.  Returns ``(ms, bound_by,
    cuda_cores_ms)``; the last is the bound earlier slices stated, with the
    f32 product on the CUDA cores (67 TFLOP/s)."""
    k, n = hidden + xdim, 3 * hidden
    wsize = 4 if wdtype == "float32" else 2
    nbytes = 4 * batch * hidden + 4 * batch * xdim + wsize * k * n + 8 * n + 4 * batch * hidden
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    product = 2 * batch * k * n
    t_gates = 12 * batch * n / PEAK_FLOPS["float32"] * 1e3
    tc = 3 * product / PEAK_FLOPS["tf32"] if wdtype == "float32" else product / PEAK_FLOPS["bfloat16"]
    t_ops = tc * 1e3 + t_gates
    cuda_cores = max(t_bytes, product / PEAK_FLOPS[wdtype] * 1e3 + t_gates)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (cuda_cores,)


# (H, X, W type, B): the serving path's B in {1, 7, 64} with f32 and bf16 W,
# the XL training path's B = 16 (dynamic scan) and 1024 (imagination) in
# f32, imagination with bf16 W, and DV3-S imagination (H = X = 512)
GRU_SHAPES = (
    [(4096, 1024, "float32", b) for b in (1, 7, 64, 16, 1024)]
    + [(4096, 1024, "bfloat16", b) for b in (1, 7, 64, 1024)]
    + [(512, 512, "float32", 1024)]
)


def check_gru_kernel(torch, gru_cell, gru_cell_plain) -> list:
    """The kernel against its plain version at every shape of
    ``GRU_SHAPES``, both LayerNorms; then its event and device times beside
    the plain version's, ``torch.matmul``'s product alone and the bounds."""
    rows = []
    weights = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for hidden, xdim, wdtype, batch in GRU_SHAPES:
        if (hidden, xdim) not in weights:
            weights.clear()
            w32 = torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5
            weights[(hidden, xdim)] = {
                "float32": w32, "bfloat16": w32.to(torch.bfloat16),
                "gamma": 1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g),
                "beta": 0.1 * torch.randn(3 * hidden, device="cuda", generator=g),
            }
        ws = weights[(hidden, xdim)]
        w, gamma, beta = ws[wdtype], ws["gamma"], ws["beta"]
        h = torch.tanh(torch.randn(batch, hidden, device="cuda", generator=g))
        x = torch.randn(batch, xdim, device="cuda", generator=g)
        err = 0.0
        for two_pass in (True, False):
            out = gru_cell(h, x, w, gamma, beta, two_pass=two_pass)
            ref = gru_cell_plain(h, x, w, gamma, beta, two_pass=two_pass)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"gru_cell B={batch} H={hidden} {wdtype}: non-finite output")
            err = max(err, float((out - ref).abs().max()))
        if err > TOL[wdtype]:
            raise AssertionError(f"gru_cell B={batch} H={hidden} {wdtype}: max abs err {err} > {TOL[wdtype]}")
        inp = torch.cat([h, x], -1).to(w.dtype)
        bound, bound_by, cuda_cores = gru_bound_ms(batch, hidden, xdim, wdtype)
        row = {
            "batch": batch,
            "hidden": hidden,
            "xdim": xdim,
            "wdtype": wdtype,
            "max_abs_err": err,
            "tol": TOL[wdtype],
            "ms": time_ms(torch, lambda: gru_cell(h, x, w, gamma, beta)),
            "plain_ms": time_ms(torch, lambda: gru_cell_plain(h, x, w, gamma, beta)),
            "library_ms": time_ms(torch, lambda: torch.matmul(inp, w)),
            "device_ms": device_ms(torch, lambda: gru_cell(h, x, w, gamma, beta)),
            "library_device_ms": device_ms(torch, lambda: torch.matmul(inp, w)),
            "bound_ms": bound,
            "bound_by": bound_by,
            "bound_cuda_cores_ms": cuda_cores,
        }
        phase("gru_cell", **row)
        rows.append(row)
    return rows


def gru_cell_sass(library) -> dict:
    """``cuobjdump -sass`` of the built GRU step library: the HMMA (tensor
    core) instructions of each product kernel.  Raises unless every
    ``gru_mma`` instantiation has some, which shows the product runs on the
    tensor cores."""
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        raise RuntimeError("cuobjdump not found: set CUDA_HOME or put it on PATH")
    sass = subprocess.run([tool, "-sass", str(library.path)], capture_output=True, text=True, check=True, timeout=300)
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    products = {k: v for k, v in counts.items() if "gru_mma" in k}
    if not products or min(products.values()) == 0:
        raise AssertionError(f"no HMMA in some gru_mma kernels of {library.path}: {counts}")
    return {"functions": len(counts), "gru_mma_kernels": len(products), "hmma": sum(products.values()),
            "hmma_min_per_kernel": min(products.values())}


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


def seq_gru_bound_ms(steps: int, batch: int, hidden: int, xdim: int) -> tuple:
    """Least time for the sequence: W, xs, h0, init_rec, is_first, gamma and
    beta read once and hs written once at the memory rate, against the T
    products' 2*T*B*K*3H operations plus ~12 per element of each (B, 3H)
    LayerNorm and gates.  The operations on the units the cluster route
    uses: the whole product (the input half, then the recurrent half) as
    three TF32 passes on the tensor cores, the gates at the f32 rate.
    Returns ``(ms, bound_by, cuda_cores_ms)``; the last is the bound with
    the whole product at the f32 rate, as earlier slices stated it."""
    k, n = hidden + xdim, 3 * hidden
    nbytes = 4 * (k * n + steps * batch * xdim + 2 * batch * hidden + steps * batch + 2 * n + steps * batch * hidden)
    gates = 12 * steps * batch * n
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = (3 * 2 * steps * batch * k * n / PEAK_FLOPS["tf32"] + gates / PEAK_FLOPS["float32"]) * 1e3
    cuda_cores = bound(nbytes, 2 * steps * batch * k * n + gates)[0]
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (cuda_cores,)


def input_product_bound_ms(m: int, xdim: int, n: int) -> tuple:
    """Least time for (M, X) @ (X, N) in f32: the operands read once and the
    result written once, against 2*M*X*N operations as three TF32 passes.
    Returns ``(ms, bound_by, cuda_cores_ms)``."""
    nbytes = 4 * (m * xdim + xdim * n + m * n)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = 3 * 2 * m * xdim * n / PEAK_FLOPS["tf32"] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (bound(nbytes, 2 * m * xdim * n)[0],)


def gru_sequence_f64(torch, h0, xs, w, gamma, beta, is_first, init_rec, eps: float = 1e-6):
    """The sequence's plain loop in float64 (``gru_sequence_plain`` is f32):
    the reference that :data:`SEQ_F32_TOL` bounds."""
    h0, xs, w, gamma, beta, is_first, init_rec = (a.detach().double() for a in (h0, xs, w, gamma, beta, is_first, init_rec))
    hidden = h0.shape[1]
    h, out = h0, []
    for t in range(xs.shape[0]):
        first = is_first[t].reshape(-1, 1)
        hg = (1.0 - first) * h + first * init_rec
        z = torch.cat([hg, xs[t]], -1) @ w
        mu = z.mean(-1, keepdim=True)
        var = torch.clamp((z * z).mean(-1, keepdim=True) - mu * mu, min=0.0)
        parts = (z - mu) * torch.rsqrt(var + eps) * gamma + beta
        reset = torch.sigmoid(parts[:, :hidden])
        cand = torch.tanh(reset * parts[:, hidden : 2 * hidden])
        update = torch.sigmoid(parts[:, 2 * hidden :] - 1.0)
        h = update * cand + (1.0 - update) * hg
        out.append(h)
    return torch.stack(out)


def seq_inputs(torch, g, steps: int, batch: int, hidden: int, xdim: int) -> list:
    """Seeded sequence inputs on the card, with resets at the first, middle
    and last step."""
    is_first = torch.zeros(steps, batch, 1, device="cuda")
    is_first[0, 0] = 1.0  # the other rows start from h0, so dh0 is not all zero
    is_first[steps // 2, batch // 2] = 1.0
    is_first[steps - 1, 0] = 1.0
    return [
        torch.tanh(torch.randn(batch, hidden, device="cuda", generator=g)),
        torch.randn(steps, batch, xdim, device="cuda", generator=g),
        torch.randn(hidden + xdim, 3 * hidden, device="cuda", generator=g) * (hidden + xdim) ** -0.5,
        1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=g),
        0.1 * torch.randn(3 * hidden, device="cuda", generator=g),
        is_first,
        torch.tanh(torch.randn(batch, hidden, device="cuda", generator=g)),
    ]


def check_seq_gru_kernel(torch) -> dict:
    """The sequence op against its plain loop on both routes
    (:data:`SEQ_SHAPES`, resets mid-sequence, the same bits twice), in f32
    within :data:`SEQ_TOL` and in float64 within :data:`SEQ_F32_TOL`; the
    cluster route's input product against the f32 product; then, at the
    decoupled DV3-S cell's shape, the autograd op's gradients (kernel
    forward, efficient-BPTT backward) against autograd through the plain
    loop, and the times: event, device (and device operations) and host
    time a call, the per-step slope of the device time between T = 16 and
    T = 64, and forward + backward.  Returns the cell's row, with the input
    product's under ``"input_product"``."""
    from sheeprl_tpu_torch.ops import seq_gru as seq_ops
    from sheeprl_tpu_torch.ops.seq_gru import gru_input_product, gru_sequence, gru_sequence_plain, sequence_route

    g = torch.Generator(device="cuda").manual_seed(6)
    optin = seq_ops._smem_optin(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, errs64, routes, dev = {}, {}, {}, {}
    for shape in SEQ_SHAPES:
        steps, batch, hidden, xdim = shape
        args = seq_inputs(torch, g, *shape)
        out = gru_sequence(*args)
        again = gru_sequence(*args)
        ref = gru_sequence_plain(*args)
        torch.cuda.synchronize()
        name = "T={} B={} H={} X={}".format(*shape)
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"gru_sequence {shape}: shape {tuple(out.shape)} or non-finite output")
        if not torch.equal(out, again):
            raise AssertionError(f"gru_sequence {shape}: two calls differ")
        errs[name] = float((out - ref).abs().max())
        errs64[name] = float((out.double() - gru_sequence_f64(torch, *args)).abs().max())
        routes[name] = sequence_route(hidden, xdim, batch, optin, sms)
        dev[name] = device_ms(torch, lambda: gru_sequence(*args), ops=True)
    if max(errs.values()) > SEQ_TOL:
        raise AssertionError(f"gru_sequence: max abs err {errs} > {SEQ_TOL}")
    if max(errs64.values()) > SEQ_F32_TOL:
        raise AssertionError(f"gru_sequence: max abs err against float64 {errs64} > {SEQ_F32_TOL}")
    if sorted(set(routes.values())) != ["cluster", "grid"]:
        raise AssertionError(f"gru_sequence: the shapes took the routes {routes}, want both")

    steps, batch, hidden, xdim = SEQ_SHAPES[0]
    args = seq_inputs(torch, g, steps, batch, hidden, xdim)
    # the input product alone, at the cell's shape
    xs2, wx = args[1].reshape(steps * batch, xdim), args[2][hidden:]
    zx = gru_input_product(xs2, wx)
    zref = xs2 @ wx
    torch.cuda.synchronize()
    p_err = float((zx - zref).abs().max() / zref.abs().max())
    if not p_err <= INPUT_PRODUCT_RTOL:
        raise AssertionError(f"gru_input_product: relative error {p_err} > {INPUT_PRODUCT_RTOL}")
    p_ms, p_by, p_cuda = input_product_bound_ms(steps * batch, xdim, 3 * hidden)
    p_dev, p_ops = device_ms(torch, lambda: gru_input_product(xs2, wx), ops=True)
    product_row = {
        "shape": f"M={steps * batch}, X={xdim}, N={3 * hidden}, f32 (3xTF32)",
        "max_abs_err": float((zx - zref).abs().max()), "max_rel_err": p_err, "rtol": INPUT_PRODUCT_RTOL,
        "ms": time_ms(torch, lambda: gru_input_product(xs2, wx)),
        "plain_ms": time_ms(torch, lambda: xs2 @ wx), "library_ms": time_ms(torch, lambda: torch.matmul(xs2, wx)),
        "device_ms": p_dev, "device_ops": p_ops, "host_us": host_us(torch, lambda: gru_input_product(xs2, wx)),
        "bound_ms": p_ms, "bound_by": p_by, "bound_cuda_cores_ms": p_cuda,
    }
    phase("gru_input_product", **product_row)

    diff = (0, 1, 2, 3, 4, 6)  # every input but is_first
    leaves = [a.requires_grad_(i in diff) for i, a in enumerate(args)]
    wanted = [leaves[i] for i in diff]
    up = torch.randn(steps, batch, hidden, device="cuda", generator=g)
    got = torch.autograd.grad(gru_sequence(*leaves), wanted, up)
    ref = torch.autograd.grad(gru_sequence_plain(*leaves), wanted, up)
    torch.cuda.synchronize()
    grad_errs = {}
    for name, a, b in zip(("h0", "xs", "w", "gamma", "beta", "init_rec"), got, ref):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"gru_sequence backward: non-finite d{name}")
        grad_errs[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    if max(grad_errs.values()) > SEQ_GRAD_RTOL:
        raise AssertionError(f"gru_sequence backward: relative error {grad_errs} > {SEQ_GRAD_RTOL}")

    plain_args = [a.detach() for a in leaves]
    h0, xs, w = plain_args[:3]

    inps = [torch.cat([h0, xs[t]], -1) for t in range(steps)]

    def products():  # the T products alone, as the plain loop makes them
        for inp in inps:
            torch.matmul(inp, w)

    def fwd_bwd(fn):
        torch.autograd.grad(fn(*leaves), wanted, up)

    b_ms, b_by, b_cuda = seq_gru_bound_ms(steps, batch, hidden, xdim)
    cell = "T={} B={} H={} X={}".format(*SEQ_SHAPES[0])
    slope = "T={} B={} H={} X={}".format(*SEQ_SHAPES[1])
    row = {
        "shape": f"T={steps}, B={batch}, H={hidden}, X={xdim}, f32", "route": routes[cell],
        "max_abs_err": max(errs.values()), "max_abs_err_by_shape": errs, "route_by_shape": routes, "tol": SEQ_TOL,
        "max_abs_err_f64_by_shape": errs64, "f32_tol": SEQ_F32_TOL,
        "device_ms_by_shape": {k: v[0] for k, v in dev.items()},
        "grad_max_rel_err": grad_errs, "grad_rtol": SEQ_GRAD_RTOL,
        "ms": time_ms(torch, lambda: gru_sequence(*plain_args)),
        "plain_ms": time_ms(torch, lambda: gru_sequence_plain(*plain_args), iters=5),
        "library_ms": time_ms(torch, products, iters=5),
        "device_ms": dev[cell][0], "device_ops": dev[cell][1],
        "host_us": host_us(torch, lambda: gru_sequence(*plain_args), calls=200),
        "per_step_us": (dev[cell][0] - dev[slope][0]) / (SEQ_SHAPES[0][0] - SEQ_SHAPES[1][0]) * 1e3,
        "fwd_bwd_ms": time_ms(torch, lambda: fwd_bwd(gru_sequence), iters=5, warmup=1),
        "plain_fwd_bwd_ms": time_ms(torch, lambda: fwd_bwd(gru_sequence_plain), iters=5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bound_cuda_cores_ms": b_cuda,
        "input_product": product_row,
    }
    phase("gru_sequence", **{k: v for k, v in row.items() if k != "input_product"})
    return row


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


def pacman_transitions(rng, rows: int) -> dict:
    """Seeded transitions shaped like MsPacman's at 64x64 RGB (9 actions,
    rewards of 0 or 10), in the layout ``main`` stores: 12,340 bytes a row."""
    import numpy as np

    act = np.zeros((rows, 1, 9), np.float32)
    act[np.arange(rows), 0, rng.integers(0, 9, rows)] = 1.0
    terminated = (rng.random((rows, 1, 1)) < 1e-3).astype(np.float32)
    return {
        "rgb": rng.integers(0, 256, size=(rows, 1, 64, 64, 3), dtype=np.uint8),
        "actions": act,
        "rewards": 10.0 * (rng.random((rows, 1, 1)) < 0.05).astype(np.float32),
        "terminated": terminated,
        "truncated": np.zeros((rows, 1, 1), np.float32),
        "is_first": np.roll(terminated, 1, axis=0),
    }


def fill_replay(cfg, device, capacity: int, *, seed: int = 5, chunk: int = 4096, tail: int = 96, transitions=None):
    """The replay window the training phase samples: the host buffer's
    ``add`` in chunks, more rows than fit (the ring wraps), then the device
    cache's ``load_from``, then ``tail`` single rows through both ``add``s
    as the env loop writes them.  ``transitions(rng, rows)`` makes the rows
    (Crafter's by default).  Raises unless the cache's rings equal the host
    buffer byte for byte."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayCache

    make = transitions or (lambda rng, rows: crafter_transitions(rng, rows, 17))
    rng = np.random.default_rng(seed)
    rb = EnvIndependentReplayBuffer(capacity, n_envs=1, memmap=bool(cfg.buffer.memmap), buffer_cls=SequentialReplayBuffer)
    rb.seed(seed)
    t0 = time.perf_counter()
    total = capacity + capacity // 4
    for start in range(0, total, chunk):
        rb.add(make(rng, min(chunk, total - start)))
    cache = DeviceReplayCache(capacity, 1, device=device, kernel=str(cfg.buffer.per_kernel))
    cache.load_from(rb)
    for _ in range(tail):
        row = make(rng, 1)
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
    bytes exact, with windows that wrap the ring, then again after one ring
    is replaced by a new tensor behind the same key (a new plan), and its
    times: event, device (and device operations) and host time a call, the
    plain version, per-key ``index_select`` and the launch floor of the
    ctypes route."""
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
    key = min(bufs, key=lambda k: bufs[k].numel())
    swapped = dict(bufs, **{key: torch.randint_like(bufs[key], 0, 2) if bufs[key].dtype == torch.uint8
                            else torch.randn_like(bufs[key].float()).to(bufs[key].dtype)})
    out = gather_windows(swapped, starts, envs, seq_len=seq_len, batch_size=batch)
    ref = gather_windows_plain(swapped, starts, envs, seq_len=seq_len, batch_size=batch)
    torch.cuda.synchronize()
    if any(not torch.equal(out[k], ref[k]) for k in ref):
        raise AssertionError(f"gather_windows: not byte-identical after '{key}' was replaced by a new ring")
    del swapped, out, ref
    cells = window_cells(starts, envs, seq_len=seq_len, batch_size=batch, cap=cap, n_envs=cache.n_envs)
    flat = {k: v.reshape(cap * cache.n_envs, -1) for k, v in bufs.items()}
    row_bytes = sum(v[0, 0].numel() * v.element_size() for v in bufs.values())
    def kernel():
        return gather_windows(bufs, starts, envs, seq_len=seq_len, batch_size=batch)

    def plain():
        return gather_windows_plain(bufs, starts, envs, seq_len=seq_len, batch_size=batch)

    def library():
        return [v.index_select(0, cells) for v in flat.values()]

    dev_ms, dev_ops = device_ms(torch, kernel, ops=True)
    res = {
        "rows": int(cells.numel()),
        "row_bytes": row_bytes,
        "dtypes": {k: str(v.dtype).replace("torch.", "") for k, v in bufs.items()},
        "wrapping_windows": 4,
        "ring_replaced": key,
        "max_abs_err": 0.0,
        "ms": time_ms(torch, kernel, iters=50),
        "plain_ms": time_ms(torch, plain, iters=50),
        "library_ms": time_ms(torch, library, iters=50),
        "device_ms": dev_ms,
        "device_ops": dev_ops,
        "plain_device_ms": device_ms(torch, plain),
        "library_device_ms": device_ms(torch, library),
        "host_us": host_us(torch, kernel),
        "launch_floor_ms": launch_floor_ms(torch),
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


def run_training(
    cfg, obs_shapes, actions_dim, device, *, steps: int = TRAIN_STEPS, capacity: int = TRAIN_CAPACITY,
    transitions=None, per: bool = True, profile: bool = False,
) -> dict:
    """The training phase: the agent from ``cfg.seed``, the replay window of
    :func:`fill_replay` (rows from ``transitions``), ``steps`` calls of
    ``train_steps`` (one gradient step and one draw each, as the env loop
    makes them) with the kernels, then the same calls from the same state
    with the plain GRU step, the plain GRU sequence and ``per_kernel=lax``.
    The launch counters are set to 0 just before the kernel run and read
    just after it.  With ``per``, path B on the same replay
    (:func:`prioritized_starts`), under ``res["per"]``; with ``profile``,
    one more kernel step under ``torch.profiler``, under ``res["profile"]``."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3 import agent as agent_module
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_state, train_steps
    from sheeprl_tpu_torch.ops.gather import gather_windows
    from sheeprl_tpu_torch.ops.gru_cell import gru_cell, gru_cell_plain
    from sheeprl_tpu_torch.ops import seq_gru as seq_ops
    from sheeprl_tpu_torch.ops.seq_gru import gru_input_product, gru_sequence, gru_sequence_plain
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime

    class _Space:
        def __init__(self, shape):
            self.shape = tuple(shape)

    runtime = MeshRuntime(device=device, precision=cfg.fabric.precision, seed=int(cfg.seed)).launch()
    agent = build_agent(runtime, actions_dim, False, cfg, {k: _Space(s) for k, s in obs_shapes.items()})
    rssm = agent.world_model.rssm
    initial = copy.deepcopy(agent.state_dict())
    rb, cache, fill = fill_replay(cfg, device, capacity, transitions=transitions)
    phase("replay_fill", **fill)
    seq_len, batch = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    gather_row = check_gather_kernel(torch, cache, seq_len, batch) if device != "cpu" else None
    n_params = sum(p.numel() for p in agent.parameters())
    counters = (gru_cell, gru_sequence, gru_input_product, gather_windows)

    def run(kernels: bool, n: int) -> dict:
        agent.load_state_dict(initial)
        rssm.recurrent_model.gru.impl = gru_cell if kernels else gru_cell_plain
        rssm.seq_impl = gru_sequence if kernels else gru_sequence_plain
        cache.kernel = "pallas" if kernels else "lax"
        state = make_train_state(runtime, agent, cfg, False, actions_dim)
        gen = torch.Generator(device=device).manual_seed(int(cfg.seed))
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        metrics, step_ms = [], []
        with _DrawRecorder(agent_module) as rec:
            for _ in range(n):
                t0 = time.perf_counter()
                out = train_steps(state, rb, cache, cfg, 1, gen)
                if device != "cpu":
                    torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                metrics.extend({k: float(v) for k, v in m.items()} for m in out)
        launches = {c.__name__: c.launches for c in counters}
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
            # kept only to profile one more step: an XL optimizer state is GBs
            "state": state if profile else None,
        }

    run(False, 1)  # warm the libraries' per-shape state for both runs
    run(True, 1)
    fast = run(True, steps)
    plain = run(False, steps)
    rssm.recurrent_model.gru.impl = gru_cell
    rssm.seq_impl = gru_sequence
    cache.kernel = str(cfg.buffer.per_kernel)

    # the decoupled RSSM with an eligible size runs the dynamic recurrence as
    # one gru_sequence; otherwise it takes one GRU step per row of the window
    # (the cluster route first computes its input product in a launch of its own)
    seq_route = rssm.decoupled and rssm.seq_scan_eligible(int(cfg.algo.world_model.recurrent_model.dense_units))
    cluster = seq_route and device != "cpu" and seq_ops.sequence_route(
        rssm.recurrent_state_size, int(cfg.algo.world_model.recurrent_model.dense_units), batch,
        seq_ops._smem_optin(0), torch.cuda.get_device_properties(0).multi_processor_count,
    ) == "cluster"
    want = {
        "gru_cell": (int(cfg.algo.horizon) + (0 if seq_route else seq_len)) * steps,
        "gru_sequence": steps if seq_route else 0,
        "gru_input_product": steps if cluster else 0,
        "gather_windows": steps,
    }
    if device != "cpu" and fast["launches"] != want:
        raise AssertionError(f"kernel launches {fast['launches']} over {steps} steps, want {want}")
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
        "launches_expected": want,
        "max_memory_allocated": fast["max_memory_allocated"],
        "max_memory_allocated_plain": plain["max_memory_allocated"],
        "gather": gather_row,
    }
    if profile and device != "cpu":
        from torch.profiler import ProfilerActivity, profile as torch_profile

        # device time of one more kernel step; the idle share is taken
        # against the kernel run's step time without the profiler
        gen = torch.Generator(device=device).manual_seed(0)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_steps(fast["state"], rb, cache, cfg, 1, gen)
            torch.cuda.synchronize()
        res["profile"] = _device_time(torch, prof, 1, float(np.median(fast["step_ms"])))
    if per:
        res["per"] = prioritized_starts(cfg, runtime, agent, rb, actions_dim)
    return res


# ------------------------------------------------------------------ sum tree
def tree_from_leaves(leaves, device):
    """A ``PriorityTree`` holding ``leaves`` (internal nodes rebuilt on the host)."""
    import numpy as np

    from sheeprl_tpu_torch.replay.priority_tree import PriorityTree

    tree = PriorityTree(len(leaves), device=device)
    tree.load_state_dict({"leaves": leaves, "max_priority": np.float32(1.0)})
    return tree


def descent_bytes(torch, leaf, depth: int, n_excl: int) -> int:
    """What the draws that ended at ``leaf`` read and wrote: the distinct
    32-byte sectors holding the left child of every node on their paths and
    their leaves, the uniforms, the exclusions and the two outputs."""
    node = leaf.long() + (1 << depth)
    idx = [node] + [(node >> k) << 1 for k in range(1, depth + 1)]
    sectors = torch.unique(torch.cat(idx) // 8).numel()
    return 32 * sectors + 12 * leaf.numel() + 5 * n_excl


def descent_ops(n: int, depth: int, n_excl: int) -> int:
    """The operations a draw of ``n`` needs: a comparison, a subtraction and
    a select at each of ``depth`` levels a draw, and each exclusion's mass
    taken off its ``depth`` ancestors once (an add and a subtraction).
    Scanning every exclusion at every level of every draw is one design's
    cost, not work the function needs."""
    return 3 * n * depth + 2 * n_excl * depth


def write_bytes(torch, leaf, active, depth: int, update: bool) -> int:
    """What a write reads and writes: 4 bytes for every distinct node its
    active lanes' paths write (leaves and ancestors) or read (the children
    of the rebuilt nodes), and each lane's leaf, value and flag."""
    p = 1 << depth
    node = leaf[active].long() + p
    written = torch.unique(torch.cat([node >> k for k in range(depth + 1)]))
    parents = written[written < p]
    touched = torch.unique(torch.cat([written, 2 * parents, 2 * parents + 1])).numel()
    return 4 * touched + 9 * leaf.numel() + (8 if update else 0)


def bound(nbytes: float, flops: float = 0.0) -> tuple:
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_sum_tree_kernels(torch) -> dict:
    """The three sum-tree kernels against their plain versions on a
    1,000,000-leaf tree (P = 2^20), at the SAC dispatch's n = 16,384 draws:
    sample with 0, 4, 63 and 2016 exclusions on integer-valued priorities (leaves
    identical) and on random f32 ones (flips counted; none without
    exclusions); writes with equal duplicates, unequal active duplicates and
    inactive lanes (slots 1.. bit-equal); an update (tree and running max
    equal).  Returns one timing row per kernel at its main-path shape.
    Each sample row also has the wrapper's host time a call (``host_us``),
    the device operations a call (``device_ops``) and the launch floor of
    the ctypes route.  The draws take a kept scratch, as the trees pass it."""
    import numpy as np

    from sheeprl_tpu_torch.ops import per

    rng = np.random.default_rng(3)
    g = torch.Generator(device="cuda").manual_seed(3)
    trees = {
        "integer": tree_from_leaves(rng.integers(0, 9, TREE_LEAVES).astype(np.float32), "cuda"),
        "f32": tree_from_leaves((rng.random(TREE_LEAVES) + 0.01).astype(np.float32), "cuda"),
    }
    depth = trees["f32"].depth
    p = 1 << depth
    n = TREE_DRAWS
    r01 = torch.rand(n, generator=g, device="cuda")
    rows = {}
    floor_ms = launch_floor_ms(torch)
    # 2016 = 63 x 32 envs: DV3's prioritized starts at L = 64 on 32 envs,
    # more exclusions than one shared-memory chunk holds
    for n_excl in (0, 4, 63, 2016):
        excl = None
        if n_excl:
            excl = torch.from_numpy(rng.choice(TREE_LEAVES, n_excl, replace=False).astype(np.int32)).cuda()
        kw = {"scratch": per.draw_scratch(depth, n_excl, "cuda")}
        checks = {}
        for label, t in trees.items():
            leaf, w = per.sum_tree_sample(t.tree, r01, 0.4, TREE_LEAVES, depth=depth, exclude_idx=excl, **kw)
            leaf_p, w_p = per.sum_tree_sample_plain(t.tree, r01, 0.4, TREE_LEAVES, depth=depth, exclude_idx=excl)
            torch.cuda.synchronize()
            same = leaf == leaf_p
            flips = int((~same).sum())
            w_err = float(((w - w_p).abs() / w_p.abs())[same].max())
            if flips and (label == "integer" or not n_excl):
                raise AssertionError(f"sum_tree_sample E={n_excl} {label}: {flips} draws differ from the plain version")
            if w_err > W_RTOL:
                raise AssertionError(f"sum_tree_sample E={n_excl} {label}: weights differ by {w_err} > {W_RTOL}")
            if excl is not None and bool(torch.isin(leaf, excl).any()):
                raise AssertionError(f"sum_tree_sample E={n_excl}: an excluded leaf was drawn")
            if int(leaf.max()) >= TREE_LEAVES:
                raise AssertionError("sum_tree_sample drew a padded leaf")
            checks[label] = {"flips": flips, "max_rel_err_w": w_err, "max_abs_err_w": float((w - w_p).abs()[same].max())}
        tree = trees["f32"].tree
        leaves_t = tree[p : p + TREE_LEAVES]

        def kernel():
            return per.sum_tree_sample(tree, r01, 0.4, TREE_LEAVES, depth=depth, exclude_idx=excl, **kw)

        def plain():
            return per.sum_tree_sample_plain(tree, r01, 0.4, TREE_LEAVES, depth=depth, exclude_idx=excl)

        def library():  # the inverse-CDF draw, two calls, no exclusions or weights
            cdf = torch.cumsum(leaves_t, 0)
            return torch.searchsorted(cdf, r01 * cdf[-1], right=True)

        leaf = kernel()[0]
        nbytes = descent_bytes(torch, leaf, depth, n_excl)
        b_ms, b_by = bound(nbytes, descent_ops(n, depth, n_excl))
        dev_ms, dev_ops = device_ms(torch, kernel, ops=True)
        row = {
            "draws": n, "leaves": TREE_LEAVES, "exclusions": n_excl, "checks": checks,
            "max_abs_err": max(c["max_abs_err_w"] for c in checks.values()),
            "ms": time_ms(torch, kernel, iters=50), "plain_ms": time_ms(torch, plain, iters=10),
            "library_ms": time_ms(torch, library, iters=50), "device_ms": dev_ms, "device_ops": dev_ops,
            "host_us": host_us(torch, kernel), "launch_floor_ms": floor_ms,
            "bound_bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
        }
        phase("sum_tree_sample", **row)
        rows[f"sample_e{n_excl}"] = row

    base = trees["f32"].tree
    lanes = TREE_DRAWS
    leaf_idx = torch.randint(0, TREE_LEAVES, (lanes,), generator=g, device="cuda", dtype=torch.int32)
    leaf_idx[lanes // 2 : lanes // 2 + 2048] = leaf_idx[:2048]  # duplicates ...
    vals = torch.rand(lanes, generator=g, device="cuda") * 3
    vals[lanes // 2 : lanes // 2 + 1024] = vals[:1024]  # ... half of them with equal values
    active = torch.rand(lanes, generator=g, device="cuda") < 0.7
    a, b = base.clone(), base.clone()
    owner = per.owner_scratch(depth, "cuda")  # kept across calls, as PriorityTree keeps it
    per.sum_tree_write(a, leaf_idx, vals, active, depth=depth, owner=owner)
    per.sum_tree_write_plain(b, leaf_idx, vals, active, depth=depth)
    ma = per.sum_tree_update(a, torch.tensor(2.0, device="cuda"), leaf_idx, vals * 0.5, active, depth=depth, owner=owner)
    mb = per.sum_tree_update_plain(b, torch.tensor(2.0, device="cuda"), leaf_idx, vals * 0.5, active, depth=depth)
    torch.cuda.synchronize()
    if not torch.equal(a[1:], b[1:]) or float(ma) != float(mb):
        raise AssertionError("sum_tree_write/update: tree or running max differ from the plain version")
    if not bool((owner == -1).all()):
        raise AssertionError("sum_tree_write/update: the owner scratch was left dirty")
    scratch = base.clone()
    # the write at the SAC flush's shape: 64 rows x 4 envs seeded at the running max
    flush_leaf = torch.arange(256, device="cuda", dtype=torch.int32) + TREE_LEAVES // 8
    flush_val = torch.full((256,), 1.5, device="cuda")
    flush_act = torch.ones(256, dtype=torch.bool, device="cuda")
    for name, fn, plain_fn, args, lane_act, upd in (
        ("sum_tree_write", per.sum_tree_write, per.sum_tree_write_plain, (flush_leaf, flush_val, flush_act), flush_act, False),
        ("sum_tree_update", per.sum_tree_update, per.sum_tree_update_plain, (leaf_idx, vals, active), active, True),
    ):
        call_args = ((torch.tensor(1.0, device="cuda"),) if upd else ()) + args
        nbytes = write_bytes(torch, args[0], lane_act, depth, upd)
        b_ms, b_by = bound(nbytes)

        def kernel():
            return fn(scratch, *call_args, depth=depth, owner=owner)

        dev_ms, dev_ops = device_ms(torch, kernel, ops=True)
        row = {
            "lanes": int(args[0].numel()), "active": int(lane_act.sum()), "duplicates": 0 if not upd else 2048,
            "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel, iters=50),
            "plain_ms": time_ms(torch, lambda: plain_fn(scratch, *call_args, depth=depth), iters=10),
            "library_ms": None, "device_ms": dev_ms, "device_ops": dev_ops,
            "host_us": host_us(torch, kernel), "launch_floor_ms": floor_ms,
            "bound_bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
        }
        phase(name, **row)
        rows[name] = row
    rows["write_cases"] = check_write_cases(torch, base, depth, TREE_LEAVES, ("write", "update"), owner)
    del trees, scratch, a, b
    return rows


WRITE_CASE_LANES = (1, 255, 256, 1024, 1025, 16384, 65536)


def check_write_cases(torch, base, depth: int, n_leaves: int, kinds, owner) -> list:
    """The writes at lane counts on both sides of the one-block method's
    1,024 lanes and at the paths' shapes, on a copy of ``base`` whose
    internal nodes are random (not the sums of their children), with
    duplicates, inactive lanes and, for the scatter, the other shards'
    lanes: trees equal to the plain versions' from slot 1 (untouched nodes
    keep their bits), maxima exact, the owner scratch clean; each case's
    device time and device operations a call."""
    from sheeprl_tpu_torch.ops import per

    g = torch.Generator(device="cuda").manual_seed(10)
    p = 1 << depth
    broken = base.clone()
    broken[1:p] = torch.randint(0, 1000, (p - 1,), generator=g, device="cuda").float() * 0.37
    max_p = torch.tensor(0.5, device="cuda")
    out = []
    for lanes in WRITE_CASE_LANES:
        leaf = torch.randint(0, n_leaves, (lanes,), generator=g, device="cuda", dtype=torch.int32)
        leaf[lanes // 2 : lanes // 2 + lanes // 4] = leaf[: lanes // 4]
        vals = torch.rand(lanes, generator=g, device="cuda") * 3
        active = torch.rand(lanes, generator=g, device="cuda") < 0.7
        active[0] = True
        sid = torch.randint(0, 4, (lanes,), generator=g, device="cuda", dtype=torch.int32)
        sid[0] = 1
        calls = {
            "write": (lambda t: (per.sum_tree_write(t, leaf, vals, active, depth=depth, owner=owner), None)[1],
                      lambda t: (per.sum_tree_write_plain(t, leaf, vals, active, depth=depth), None)[1]),
            "update": (lambda t: per.sum_tree_update(t, max_p, leaf, vals, active, depth=depth, owner=owner),
                       lambda t: per.sum_tree_update_plain(t, max_p, leaf, vals, active, depth=depth)),
            "scatter": (lambda t: per.sum_tree_scatter(t, leaf, vals, active, sid, 1, depth=depth, owner=owner)[1],
                        lambda t: per.sum_tree_scatter_plain(t, leaf, vals, active, sid, 1, depth=depth)[1]),
        }
        for kind in kinds:
            kernel, plain = calls[kind]
            a, b = broken.clone(), broken.clone()
            got, want = kernel(a), plain(b)
            torch.cuda.synchronize()
            if not torch.equal(a[1:], b[1:]) or (want is not None and float(got) != float(want)):
                raise AssertionError(f"sum_tree_{kind} at {lanes} lanes on a non-invariant tree: differs from the plain version")
            if not bool((owner == -1).all()):
                raise AssertionError(f"sum_tree_{kind} at {lanes} lanes: the owner scratch was left dirty")
            # a profiler window can drop a kernel's record (PERF.md 7: readings of
            # 0.8 and 0.95 ops a call; two windows both read 0.8 once), so the
            # fullest of four windows is kept
            dev_ms, dev_ops = device_ms(torch, lambda: kernel(a), iters=5, warmup=1, ops=True, windows=4)
            if dev_ops != 1:
                raise AssertionError(f"sum_tree_{kind} at {lanes} lanes: {dev_ops} device operations a call, want 1")
            row = {"kind": kind, "lanes": lanes, "depth": depth, "device_ms": dev_ms, "device_ops": dev_ops,
                   "written": int(torch.unique(leaf[active & (sid == 1) if kind == "scatter" else active]).numel())}
            phase("sum_tree_write_case", **row)
            out.append(row)
    return out


def check_sharded_tree_kernels(torch) -> dict:
    """Kernels #8 (descend) and #9 (scatter) against their plain versions on
    one shard's sub-tree of the sharded SAC path (250,000 leaves, depth 18).
    Descend: the dispatch's n = 65,536 draws placed in the shard's interval,
    with 0, 1, 4 (the dispatch's: a head row for each of the shard's envs),
    63, 252 (a window draw's: 63 for each env) and 2016 exclusions, on
    integer-valued priorities (leaves and masses identical) and on random
    f32 ones (flips counted; none without exclusions).  Scatter: lanes with
    duplicates, inactive lanes and lanes of the other three shards, at 256,
    1,024 (a flush of 64 rows of 16 envs) and 65,536 lanes (a TD update)
    (heaps identical from slot 1, candidate max exact, the owner scratch
    clean).  Returns timing rows at the path's shapes; the descend rows have
    the sample rows' extra keys."""
    import numpy as np

    from sheeprl_tpu_torch.ops import per

    rng = np.random.default_rng(8)
    g = torch.Generator(device="cuda").manual_seed(8)
    trees = {
        "integer": tree_from_leaves(rng.integers(0, 9, SHARD_LEAVES).astype(np.float32), "cuda").tree,
        "f32": tree_from_leaves((rng.random(SHARD_LEAVES) + 0.01).astype(np.float32), "cuda").tree,
    }
    depth = (trees["f32"].numel() // 2).bit_length() - 1
    p = 1 << depth
    n = SHARDED_DRAWS
    r01 = torch.rand(n, generator=g, device="cuda")
    one_less = torch.tensor(1.0 - 1e-7, device="cuda")
    rows = {}
    floor_ms = launch_floor_ms(torch)
    for n_excl in (0, 1, 4, 63, 252, 2016):
        excl = None
        if n_excl:
            excl = torch.from_numpy(rng.choice(SHARD_LEAVES, n_excl, replace=False).astype(np.int32)).cuda()
        kw = {"scratch": per.draw_scratch(depth, n_excl, "cuda")}
        checks, u_by = {}, {}
        for label, tree in trees.items():
            m_local = tree[1] - (tree[excl.long() + p].sum() if n_excl else 0.0)
            u = torch.clamp(torch.minimum(r01, one_less) * m_local, torch.zeros((), device="cuda"), m_local * one_less)
            u_by[label] = u
            leaf, mass = per.sum_tree_descend(tree, u, depth=depth, exclude_idx=excl, **kw)
            leaf_p, mass_p = per.sum_tree_descend_plain(tree, u, depth=depth, exclude_idx=excl)
            torch.cuda.synchronize()
            same = leaf == leaf_p
            flips = int((~same).sum())
            if flips and (label == "integer" or not n_excl):
                raise AssertionError(f"sum_tree_descend E={n_excl} {label}: {flips} draws differ from the plain version")
            if not torch.equal(mass[same], mass_p[same]):
                raise AssertionError(f"sum_tree_descend E={n_excl} {label}: masses differ where the leaves agree")
            if excl is not None and bool(torch.isin(leaf, excl).any()):
                raise AssertionError(f"sum_tree_descend E={n_excl}: an excluded leaf was drawn")
            if int(leaf.max()) >= SHARD_LEAVES:
                raise AssertionError("sum_tree_descend reached a padded leaf")
            checks[label] = {"flips": flips}
        tree, u = trees["f32"], u_by["f32"]
        leaves_t = tree[p : p + SHARD_LEAVES]

        def kernel():
            return per.sum_tree_descend(tree, u, depth=depth, exclude_idx=excl, **kw)

        def plain():
            return per.sum_tree_descend_plain(tree, u, depth=depth, exclude_idx=excl)

        def library():  # the inverse-CDF descent, two calls, no exclusions
            return torch.searchsorted(torch.cumsum(leaves_t, 0), u, right=True)

        leaf = kernel()[0]
        nbytes = descent_bytes(torch, leaf, depth, n_excl)
        b_ms, b_by = bound(nbytes, descent_ops(n, depth, n_excl))
        dev_ms, dev_ops = device_ms(torch, kernel, ops=True)
        row = {
            "draws": n, "leaves": SHARD_LEAVES, "depth": depth, "exclusions": n_excl, "checks": checks, "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel, iters=50), "plain_ms": time_ms(torch, plain, iters=10),
            "library_ms": time_ms(torch, library, iters=50), "device_ms": dev_ms, "device_ops": dev_ops,
            "host_us": host_us(torch, kernel), "launch_floor_ms": floor_ms,
            "bound_bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
        }
        phase("sum_tree_descend", **row)
        rows[f"descend_e{n_excl}"] = row

    base = trees["f32"]
    owner = per.owner_scratch(depth, "cuda")
    for lanes in (256, 1024, SHARDED_DRAWS):
        leaf_idx = torch.randint(0, SHARD_LEAVES, (lanes,), generator=g, device="cuda", dtype=torch.int32)
        leaf_idx[lanes // 2 : lanes // 2 + lanes // 8] = leaf_idx[: lanes // 8]  # duplicates, of any shard ...
        vals = torch.randint(1, 40, (lanes,), generator=g, device="cuda").float() * 0.25
        vals[lanes // 2 : lanes // 2 + lanes // 16] = vals[: lanes // 16]  # ... half of them with equal values
        active = torch.rand(lanes, generator=g, device="cuda") < 0.7
        shard_ids = torch.randint(0, 4, (lanes,), generator=g, device="cuda", dtype=torch.int32)
        for rank in range(4):
            a, b = base.clone(), base.clone()
            _, cand = per.sum_tree_scatter(a, leaf_idx, vals, active, shard_ids, rank, depth=depth, owner=owner)
            _, cand_p = per.sum_tree_scatter_plain(b, leaf_idx, vals, active, shard_ids, rank, depth=depth)
            torch.cuda.synchronize()
            if not torch.equal(a[1:], b[1:]) or float(cand) != float(cand_p):
                raise AssertionError(f"sum_tree_scatter {lanes} lanes, rank {rank}: tree or candidate max differ from the plain version")
            if not bool((owner == -1).all()):
                raise AssertionError("sum_tree_scatter: the owner scratch was left dirty")
        scratch = base.clone()
        own = active & (shard_ids == 1)
        nbytes = write_bytes(torch, leaf_idx, own, depth, True) + 4 * lanes
        b_ms, b_by = bound(nbytes)

        def kernel():
            return per.sum_tree_scatter(scratch, leaf_idx, vals, active, shard_ids, 1, depth=depth, owner=owner)

        dev_ms, dev_ops = device_ms(torch, kernel, ops=True)
        row = {
            "lanes": lanes, "owned_active": int(own.sum()), "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel, iters=50),
            "plain_ms": time_ms(torch, lambda: per.sum_tree_scatter_plain(scratch, leaf_idx, vals, active, shard_ids, 1, depth=depth), iters=10),
            "library_ms": None, "device_ms": dev_ms, "device_ops": dev_ops,
            "host_us": host_us(torch, kernel), "launch_floor_ms": floor_ms,
            "bound_bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
        }
        phase("sum_tree_scatter", **row)
        rows[f"scatter_{lanes}"] = row
    rows["write_cases"] = check_write_cases(torch, base, depth, SHARD_LEAVES, ("scatter",), owner)
    del trees, base, scratch
    return rows


def check_transitions_gather(torch) -> dict:
    """The transition gather against its plain version, bytes exact: uint8
    and f32 rows of 1, 4, 24 and 96 bytes, a key with no feature axis and a
    96-byte key whose ring starts 4 bytes into its allocation (a slice: 4-byte
    chunks), successor rows that wrap the ring, with and without next keys,
    all keys in one launch; then one row (flat = 1), and the calls again
    after a ring is replaced by a new tensor behind the same key."""
    g = torch.Generator(device="cuda").manual_seed(4)
    cap, n_envs, flat = 97, 3, 1000
    bufs = {"flag": torch.randint(0, 2, (cap, n_envs), generator=g, device="cuda", dtype=torch.uint8)}
    for dtype in (torch.uint8, torch.float32):
        for nbytes in (1, 4, 24, 96):
            elems = nbytes // torch.tensor([], dtype=dtype).element_size()
            if elems:
                ring = torch.randint(0, 255, (cap, n_envs, elems), generator=g, device="cuda").to(dtype)
                bufs[f"{str(dtype)[6:]}_{nbytes}"] = ring if dtype == torch.uint8 else ring + torch.rand(ring.shape, generator=g, device="cuda")
    raw = torch.randint(0, 256, (cap * n_envs * 96 + 4,), generator=g, device="cuda", dtype=torch.uint8)
    bufs["sliced_96"] = raw[4:].view(cap, n_envs, 96)
    rows = torch.randint(0, cap, (flat,), generator=g, device="cuda", dtype=torch.int32)
    rows[:8] = cap - 1
    envs = torch.randint(0, n_envs, (flat,), generator=g, device="cuda", dtype=torch.int32)
    from sheeprl_tpu_torch.ops.gather import gather_transitions, gather_transitions_plain

    def check(what: str, n: int) -> None:
        for next_keys in ((), tuple(bufs)):
            out = gather_transitions(bufs, rows[:n], envs[:n], next_keys=next_keys)
            ref = gather_transitions_plain(bufs, rows[:n], envs[:n], next_keys=next_keys)
            torch.cuda.synchronize()
            for k in ref:
                if out[k].dtype != ref[k].dtype or not torch.equal(out[k], ref[k]):
                    raise AssertionError(f"gather_transitions '{k}' ({what}, next keys {len(next_keys)}): not byte-identical")

    check("all keys", flat)
    check("flat = 1", 1)
    bufs["float32_96"] = torch.randn(cap, n_envs, 24, generator=g, device="cuda")  # a new ring behind the key
    check("a ring replaced", flat)
    res = {"keys": {k: [str(v.dtype)[6:], v[0, 0].numel() * v.element_size()] for k, v in bufs.items()},
           "rows": [flat, 1], "next_keys": [0, len(bufs)], "sliced_base_mod_16": bufs["sliced_96"].data_ptr() % 16,
           "ring_replaced": True, "bytes_exact": True}
    phase("gather_transitions_check", **res)
    return res


def time_transitions_gather(torch, cache, leaves) -> dict:
    """The transition gather at the SAC dispatch's shape (one draw's rows on
    the full-size rings): kernel, plain version, per-key ``index_select``
    (event and device time), the wrapper's host time a call, its device
    operations and the launch floor of the ctypes route."""
    from sheeprl_tpu_torch.ops.gather import gather_transitions, gather_transitions_plain

    bufs = cache.buffers
    flat_leaves = leaves.reshape(-1).long()
    rows = (flat_leaves // cache.n_envs).to(torch.int32).contiguous()
    envs = (flat_leaves % cache.n_envs).to(torch.int32).contiguous()
    flat = {k: v.reshape(cache.capacity * cache.n_envs, -1) for k, v in bufs.items()}
    row_bytes = sum(v[0, 0].numel() * v.element_size() for v in bufs.values())
    n = int(rows.numel())
    out = gather_transitions(bufs, rows, envs)
    ref = gather_transitions_plain(bufs, rows, envs)
    torch.cuda.synchronize()
    if any(not torch.equal(out[k], ref[k]) for k in ref):
        raise AssertionError("gather_transitions: not byte-identical at the SAC shape")
    b_ms, b_by = bound(2 * n * row_bytes + 8 * n)

    def kernel():
        return gather_transitions(bufs, rows, envs)

    def library():
        return [v.index_select(0, flat_leaves) for v in flat.values()]

    dev_ms, dev_ops = device_ms(torch, kernel, ops=True)
    res = {
        "rows": n, "row_bytes": row_bytes, "max_abs_err": 0.0,
        "ms": time_ms(torch, kernel, iters=50),
        "plain_ms": time_ms(torch, lambda: gather_transitions_plain(bufs, rows, envs), iters=50),
        "library_ms": time_ms(torch, library, iters=50),
        "device_ms": dev_ms, "device_ops": dev_ops, "library_device_ms": device_ms(torch, library),
        "host_us": host_us(torch, kernel), "launch_floor_ms": launch_floor_ms(torch),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    phase("gather_transitions", **res)
    return res


# ------------------------------------------------------------------ SAC
_DISPATCH_PARTS = ("add", "sample_transitions_per", "update_priorities")


def _time_parts(cache, sink: dict) -> None:
    """Wrap the cache's calls that a dispatch makes around its train
    function, adding each call's host time (ms, no synchronisation added)
    to ``sink``; ``del cache.<name>`` restores each."""
    for name in _DISPATCH_PARTS:
        inner = getattr(cache, name)

        def timed(*a, _inner=inner, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _inner(*a, **kw)
            finally:
                sink[_name] = sink.get(_name, 0.0) + (time.perf_counter() - t0) * 1e3

        setattr(cache, name, timed)


class _Space:
    def __init__(self, shape, low=None, high=None):
        self.shape = tuple(shape)
        self.low, self.high = low, high


def walker_transitions(rng, rows: int, n_envs: int, t0: int = 0) -> dict:
    """Seeded transitions shaped like DMC walker-walk's, in the layout SAC's
    ``main`` stores: 24-d observations and next observations, 6 actions in
    [-1, 1], f32 rewards, uint8 terminated/truncated (an episode every 1000
    steps)."""
    import numpy as np

    obs = rng.standard_normal((rows, n_envs, WALKER_OBS), dtype=np.float32)
    steps = np.arange(t0, t0 + rows)[:, None, None]
    return {
        "terminated": np.zeros((rows, n_envs, 1), np.uint8),
        "truncated": np.broadcast_to(steps % 1000 == 999, (rows, n_envs, 1)).astype(np.uint8),
        "actions": rng.uniform(-1, 1, (rows, n_envs, WALKER_ACTIONS)).astype(np.float32),
        "observations": obs,
        "next_observations": obs + 0.05 * rng.standard_normal(obs.shape, dtype=np.float32),
        "rewards": rng.random((rows, n_envs, 1), dtype=np.float32),
    }


def fill_walker_replay(cfg, runtime, capacity: int, *, seed: int = 5, chunk: int = 25000, windows: int = 2) -> tuple:
    """The SAC replay at its real size: the host ``ReplayBuffer.add`` of more
    rows than fit (the ring wraps), the cache from
    ``maybe_create_for_transitions`` (``load_from_replay``: the rings and
    every stored cell at priority 1), ``load_priority_state(None)``, then
    ``windows`` windowed adds of ``dispatch_batch`` rows as the env loop's
    flush makes them (seeded at the running max through the write kernel).
    Raises unless the rings equal the host buffer byte for byte."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import maybe_create_for_transitions

    n_envs = int(cfg.env.num_envs) * runtime.world_size  # JAX's total_envs
    rng = np.random.default_rng(seed)
    rb = ReplayBuffer(capacity, n_envs, obs_keys=("observations",))
    t0 = time.perf_counter()
    total = capacity + capacity // 50
    for start in range(0, total, chunk):
        rb.add(walker_transitions(rng, min(chunk, total - start), n_envs, start))
    cache = maybe_create_for_transitions(cfg, runtime, rb)
    cache.load_priority_state(None)
    step = total
    for _ in range(windows):
        w = walker_transitions(rng, int(cfg.algo.dispatch_batch), n_envs, step)
        step += int(cfg.algo.dispatch_batch)
        rb.add(w)
        cache.add(w)
    if runtime.device.type != "cpu":
        torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    for k, ring in cache.buffers.items():
        if not torch.equal(ring, torch.from_numpy(np.ascontiguousarray(rb.buffer[k])).to(ring.device)):
            raise AssertionError(f"device ring '{k}' differs from the host buffer")
    if int(cache._pos[0]) != rb._pos:
        raise AssertionError("device cache and host buffer write heads differ")
    return rb, cache, step, {
        "rows": capacity, "envs": n_envs, "written": step * n_envs, "fill_s": fill_s,
        "ring_bytes": sum(t.numel() * t.element_size() for t in cache.buffers.values()),
        "tree_leaves": cache.tree.n_leaves, "tree_depth": cache.tree.depth, "tree_total": cache.tree.total,
    }


def run_sac(cfg, device, *, dispatches: int = SAC_DISPATCHES, capacity=None, profile: bool = True) -> dict:
    """The SAC phase: the walker replay of :func:`fill_walker_replay`, the
    agent from ``cfg.seed``, ``dispatches`` calls of ``train_dispatch`` (each
    first flushing ``dispatch_batch`` pending env rows, then G = 64 steps of
    B = 256 on one prioritized draw) with the kernels, then the same calls
    from the same state with ``per_kernel=lax``.  The launch counters are
    set to 0 just before the kernel run and read just after it."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import make_train_state, train_dispatch
    from sheeprl_tpu_torch.ops import per
    from sheeprl_tpu_torch.ops.gather import gather_transitions
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
    from sheeprl_tpu_torch.replay import per_beta_schedule

    n_envs = int(cfg.env.num_envs)
    capacity = capacity or int(cfg.buffer.size) // n_envs
    runtime = MeshRuntime(device=device, precision=cfg.fabric.precision, seed=int(cfg.seed)).launch()
    rb, cache, written, fill = fill_walker_replay(cfg, runtime, capacity)
    phase("sac_replay_fill", **fill)
    ones = np.ones(WALKER_ACTIONS, np.float32)
    agent, target_entropy = build_agent(
        runtime, cfg, {"state": _Space((WALKER_OBS,))}, _Space((WALKER_ACTIONS,), -ones, ones)
    )
    initial = copy.deepcopy(agent.state_dict())
    # each run starts from this replay state: the dispatches' flushes overwrite rows
    rings0 = {k: v.clone() for k, v in cache.buffers.items()}
    tree0, max0 = cache.tree.tree.clone(), cache.tree.max_priority.clone()
    pos0, filled0 = cache._pos.copy(), cache._filled.copy()
    g = int(cfg.algo.dispatch_batch)
    batch = int(cfg.algo.per_rank_batch_size)
    ema_every = int(cfg.algo.critic.target_network_frequency) // n_envs + 1
    beta_fn = per_beta_schedule(cfg.buffer.per_beta, cfg.buffer.per_beta_end, int(cfg.algo.total_steps))
    windows = [walker_transitions(np.random.default_rng(100 + d), g, n_envs, written + d * g) for d in range(dispatches)]
    counters = (per.sum_tree_sample, per.sum_tree_write, per.sum_tree_update, gather_transitions)

    def run(kernels: bool, n: int) -> dict:
        agent.load_state_dict(initial)
        cache.kernel = "pallas" if kernels else "lax"
        for k, ring in cache.buffers.items():
            ring.copy_(rings0[k])
        cache.tree.tree.copy_(tree0)
        cache.tree.max_priority = max0.clone()
        cache._pos[:], cache._filled[:] = pos0, filled0
        state = make_train_state(runtime, agent, cfg, target_entropy, prioritized=True)
        gen = torch.Generator(device=device).manual_seed(int(cfg.seed))
        leaves, metrics, ms = [], [], []
        inner = cache.sample_transitions_per

        def recording(*a, **kw):
            out, idx = inner(*a, **kw)
            leaves.append(idx.clone())
            return out, idx

        cache.sample_transitions_per = recording
        parts = {}
        _time_parts(cache, parts)
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        try:
            for d in range(n):
                pending = [{k: v[i : i + 1] for k, v in windows[d].items()} for i in range(g)]
                iters = range(written + d * g, written + (d + 1) * g)
                policy_step = (written + (d + 1) * g) * n_envs
                t0 = time.perf_counter()
                m = train_dispatch(state, rb, cache, cfg, [it % ema_every == 0 for it in iters], policy_step, beta_fn, pending, gen)
                if device != "cpu":
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            for name in _DISPATCH_PARTS:
                delattr(cache, name)
        launches = {c.__name__: c.launches for c in counters}
        for i, mm in enumerate(metrics):
            bad = [k for k, v in mm.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"SAC dispatch {i}: non-finite {bad}")
        return {
            "metrics": metrics, "ms": ms, "launches": launches, "leaves": leaves,
            "host_ms_per_dispatch": {k: v / n for k, v in parts.items()},
            "params": {k: v.detach().clone() for k, v in agent.state_dict().items()},
            "tree": cache.tree.tree.clone(), "max_priority": float(cache.tree.max_priority),
            "max_memory_allocated": torch.cuda.max_memory_allocated() if device != "cpu" else None,
            "state": state,
        }

    run(False, 1)  # warm both paths' per-shape state
    run(True, 1)
    fast = run(True, dispatches)
    plain = run(False, dispatches)
    if device != "cpu":
        want = {"sum_tree_sample": dispatches, "sum_tree_write": dispatches, "sum_tree_update": dispatches,
                "gather_transitions": dispatches}
        if fast["launches"] != want:
            raise AssertionError(f"SAC kernel launches {fast['launches']}, want {want}")
        if any(plain["launches"].values()):
            raise AssertionError(f"per_kernel=lax launched kernels: {plain['launches']}")
    for d, (a, b) in enumerate(zip(fast["leaves"], plain["leaves"])):
        if not torch.equal(a, b):
            raise AssertionError(f"SAC dispatch {d}: {int((a != b).sum())} sampled leaves differ between the kernels and lax")
    worst_loss = {}
    for d, (a, b) in enumerate(zip(fast["metrics"], plain["metrics"])):
        for k in a:
            diff = abs(a[k] - b[k])
            if diff > SAC_LOSS_RTOL * abs(b[k]) + 1e-7:
                raise AssertionError(f"SAC dispatch {d} {k}: kernels {a[k]} vs lax {b[k]} (rtol {SAC_LOSS_RTOL})")
            worst_loss[k] = max(worst_loss.get(k, 0.0), diff / max(abs(b[k]), 1e-30))
    worst_param = max(float((fast["params"][k] - plain["params"][k]).abs().max()) for k in fast["params"])
    if worst_param > SAC_PARAM_ATOL:
        raise AssertionError(f"SAC parameters differ by {worst_param} > {SAC_PARAM_ATOL}")
    tree_err = float(((fast["tree"] - plain["tree"]).abs() / plain["tree"].abs().clamp_min(1e-30))[1:].max())
    if tree_err > SAC_TREE_RTOL or abs(fast["max_priority"] - plain["max_priority"]) > SAC_TREE_RTOL * plain["max_priority"]:
        raise AssertionError(f"SAC trees differ by {tree_err} (max priority {fast['max_priority']} vs {plain['max_priority']})")
    res = {
        "dispatches": dispatches, "gradient_steps_per_dispatch": g, "batch": batch,
        "params": sum(p.numel() for p in agent.parameters()),
        "losses_kernels": fast["metrics"], "losses_lax": plain["metrics"], "max_rel_diff": worst_loss,
        "max_abs_param_diff": worst_param, "param_atol": SAC_PARAM_ATOL,
        "max_rel_tree_diff": tree_err, "max_priority": fast["max_priority"],
        "leaves_identical": True, "dispatch_ms_kernels": fast["ms"], "dispatch_ms_lax": plain["ms"],
        "host_ms_per_dispatch_kernels": fast["host_ms_per_dispatch"],
        "host_ms_per_dispatch_lax": plain["host_ms_per_dispatch"],
        "launches": fast["launches"], "max_memory_allocated": fast["max_memory_allocated"],
        "max_memory_allocated_lax": plain["max_memory_allocated"],
    }
    if device != "cpu":
        res["gather"] = time_transitions_gather(torch, cache, fast["leaves"][-1])
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            # device time of one more dispatch; the idle share is taken
            # against the kernel run's dispatch time without the profiler
            cache.kernel = "pallas"
            gen = torch.Generator(device=device).manual_seed(0)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                train_dispatch(fast["state"], rb, cache, cfg, [True] * g, fill["written"], beta_fn, None, gen)
                torch.cuda.synchronize()
            res["profile"] = _device_time(torch, prof, 1, float(np.mean(fast["ms"])))
    return res


def run_sac_sharded(cfg, device, *, dispatches: int = SAC_DISPATCHES, capacity=None, profile: bool = True,
                    single_ms=None) -> dict:
    """The env-sharded SAC phase: ``cfg.fabric.devices`` shards on one device.

    1. Fill: the walker replay of :func:`fill_walker_replay` through
       ``maybe_create_for_transitions`` on a ``MeshRuntime(devices=4)``,
       which builds the sharded cache, with JAX's ``main``'s sizes:
       ``env.num_envs`` envs a shard and ``buffer.size`` over all the envs;
       each shard's rings must equal its envs' columns of the host buffer
       byte for byte.
    2. State against a single-device tree: the same integer priorities on
       the sharded tree and on a ``PriorityTree`` of all the cells; totals
       and ``state_dict()["leaves"]`` equal; over 25 draws of G x B each
       shard's share of the draws within 4 binomial standard errors of its
       share of the mass.
    3. The uniform sharded transition and window draws with the kernels
       against lax: bytes equal, one gather launch a shard.
    4. ``dispatches`` calls of ``train_dispatch`` with the kernels, then the
       same calls from the same state with ``per_kernel=lax``: identical
       leaves, losses, parameters and trees within the SAC phase's
       tolerances.  The launch counters are set to 0 just before the kernel
       run and read just after it.
    5. The sharded window draw: ``sample_per(1, 16, 64)`` (63 exclusions an
       env, decay after the draw) with the kernels against lax: identical
       starts and decayed trees, windows equal to the rows they start at."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import make_train_state, train_dispatch
    from sheeprl_tpu_torch.data.device_buffer import ShardedDeviceReplayCache
    from sheeprl_tpu_torch.ops import per
    from sheeprl_tpu_torch.ops.gather import gather_transitions, gather_windows, gather_windows_plain
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
    from sheeprl_tpu_torch.replay import PriorityTree, per_beta_schedule

    n_shards = int(cfg.fabric.devices)
    n_envs = int(cfg.env.num_envs) * n_shards  # JAX's total_envs
    capacity = capacity or int(cfg.buffer.size) // n_envs
    runtime = MeshRuntime(device=device, precision=cfg.fabric.precision, seed=int(cfg.seed), devices=n_shards).launch()
    rb, cache, written, fill = fill_walker_replay(cfg, runtime, capacity)
    if type(cache) is not ShardedDeviceReplayCache:
        raise AssertionError(f"a {n_shards}-shard mesh built {type(cache).__name__}")
    n_local = n_envs // n_shards
    for r in range(n_shards):
        for k, ring in cache.shard_buffers(r).items():
            host = np.ascontiguousarray(rb.buffer[k][:, r * n_local : (r + 1) * n_local])
            if not torch.equal(ring, torch.from_numpy(host).to(ring.device)):
                raise AssertionError(f"shard {r} ring '{k}' differs from its envs' columns of the host buffer")
    fill.update(shards=n_shards, envs_per_shard=n_local, shard_leaves=cache.tree.n_leaves_local)
    phase("sac_sharded_fill", **fill)
    sync = (lambda: torch.cuda.synchronize()) if runtime.device.type == "cuda" else (lambda: None)

    # 2. the sharded tree against a single-device tree of the same cells
    tree = cache.tree
    n_cells = tree.n_leaves
    pri = np.random.default_rng(9).integers(1, 9, n_cells).astype(np.float32)
    single = PriorityTree(n_cells, device=runtime.device, kernel="pallas")
    single.set_priorities(torch.arange(n_cells, device=runtime.device), torch.from_numpy(pri).to(runtime.device))
    tree.set_priorities(torch.arange(n_cells, device=runtime.device), torch.from_numpy(pri).to(runtime.device))
    sync()
    if tree.total != single.total or not np.array_equal(tree.state_dict()["leaves"], single.state_dict()["leaves"]):
        raise AssertionError("the sharded tree's total or leaves differ from the single-device tree's")
    del single
    g, batch = int(cfg.algo.dispatch_batch), int(cfg.algo.per_rank_batch_size) * n_shards  # train_dispatch's batch
    gen = torch.Generator(device=runtime.device).manual_seed(11)
    counts = torch.zeros(n_shards, dtype=torch.int64, device=runtime.device)
    for _ in range(SHARE_DRAWS):
        _, lv = cache.sample_transitions_per(g, batch, gen, 0.4)
        counts += torch.bincount((lv.reshape(-1).long() % n_envs) // n_local, minlength=n_shards)
    draws_total = SHARE_DRAWS * g * batch
    mass = tree.trees[:, 1].double().cpu().numpy()
    share_mass = mass / mass.sum()
    share = counts.cpu().numpy() / draws_total
    sigmas = np.abs(share - share_mass) / np.sqrt(share_mass * (1 - share_mass) / draws_total)
    if sigmas.max() > SHARE_SIGMAS:
        raise AssertionError(f"shard draw shares {share} against mass shares {share_mass}: {sigmas.max()} standard errors")
    state_check = {"total": tree.total, "leaves_equal": True, "draws": draws_total, "share_of_draws": share.tolist(),
                   "share_of_mass": share_mass.tolist(), "max_std_errors": float(sigmas.max())}

    # 3. the stratified uniform draw through the transition gather, kernels against lax
    flat_local = g * batch // n_shards
    envs = torch.randint(0, n_local, (n_shards, flat_local), generator=gen, device=runtime.device, dtype=torch.int32)
    u = torch.rand((n_shards, flat_local), generator=gen, device=runtime.device)
    uniform = {}
    for kernel in ("pallas", "lax"):
        cache.kernel = kernel
        gather_transitions.launches = 0
        uniform[kernel] = cache.sample_transitions(g, batch, envs=envs, u=u)
        uniform[kernel + "_launches"] = gather_transitions.launches
    sync()
    if any(not torch.equal(uniform["pallas"][k], uniform["lax"][k]) for k in uniform["lax"]):
        raise AssertionError("the sharded uniform transition draw differs between the kernels and lax")
    if runtime.device.type == "cuda" and uniform["pallas_launches"] != n_shards:
        raise AssertionError(f"the sharded uniform draw launched the gather {uniform['pallas_launches']} times")
    # ... and the stratified uniform window draw through the window gather
    seq_len, starts_n = 64, 16
    envs = torch.randint(0, n_local, (n_shards, starts_n // n_shards), generator=gen, device=runtime.device, dtype=torch.int32)
    u = torch.rand((n_shards, starts_n // n_shards), generator=gen, device=runtime.device)
    for kernel in ("pallas", "lax"):
        cache.kernel = kernel
        gather_windows.launches = 0
        uniform["w_" + kernel] = cache.sample(1, starts_n, seq_len, envs=envs, u=u)[0]
        uniform["w_" + kernel + "_launches"] = gather_windows.launches
    sync()
    if any(not torch.equal(uniform["w_pallas"][k], uniform["w_lax"][k]) for k in uniform["w_lax"]):
        raise AssertionError("the sharded uniform window draw differs between the kernels and lax")
    if runtime.device.type == "cuda" and uniform["w_pallas_launches"] != n_shards:
        raise AssertionError(f"the sharded uniform window draw launched the gather {uniform['w_pallas_launches']} times")
    state_check["uniform_bytes_equal"] = True
    state_check["uniform_gather_launches"] = uniform["pallas_launches"]
    state_check["uniform_window_gather_launches"] = uniform["w_pallas_launches"]
    del uniform

    # 4. dispatches, kernels then lax, from the same state
    ones = np.ones(WALKER_ACTIONS, np.float32)
    agent, target_entropy = build_agent(
        runtime, cfg, {"state": _Space((WALKER_OBS,))}, _Space((WALKER_ACTIONS,), -ones, ones)
    )
    initial = copy.deepcopy(agent.state_dict())
    rings0 = {k: v.clone() for k, v in cache.buffers.items()}
    trees0, max0 = tree.trees.clone(), tree.max_priority.clone()
    pos0, filled0 = cache._pos.copy(), cache._filled.copy()
    ema_every = int(cfg.algo.critic.target_network_frequency) // n_envs + 1
    beta_fn = per_beta_schedule(cfg.buffer.per_beta, cfg.buffer.per_beta_end, int(cfg.algo.total_steps))
    windows = [walker_transitions(np.random.default_rng(200 + d), g, n_envs, written + d * g) for d in range(dispatches)]
    counters = (per.sum_tree_descend, per.sum_tree_scatter, per.sum_tree_sample, per.sum_tree_write,
                per.sum_tree_update, gather_transitions)

    def restore(kernel: str) -> None:
        cache.kernel = kernel
        for k, ring in cache.buffers.items():
            ring.copy_(rings0[k])
        tree.trees.copy_(trees0)
        tree.max_priority = max0.clone()
        cache._pos[:], cache._filled[:] = pos0, filled0

    def run(kernels: bool, n: int) -> dict:
        agent.load_state_dict(initial)
        restore("pallas" if kernels else "lax")
        state = make_train_state(runtime, agent, cfg, target_entropy, prioritized=True)
        gen = torch.Generator(device=runtime.device).manual_seed(int(cfg.seed))
        leaves, metrics, ms = [], [], []
        inner = cache.sample_transitions_per

        def recording(*a, **kw):
            out, idx = inner(*a, **kw)
            leaves.append(idx.clone())
            return out, idx

        cache.sample_transitions_per = recording
        parts = {}
        _time_parts(cache, parts)
        sync()
        if runtime.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        try:
            for d in range(n):
                pending = [{k: v[i : i + 1] for k, v in windows[d].items()} for i in range(g)]
                iters = range(written + d * g, written + (d + 1) * g)
                policy_step = (written + (d + 1) * g) * n_envs
                t0 = time.perf_counter()
                m = train_dispatch(state, rb, cache, cfg, [it % ema_every == 0 for it in iters], policy_step, beta_fn, pending, gen)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            for name in _DISPATCH_PARTS:
                delattr(cache, name)
        launches = {c.__name__: c.launches for c in counters}
        for i, mm in enumerate(metrics):
            bad = [k for k, v in mm.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"sharded SAC dispatch {i}: non-finite {bad}")
        return {
            "metrics": metrics, "ms": ms, "launches": launches, "leaves": leaves,
            "host_ms_per_dispatch": {k: v / n for k, v in parts.items()},
            "params": {k: v.detach().clone() for k, v in agent.state_dict().items()},
            "trees": tree.trees.clone(), "max_priority": float(tree.max_priority),
            "max_memory_allocated": torch.cuda.max_memory_allocated() if runtime.device.type == "cuda" else None,
            "state": state,
        }

    run(False, 1)  # warm both paths' per-shape state
    run(True, 1)
    fast = run(True, dispatches)
    plain = run(False, dispatches)
    if runtime.device.type == "cuda":
        # a dispatch: one descent per shard, and one scatter per shard for the
        # flush's seeding and one for the TD update; no single-tree kernel
        want = {"sum_tree_descend": n_shards * dispatches, "sum_tree_scatter": 2 * n_shards * dispatches,
                "sum_tree_sample": 0, "sum_tree_write": 0, "sum_tree_update": 0, "gather_transitions": 0}
        if fast["launches"] != want:
            raise AssertionError(f"sharded SAC kernel launches {fast['launches']}, want {want}")
    if any(plain["launches"].values()):
        raise AssertionError(f"per_kernel=lax launched kernels: {plain['launches']}")
    for d, (a, b) in enumerate(zip(fast["leaves"], plain["leaves"])):
        if not torch.equal(a, b):
            raise AssertionError(f"sharded SAC dispatch {d}: {int((a != b).sum())} sampled leaves differ between the kernels and lax")
    worst_loss = {}
    for d, (a, b) in enumerate(zip(fast["metrics"], plain["metrics"])):
        for k in a:
            diff = abs(a[k] - b[k])
            if diff > SAC_LOSS_RTOL * abs(b[k]) + 1e-7:
                raise AssertionError(f"sharded SAC dispatch {d} {k}: kernels {a[k]} vs lax {b[k]} (rtol {SAC_LOSS_RTOL})")
            worst_loss[k] = max(worst_loss.get(k, 0.0), diff / max(abs(b[k]), 1e-30))
    worst_param = max(float((fast["params"][k] - plain["params"][k]).abs().max()) for k in fast["params"])
    if worst_param > SAC_PARAM_ATOL:
        raise AssertionError(f"sharded SAC parameters differ by {worst_param} > {SAC_PARAM_ATOL}")
    tree_err = float(((fast["trees"] - plain["trees"]).abs() / plain["trees"].abs().clamp_min(1e-30))[:, 1:].max())
    if tree_err > SAC_TREE_RTOL or abs(fast["max_priority"] - plain["max_priority"]) > SAC_TREE_RTOL * plain["max_priority"]:
        raise AssertionError(f"sharded SAC trees differ by {tree_err} (max priority {fast['max_priority']} vs {plain['max_priority']})")

    # 5. the sharded window draw: 63 exclusions an env, decayed after
    starts = {}
    for kernel in ("pallas", "lax"):
        restore(kernel)
        inner = cache._sharded_per

        def recording(*a, **kw):
            out, idx = inner(*a, **kw)
            starts[kernel] = idx.clone()
            return out, idx

        cache._sharded_per = recording
        try:
            per.sum_tree_descend.launches = per.sum_tree_scatter.launches = 0
            got = cache.sample_per(1, 16, seq_len, torch.Generator(device=runtime.device).manual_seed(12), beta=0.0)[0]
            starts[kernel + "_launches"] = {"sum_tree_descend": per.sum_tree_descend.launches,
                                            "sum_tree_scatter": per.sum_tree_scatter.launches}
        finally:
            del cache._sharded_per
        starts[kernel + "_trees"] = tree.trees.clone()
        lv = starts[kernel].reshape(-1).long()
        ref = gather_windows_plain(cache.buffers, (lv // n_envs).to(torch.int32), (lv % n_envs).to(torch.int32),
                                   seq_len=seq_len, batch_size=16)
        if any(not torch.equal(got[k], ref[k][0]) for k in ref):
            raise AssertionError(f"sharded window draw ({kernel}): a window is not the ring's rows from its start")
        head = torch.from_numpy(cache._pos).to(runtime.device)[lv % n_envs]
        behind = (head - lv // n_envs) % capacity  # the L - 1 rows before the head cannot start a window
        if bool(((behind >= 1) & (behind < seq_len)).any()):
            raise AssertionError(f"sharded window draw ({kernel}): a start within L - 1 rows of its env's head")
    sync()
    if not torch.equal(starts["pallas"], starts["lax"]) or not torch.equal(starts["pallas_trees"][:, 1:], starts["lax_trees"][:, 1:]):
        raise AssertionError("sharded window draw: starts or decayed trees differ between the kernels and lax")
    if runtime.device.type == "cuda" and starts["pallas_launches"] != {"sum_tree_descend": n_shards, "sum_tree_scatter": n_shards}:
        raise AssertionError(f"sharded window draw launches {starts['pallas_launches']}")
    window_check = {"starts": 16, "seq_len": seq_len, "exclusions_per_shard": (seq_len - 1) * n_local,
                    "decay": cache.per_decay, "starts_identical": True, "trees_identical": True,
                    "launches": starts["pallas_launches"]}

    res = {
        "shards": n_shards, "envs": n_envs, "dispatches": dispatches, "gradient_steps_per_dispatch": g, "batch": batch,
        "per_rank_batch_size": int(cfg.algo.per_rank_batch_size),
        "state_check": state_check, "window_draw": window_check,
        "losses_kernels": fast["metrics"], "losses_lax": plain["metrics"], "max_rel_diff": worst_loss,
        "max_abs_param_diff": worst_param, "param_atol": SAC_PARAM_ATOL,
        "max_rel_tree_diff": tree_err, "max_priority": fast["max_priority"],
        "leaves_identical": True, "dispatch_ms_kernels": fast["ms"], "dispatch_ms_lax": plain["ms"],
        "dispatch_ms_single_device": single_ms,
        "host_ms_per_dispatch_kernels": fast["host_ms_per_dispatch"],
        "host_ms_per_dispatch_lax": plain["host_ms_per_dispatch"],
        "launches": fast["launches"], "max_memory_allocated": fast["max_memory_allocated"],
        "max_memory_allocated_lax": plain["max_memory_allocated"],
    }
    if runtime.device.type == "cuda" and profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        # device time of one more dispatch; the idle share is taken against
        # the kernel run's dispatch time without the profiler
        cache.kernel = "pallas"
        gen = torch.Generator(device=runtime.device).manual_seed(0)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_dispatch(fast["state"], rb, cache, cfg, [True] * g, fill["written"], beta_fn, None, gen)
            torch.cuda.synchronize()
        res["profile"] = _device_time(torch, prof, 1, float(np.mean(fast["ms"])))
    del cache
    return res


def prioritized_starts(cfg, runtime, agent, rb, actions_dim, *, draws: int = 3) -> dict:
    """Path B: prioritized sequence starts on the XL ring.  A prioritized
    cache over the training phase's host buffer (every stored cell at 1),
    ``draws`` calls of ``sample_per`` (63 exclusions, decay 0.5 after each)
    with the kernels, then one XL train step on a prioritized draw, the
    sum-tree launch counters set to 0 just before and read just after;
    then the same draws from the same tree through the plain tree
    functions.  Starts must be identical (the priorities are dyadic, so every
    sum is exact) and the batches bytes equal."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_state, train_steps
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayCache
    from sheeprl_tpu_torch.ops import per
    from sheeprl_tpu_torch.ops.gather import gather_windows

    device = runtime.device
    seq_len, batch = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    cache = DeviceReplayCache(
        rb.buffer_size, rb.n_envs, device=device, prioritized=True, per_alpha=float(cfg.buffer.per_alpha),
        per_eps=float(cfg.buffer.per_eps), per_decay=cfg.buffer.per_decay_on_sample, kernel="pallas",
    )
    cache.load_from(rb)
    tree0 = cache.tree.tree.clone()
    counters = (per.sum_tree_sample, per.sum_tree_write, gather_windows)

    def sample(kernel: str) -> tuple:
        cache.kernel = kernel
        cache.tree.tree.copy_(tree0)
        gen = torch.Generator(device=device).manual_seed(7)
        starts, batches = [], []
        inner = cache.tree.sample

        def recording(*a, **kw):
            leaf, w = inner(*a, **kw)
            starts.append(leaf.clone())
            return leaf, w

        cache.tree.sample = recording
        try:
            for _ in range(draws):
                batches.append(cache.sample_per(1, batch, seq_len, gen, beta=0.0)[0])
        finally:
            del cache.tree.sample
        return starts, batches

    if device.type != "cpu":
        torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    fast_starts, fast_batches = sample("pallas")
    state = make_train_state(runtime, agent, cfg, False, actions_dim)
    metrics = train_steps(state, rb, cache, cfg, 1, torch.Generator(device=device).manual_seed(8))
    if device.type != "cpu":
        torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    losses = {k: float(v) for k, v in metrics[0].items()}
    bad = [k for k, v in losses.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"XL train step on a prioritized draw: non-finite {bad}")
    plain_starts, plain_batches = sample("lax")
    flips = sum(int((a != b).sum()) for a, b in zip(fast_starts, plain_starts))
    if flips:
        raise AssertionError(f"prioritized starts: {flips} of {draws * batch} differ between the kernels and the plain tree")
    for a, b in zip(fast_batches, plain_batches):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"prioritized draw '{k}': batches differ where the starts agree")
    want = {"sum_tree_sample": draws + 1, "sum_tree_write": draws + 1, "gather_windows": draws + 1}
    if device.type != "cpu" and launches != want:
        raise AssertionError(f"prioritized starts: kernel launches {launches}, want {want}")
    res = {
        "draws": draws, "exclusions": (seq_len - 1) * rb.n_envs, "decay": cache.per_decay, "start_flips": flips,
        "batches_bytes_equal": True, "train_step_losses": losses, "launches": launches,
        "tree_total_after": cache.tree.total,
    }
    del cache
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
    if "gru_sequence" in n:
        return "gru_sequence (hand-written)"
    if "gru_" in n:
        return "gru_cell (hand-written)"
    if "gather_kernelilb1" in n:  # csrc/gather.cu: gather_kernel<true>
        return "gather_windows (hand-written)"
    if "gather_kernelilb0" in n:
        return "gather_transitions (hand-written)"
    if any(k in n for k in ("sample_kernel", "descend_kernel", "normalize_kernel", "claim_kernel", "write_leaves", "rebuild_level")):
        return "sum_tree (hand-written)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(k in n for k in ("conv", "implicit", "winograd", "fft", "wgrad", "dgrad")):
        return "convolutions (cuDNN)"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n:
        return "matmuls (cuBLAS)"
    return "elementwise/reductions"


def _device_time(torch, prof, steps: int, step_ms: float) -> dict:
    """Device time per step by kernel and by group from a profiler window
    of ``steps`` steps, and the device's idle share of ``step_ms``."""
    kernels, groups, launches = {}, {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        kernels[ev.key] = kernels.get(ev.key, 0.0) + t / 1e3 / steps
        launches += ev.count
    for name, ms in kernels.items():
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "step_ms": step_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / step_ms),
        "device_ops_per_step": launches / steps,
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


def _cases(cases: list, kind: str) -> list:
    """A write kind's boundary cases (:func:`check_write_cases`) for its entry."""
    return [{k: c[k] for k in ("lanes", "device_ms", "device_ops")} for c in cases if c["kind"] == kind]


# the keys every entry of the kernels line has, with the meaning the line's contract gives them
KERNEL_LINE_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")


def _kernel_entry(name: str, source: str, replaces: str, launches: dict, row: dict, shape: str, **extra) -> dict:
    """One entry of the ``kernels`` line from a kernel's timing row;
    ``extra`` adds keys and may not replace one of :data:`KERNEL_LINE_KEYS`
    (``route`` is the build route, ``cuda``, not a kernel's own route)."""
    clash = sorted(set(extra) & set(KERNEL_LINE_KEYS))
    if clash:
        raise ValueError(f"{name}: extra keys {clash} would replace the kernels line's own")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "launches_by_path": launches,
        **{k: row[k] for k in keys}, "shape": shape, **extra,
    }


_MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Independent mma.sync products on registers, 8 accumulators a warp: the
// rate the tensor cores give the legacy (pre-wgmma) MMA path.
template <int BF16>
__global__ void mma_peak(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3, b0 = a0 * 3, b1 = a0 * 5;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16)
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_run(int bf16, float* out, int blocks, int iters) {
  if (bf16) mma_peak<1><<<blocks, 256>>>(out, iters); else mma_peak<0><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _to(tree, device):
    """Every tensor of a nested dict or list, on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _max_err(a, b) -> float:
    return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())


def ppo_setup(torch, cfg, device: str):
    """The PPO of ``cfg`` on ``device``: runtime, agent, optimizer state,
    fused collector and update, as the port's loop builds them."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import build_ppo_optimizer, make_update_fn
    from sheeprl_tpu_torch.envs.spaces import action_space_dims
    from sheeprl_tpu_torch.envs.device.collect import FusedOnPolicyCollector
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
    from sheeprl_tpu_torch.utils.env import make_train_envs
    from sheeprl_tpu_torch.utils.utils import trainable_params

    runtime = MeshRuntime(device=device, precision=cfg.fabric.precision, seed=int(cfg.seed)).launch()
    envs = make_train_envs(cfg, runtime)
    actions_dim, cont = action_space_dims(envs.single_action_space)
    agent = build_agent(runtime, actions_dim, cont, cfg, envs.single_observation_space)
    tx = build_ppo_optimizer(cfg.algo.optimizer, cfg.algo.max_grad_norm, runtime.precision)
    keys = list(cfg.algo.mlp_keys.encoder)
    collector = FusedOnPolicyCollector(envs=envs, agent=agent, cfg=cfg, runtime=runtime, obs_keys=keys,
                                       total_envs=envs.num_envs)
    return {"runtime": runtime, "agent": agent, "opt": tx.init(trainable_params(agent)), "collector": collector,
            "update": make_update_fn(runtime, agent, tx, cfg, keys)}


def run_ppo_training(device: str, *, overrides=(), iters: int = PPO_ITERS, collect_envs: int = PPO_COLLECT_ENVS,
                     profile: bool = True) -> dict:
    """PPO on CartPole at the published config on ``device``: the card's
    first rollout and update against the same on the CPU (same parameters,
    noise, data and permutations), ``iters`` timed iterations of the fused
    collect and ``make_update_fn``, one more under the profiler, and one
    collect-only reading at ``collect_envs`` envs."""
    import torch

    from sheeprl_tpu_torch.algos.ppo.ppo import epoch_permutations
    from sheeprl_tpu_torch.utils.utils import fetch_metrics
    from sheeprl_tpu_torch.config import compose

    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = compose(overrides=[*PPO_EXP, f"fabric.accelerator={'cuda' if cuda else 'cpu'}", *overrides])
    t_len, n_envs = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
    n_total, mb = t_len * n_envs, int(cfg.algo.per_rank_batch_size)
    n_used, epochs = -(-n_total // mb) * mb, int(cfg.algo.update_epochs)
    coefs = {"clip_coef": float(cfg.algo.clip_coef), "ent_coef": float(cfg.algo.ent_coef),
             "lr": float(cfg.algo.optimizer.learning_rate)}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    card, ref = ppo_setup(torch, cfg, device), ppo_setup(torch, cfg, "cpu")
    ref["agent"].load_state_dict({k: v.cpu() for k, v in card["agent"].state_dict().items()})
    ref["collector"].carry = _to(card["collector"].carry, "cpu")
    g = torch.Generator().manual_seed(int(cfg.seed))
    noise = ref["collector"].draw_noise(generator=g, device="cpu")
    perms = epoch_permutations(n_total, n_used, epochs, g, "cpu")

    # iteration 1: the card's rollout and update, from CPU-drawn noise and permutations
    col = card["collector"]
    sync()
    t0 = time.perf_counter()
    col.carry, data, events = col.rollout(col.carry, _to(noise, device))
    sync()
    rollout_ms = [(time.perf_counter() - t0) * 1e3]
    _, data_c, events_c = ref["collector"].rollout(ref["collector"].carry, noise)
    if not (torch.equal(data["actions"].cpu(), data_c["actions"]) and torch.equal(data["dones"].cpu(), data_c["dones"])):
        raise AssertionError("the card's first rollout took other actions or dones than the CPU's")
    agree = {k: _max_err(data[k], data_c[k]) for k in ("values", "logprobs", "rewards", "state")}
    if max(agree["values"], agree["logprobs"]) > PPO_RUN_TOL:
        raise AssertionError(f"card vs CPU rollout: {agree} > {PPO_RUN_TOL}")
    next_obs = {"state": col.carry["obs"]["state"]}
    t0 = time.perf_counter()
    metrics = card["update"](card["opt"], data, next_obs, perms=perms.to(device), **coefs)
    sync()
    update_ms = [(time.perf_counter() - t0) * 1e3]
    before = {k: v.clone() for k, v in ref["agent"].state_dict().items()}
    ref["update"](ref["opt"], _to(data, "cpu"), _to(next_obs, "cpu"), perms=perms, **coefs)
    card_params = dict(card["agent"].named_parameters())
    param_err = max(_max_err(card_params[k], v) for k, v in ref["agent"].named_parameters())
    if param_err > PPO_PARAM_TOL:
        raise AssertionError(f"card vs CPU parameters after one update: {param_err} > {PPO_PARAM_TOL}")
    # the same update on the CPU with a fault: two samples exchanged between
    # the first two minibatches of the last epoch; the limit must see it
    faulted = ppo_setup(torch, cfg, "cpu")
    faulted["agent"].load_state_dict(before)
    bad = perms.clone()
    bad[-1, [0, mb]] = bad[-1, [mb, 0]]
    faulted["update"](faulted["opt"], _to(data, "cpu"), _to(next_obs, "cpu"), perms=bad, **coefs)
    fault_err = max(_max_err(dict(faulted["agent"].named_parameters())[k], v)
                    for k, v in ref["agent"].named_parameters())
    if fault_err <= PPO_PARAM_TOL:
        raise AssertionError(f"a faulted update reads {fault_err}, inside the parameter limit {PPO_PARAM_TOL}")
    losses = [fetch_metrics(metrics)]
    episodes = int(events["done"].sum())

    # iterations 2..iters: the loop's own draws from the run's generator
    for k in range(2, iters + 1):
        sync()
        t0 = time.perf_counter()
        payload = col.collect(k)
        sync()
        rollout_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        metrics = card["update"](card["opt"], payload.data, payload.next_obs, **coefs)
        sync()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(fetch_metrics(metrics))
    if not all(all(v == v and abs(v) < 1e6 for v in m.values()) for m in losses):
        raise AssertionError(f"non-finite PPO losses: {losses}")
    res = {
        "config": f"exp=ppo env=jax_cartpole: {n_envs} envs, rollout {t_len}, {epochs} epochs, minibatches of {mb}",
        "rollout_ms": rollout_ms, "update_ms": update_ms,
        "collect_env_steps_per_s": [n_total / (ms / 1e3) for ms in rollout_ms],
        "losses": losses, "episodes_in_first_rollout": episodes,
        "card_vs_cpu": {"actions": "identical", "dones": "identical", **{f"max_abs_err_{k}": v for k, v in agree.items()},
                        "tol": PPO_RUN_TOL, "max_abs_param_err_after_update": param_err, "param_tol": PPO_PARAM_TOL,
                        "max_abs_param_err_faulted_update": fault_err},
    }
    if cuda and profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        for name, fn in (("rollout", lambda: col.collect(iters + 1)),
                         ("update", lambda: card["update"](card["opt"], payload.data, payload.next_obs, **coefs))):
            sync()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                sync()
                wall = (time.perf_counter() - t0) * 1e3
            res[f"{name}_profile"] = _device_time(torch, prof, 1, wall)
    if cuda:
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    # collect only, at collect_envs envs
    wide = ppo_setup(torch, compose(overrides=[*PPO_EXP, f"fabric.accelerator={'cuda' if cuda else 'cpu'}",
                                                *overrides, f"env.num_envs={collect_envs}"]), device)
    wide["collector"].collect(1)
    times = []
    for k in range(2, 4):
        sync()
        t0 = time.perf_counter()
        wide["collector"].collect(k)
        sync()
        times.append(time.perf_counter() - t0)
    res["wide"] = {"num_envs": collect_envs, "rollout_ms": [t * 1e3 for t in times],
                   "collect_env_steps_per_s": [t_len * collect_envs / t for t in times]}
    return res


def run_ppo_cli(device: str, *, overrides=()) -> dict:
    """PPO and A2C on CartPole through ``sheeprl_tpu_torch.cli.run`` on
    ``device`` (two iterations, then a resume from the final checkpoint for
    one more), and one PPO iteration on Pendulum (continuous actions), each
    in a temporary root dir."""
    import tempfile

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose

    accel = "cpu" if device == "cpu" else "cuda"
    out = {}
    with tempfile.TemporaryDirectory(prefix="ppo_cli_") as root:
        for exp, env, iters in (("ppo", "jax_cartpole", 2), ("a2c", "jax_cartpole", 2), ("ppo", "jax_pendulum", 1)):
            base = [f"exp={exp}", f"env={env}", "algo.env_backend=jax", f"fabric.accelerator={accel}",
                    "metric.log_level=0", f"root_dir={root}", f"run_name={exp}_{env}", *overrides]
            cfg = compose(overrides=base)
            per_iter = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
            t0 = time.perf_counter()
            first = run(base + [f"algo.total_steps={iters * per_iter}"])
            wall = time.perf_counter() - t0
            if first["test_reward"] is None or not os.path.exists(first["checkpoint"] or ""):
                raise AssertionError(f"{exp} on {env}: no test reward or no final checkpoint: {first}")
            row = {"iterations": first["iterations"], "policy_steps": first["policy_step"], "wall_s": wall,
                   "test_reward": first["test_reward"], "checkpoint": os.path.relpath(first["checkpoint"], root)}
            if env == "jax_cartpole":
                resumed = run(base + [f"algo.total_steps={(iters + 1) * per_iter}", f"run_name={exp}_{env}_resumed",
                                      f"checkpoint.resume_from={first['checkpoint']}"])
                if resumed["iterations"] != 1 or resumed["policy_step"] != (iters + 1) * per_iter \
                        or not os.path.exists(resumed["checkpoint"] or ""):
                    raise AssertionError(f"{exp}: the resume did not run one more iteration to a checkpoint: {resumed}")
                row["resumed"] = {"iterations": resumed["iterations"], "policy_steps": resumed["policy_step"],
                                  "test_reward": resumed["test_reward"],
                                  "checkpoint": os.path.relpath(resumed["checkpoint"], root)}
            out[f"{exp}_{env}"] = row
    return out


def rppo_setup(torch, cfg, device: str):
    """The recurrent PPO of ``cfg`` on ``device``: runtime, agent, AdamW
    state, fused recurrent collector and update, as the port's loop builds
    them."""
    from sheeprl_tpu_torch.algos.ppo.ppo import build_ppo_optimizer
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_update_fn
    from sheeprl_tpu_torch.envs.device.collect import FusedRecurrentCollector
    from sheeprl_tpu_torch.envs.spaces import action_space_dims
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
    from sheeprl_tpu_torch.utils.env import make_train_envs
    from sheeprl_tpu_torch.utils.utils import trainable_params

    runtime = MeshRuntime(device=device, precision=cfg.fabric.precision, seed=int(cfg.seed)).launch()
    envs = make_train_envs(cfg, runtime)
    actions_dim, cont = action_space_dims(envs.single_action_space)
    agent = build_agent(runtime, actions_dim, cont, cfg, envs.single_observation_space)
    tx = build_ppo_optimizer(cfg.algo.optimizer, cfg.algo.max_grad_norm, runtime.precision)
    keys = list(cfg.algo.mlp_keys.encoder)
    collector = FusedRecurrentCollector(envs=envs, agent=agent, cfg=cfg, runtime=runtime, obs_keys=keys,
                                        total_envs=envs.num_envs)
    return {"runtime": runtime, "agent": agent, "opt": tx.init(trainable_params(agent)), "collector": collector,
            "update": make_update_fn(runtime, agent, tx, cfg, keys), "tx": tx, "step": tx.update}


def _profiled(torch, fn, sync) -> dict:
    """``fn()`` once under the profiler: its wall time, device time, idle
    share and device operations (``_device_time``)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    return _device_time(torch, prof, 1, wall)


def _record_steps(tx, sink: list) -> None:
    """Wrap ``tx.update`` so that every AdamW step appends the gradients it
    took and the parameters and moments it left, on the CPU, to ``sink``."""
    step = tx.update

    def update(params, grads, state, norm=None):
        step(params, grads, state, norm)
        sink.append({"grads": {k: v.detach().cpu().clone() for k, v in grads.items()},
                     "params": {k: v.detach().cpu().clone() for k, v in params.items()},
                     "mu": {k: v.detach().cpu().clone() for k, v in state.mu.items()},
                     "nu": {k: v.detach().cpu().clone() for k, v in state.nu.items()}})

    tx.update = update


def _lock_steps(tx, card_steps: list, sink: list) -> None:
    """Wrap a CPU ``tx.update`` to run step-locked to ``card_steps``: each
    step's gradients (taken at the card's parameters) and the parameters it
    computes from the card's state go to ``sink``; then the parameters and
    moments are set to the card's after that step, so that the next
    gradient is taken where the card took its own."""
    import torch

    step = tx.update

    def update(params, grads, state, norm=None):
        card = card_steps[len(sink)]
        step(params, grads, state, norm)
        sink.append({"grads": {k: v.detach().clone() for k, v in grads.items()},
                     "params": {k: v.detach().clone() for k, v in params.items()}})
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(card["params"][name])
                state.mu[name].copy_(card["mu"][name])
                state.nu[name].copy_(card["nu"][name])

    tx.update = update


def _step_errors(card_steps: list, cpu_steps: list) -> dict:
    """Step-locked card against CPU: the largest parameter error of one
    AdamW step from the same state, and each step's gradient error relative
    to the card gradient's largest magnitude."""
    grad_rel, param_err = [], []
    for card, cpu in zip(card_steps, cpu_steps):
        grad_rel.append(max(_max_err(card["grads"][k], v) / max(float(card["grads"][k].abs().max()), 1e-30)
                            for k, v in cpu["grads"].items()))
        param_err.append(max(_max_err(card["params"][k], v) for k, v in cpu["params"].items()))
    order = sorted(grad_rel)
    return {"steps": len(param_err), "max_abs_param_err_one_step": max(param_err),
            "grad_rel_err_median": order[len(order) // 2], "grad_rel_err_max": order[-1],
            "steps_grad_rel_err_above_1e-4": sum(r > 1e-4 for r in grad_rel)}


def _step_gate(check: dict) -> list:
    """The step-locked limits that ``check`` (``_step_errors``) breaks."""
    broken = []
    if check["grad_rel_err_median"] > RPPO_GRAD_RTOL:
        broken.append(f"median gradient error {check['grad_rel_err_median']} > {RPPO_GRAD_RTOL}")
    if check["steps_grad_rel_err_above_1e-4"] > check["steps"] // RPPO_STEPS_ABOVE_SHARE_INV:
        broken.append(f"{check['steps_grad_rel_err_above_1e-4']} of {check['steps']} steps above {RPPO_GRAD_RTOL}")
    if check["max_abs_param_err_one_step"] > RPPO_STEP_PARAM_TOL:
        broken.append(f"one-step parameters {check['max_abs_param_err_one_step']} > {RPPO_STEP_PARAM_TOL}")
    return broken


def run_rppo_training(device: str, *, overrides=(), iters: int = RPPO_ITERS) -> dict:
    """Recurrent PPO on CartPole at the published config on ``device``: the
    card's first rollout and update against the same on the CPU (same
    parameters, noise, data and permutations), ``iters`` timed iterations
    of the fused recurrent collect and ``make_update_fn``, and, on the
    card, one more rollout and update under the profiler.  The first
    update records every AdamW step to the host for the check, so its
    time is ``update_ms_recorded`` and ``update_ms`` starts at iteration 2.

    The update is held against the CPU step-locked (``_step_gate``):
    its ReLUs and the clipped surrogate make it discontinuous, so two
    sound updates that differ by rounding part after a few dozen AdamW
    steps (``free_running``: the card's free-running update against the
    CPU's, beside the CPU's own against itself with its inputs perturbed by
    1e-6 relative)."""
    import torch

    from sheeprl_tpu_torch.algos.ppo.ppo import epoch_permutations
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import sequence_layout
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.utils import fetch_metrics

    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = compose(overrides=[*RPPO_EXP, f"fabric.accelerator={'cuda' if cuda else 'cpu'}", *overrides])
    t_len, n_envs, epochs = int(cfg.algo.rollout_steps), int(cfg.env.num_envs), int(cfg.algo.update_epochs)
    n_seqs, mb, n_mb, n_used = sequence_layout(t_len, n_envs, int(cfg.algo.per_rank_sequence_length),
                                               int(cfg.algo.per_rank_num_batches))
    coefs = {"clip_coef": float(cfg.algo.clip_coef), "ent_coef": float(cfg.algo.ent_coef),
             "lr": float(cfg.algo.optimizer.learning_rate)}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    card, ref = rppo_setup(torch, cfg, device), rppo_setup(torch, cfg, "cpu")
    initial = {k: v.detach().cpu().clone() for k, v in card["agent"].state_dict().items()}
    ref["agent"].load_state_dict(initial)
    ref["collector"].carry = _to(card["collector"].carry, "cpu")
    g = torch.Generator().manual_seed(int(cfg.seed))
    noise = ref["collector"].draw_noise(generator=g, device="cpu")
    perms = epoch_permutations(n_seqs, n_used, epochs, g, "cpu")

    # iteration 1: the card's rollout and update, from CPU-drawn noise and permutations
    col = card["collector"]
    sync()
    t0 = time.perf_counter()
    col.carry, data, events, next_values = col.rollout(col.carry, _to(noise, device))
    sync()
    rollout_ms = [(time.perf_counter() - t0) * 1e3]
    _, data_c, _, next_values_c = ref["collector"].rollout(ref["collector"].carry, noise)
    if not (torch.equal(data["actions"].cpu(), data_c["actions"]) and torch.equal(data["dones"].cpu(), data_c["dones"])):
        raise AssertionError("the card's first recurrent rollout took other actions or dones than the CPU's")
    agree = {k: _max_err(data[k], data_c[k]) for k in ("values", "logprobs", "rewards", "state", "prev_hx", "prev_cx",
                                                        "prev_actions")}
    agree["next_values"] = _max_err(next_values, next_values_c)
    if max(v for k, v in agree.items() if k != "state") > RPPO_RUN_TOL:
        raise AssertionError(f"card vs CPU recurrent rollout: {agree} > {RPPO_RUN_TOL}")
    card_steps: list = []
    _record_steps(card["tx"], card_steps)
    sync()
    t0 = time.perf_counter()
    metrics = card["update"](card["opt"], data, next_values, perms=perms.to(device), **coefs)
    sync()
    update_ms_recorded = (time.perf_counter() - t0) * 1e3
    update_ms = []
    card["tx"].update = card["step"]
    data_cpu, nv_cpu = _to(data, "cpu"), next_values.cpu()

    def cpu_update(perms_, data_=data_cpu, locked=None):
        """The CPU's update from the card's initial parameters: free-running,
        or step-locked to the card's steps with ``locked`` its sink."""
        run = rppo_setup(torch, cfg, "cpu")
        run["agent"].load_state_dict(initial)
        if locked is not None:
            _lock_steps(run["tx"], card_steps, locked)
        out = run["update"](run["opt"], data_, nv_cpu, perms=perms_, **coefs)
        return out, dict(run["agent"].named_parameters())

    locked: list = []
    metrics_c, _ = cpu_update(perms, locked=locked)
    step_check = _step_errors(card_steps, locked)
    if step_check["steps"] != epochs * n_mb or _step_gate(step_check):
        raise AssertionError(f"card vs CPU update from the same state: {_step_gate(step_check)} ({step_check})")
    # the same with two faults, each of which the gate must see: every
    # sequence starts from the carry stored one step later than its own;
    # the last epoch takes its sequences in another order (that epoch's
    # steps only)
    shifted = {**data_cpu, "prev_hx": torch.roll(data_cpu["prev_hx"], -1, 0), "prev_cx": torch.roll(data_cpu["prev_cx"], -1, 0)}
    faulted: list = []
    cpu_update(perms, shifted, locked=faulted)
    fault_carry = _step_errors(card_steps, faulted)
    reordered = perms.clone()
    reordered[-1] = torch.roll(perms[-1], 1)
    faulted = []
    cpu_update(reordered, locked=faulted)
    fault_epoch = _step_errors(card_steps, faulted)
    for name, fault in (("carry one step late", fault_carry), ("last epoch reordered", fault_epoch)):
        if not _step_gate(fault):
            raise AssertionError(f"a faulted recurrent update ({name}) passes the step-locked gate: {fault}")
    card_params = dict(card["agent"].named_parameters())
    _, free = cpu_update(perms)
    free_err = max(_max_err(card_params[k], v) for k, v in free.items())
    noisy = torch.Generator().manual_seed(1)
    perturbed_data = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=noisy))
                      if k in ("values", "logprobs", "prev_hx", "prev_cx", "state") else v for k, v in data_cpu.items()}
    _, perturbed = cpu_update(perms, perturbed_data)
    spread = max(_max_err(free[k], v) for k, v in perturbed.items())
    if free_err > RPPO_FREE_TOL:
        raise AssertionError(f"card vs CPU parameters after a free-running update: {free_err} > {RPPO_FREE_TOL}")
    loss_err = max(abs(float(metrics[k]) - float(metrics_c[k])) for k in metrics)
    losses = [fetch_metrics(metrics)]
    episodes = int(events["done"].sum())

    # iterations 2..iters: the loop's own draws from the run's generator
    for k in range(2, iters + 1):
        sync()
        t0 = time.perf_counter()
        payload = col.collect(k)
        sync()
        rollout_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        metrics = card["update"](card["opt"], payload.data, payload.next_values, **coefs)
        sync()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(fetch_metrics(metrics))
    if not all(all(v == v and abs(v) < 1e6 for v in m.values()) for m in losses):
        raise AssertionError(f"non-finite recurrent PPO losses: {losses}")
    res = {
        "config": f"exp=ppo_recurrent env=jax_cartpole: {n_envs} envs, rollout {t_len}, sequences of "
                  f"{cfg.algo.per_rank_sequence_length}, {n_mb} minibatches of {mb} sequences, {epochs} epochs, "
                  f"LSTM {cfg.algo.rnn.lstm.hidden_size}",
        "rollout_ms": rollout_ms, "update_ms": update_ms, "update_ms_recorded": update_ms_recorded,
        "collect_env_steps_per_s": [t_len * n_envs / (ms / 1e3) for ms in rollout_ms],
        "losses": losses, "episodes_in_first_rollout": episodes,
        "card_vs_cpu": {"actions": "identical", "dones": "identical", **{f"max_abs_err_{k}": v for k, v in agree.items()},
                        "tol": RPPO_RUN_TOL, "max_abs_loss_err": loss_err,
                        "step_locked": {**step_check, "grad_rtol_median": RPPO_GRAD_RTOL,
                                        "max_steps_above": step_check["steps"] // RPPO_STEPS_ABOVE_SHARE_INV,
                                        "param_tol_one_step": RPPO_STEP_PARAM_TOL,
                                        "faulted_carry": fault_carry, "faulted_last_epoch": fault_epoch},
                        "free_running": {"max_abs_param_err_after_update": free_err, "tol": RPPO_FREE_TOL,
                                         "cpu_vs_cpu_inputs_perturbed_1e-6": spread}},
    }
    if cuda:
        res["rollout_profile"] = _profiled(torch, lambda: col.collect(iters + 1), sync)
        res["update_profile"] = _profiled(
            torch, lambda: card["update"](card["opt"], payload.data, payload.next_values, **coefs), sync)
    if cuda:
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return res


def run_rppo_cli(device: str, *, overrides=()) -> dict:
    """Recurrent PPO through ``sheeprl_tpu_torch.cli.run`` on ``device`` at
    ``exp=ppo_recurrent``'s width: two iterations on CartPole and on
    Pendulum (continuous heads), each then resumed from its final
    checkpoint for one more, in a temporary root dir."""
    import tempfile

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose

    accel = "cpu" if device == "cpu" else "cuda"
    out = {}
    with tempfile.TemporaryDirectory(prefix="rppo_cli_") as root:
        for env, extra in RPPO_CLI_RUNS.items():
            base = ["exp=ppo_recurrent", f"env={env}", *extra, "algo.env_backend=jax", f"fabric.accelerator={accel}",
                    "metric.log_level=0", f"root_dir={root}", f"run_name=rppo_{env}", *overrides]
            cfg = compose(overrides=base)
            per_iter = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
            t0 = time.perf_counter()
            first = run(base + [f"algo.total_steps={2 * per_iter}"])
            wall = time.perf_counter() - t0
            if first["test_reward"] is None or not os.path.exists(first["checkpoint"] or ""):
                raise AssertionError(f"recurrent PPO on {env}: no test reward or no final checkpoint: {first}")
            t0 = time.perf_counter()
            resumed = run(base + [f"algo.total_steps={3 * per_iter}", f"run_name=rppo_{env}_resumed",
                                  f"checkpoint.resume_from={first['checkpoint']}"])
            resume_wall = time.perf_counter() - t0
            if resumed["iterations"] != 1 or resumed["policy_step"] != 3 * per_iter \
                    or not os.path.exists(resumed["checkpoint"] or ""):
                raise AssertionError(f"recurrent PPO on {env}: the resume did not run one more iteration: {resumed}")
            out[env] = {"iterations": first["iterations"], "policy_steps": first["policy_step"], "wall_s": wall,
                        "test_reward": first["test_reward"], "checkpoint": os.path.relpath(first["checkpoint"], root),
                        "resumed": {"iterations": resumed["iterations"], "policy_steps": resumed["policy_step"],
                                    "wall_s": resume_wall, "test_reward": resumed["test_reward"],
                                    "checkpoint": os.path.relpath(resumed["checkpoint"], root)}}
    return out


def _family_server(family: str, cfg, device: str, greedy: bool):
    """The family's server at ``cfg``'s width, random weights from ``cfg.seed``."""
    from sheeprl_tpu_torch.envs.spaces import action_space_dims
    from sheeprl_tpu_torch.serve.serve_policy import (
        build_ppo_server,
        build_recurrent_ppo_server,
        build_sac_server,
        device_env_spaces,
    )

    obs_space, action_space = device_env_spaces(cfg)
    kw = {"device": device, "greedy": greedy, "deadline_ms": 50.0, "max_batch": 64}
    if family == "sac":
        server, keys = build_sac_server(cfg, None, obs_space, action_space, **kw)
    else:
        actions_dim, cont = action_space_dims(action_space)
        build = build_ppo_server if family == "ppo" else build_recurrent_ppo_server
        server, keys = build(cfg, None, obs_space, actions_dim, is_continuous=cont, **kw)
    return server, keys, obs_space


def run_serve_families(device: str, *, steps: int = SERVE_FAMILY_STEPS, calls: int = SERVE_LATENCY_CALLS) -> dict:
    """The PPO, SAC and recurrent-PPO servers on ``device``: two clients of
    1 and 3 rows send ``steps`` requests each (session steps for recurrent
    PPO), and every reply is replayed on the CPU by the family's function
    over a CPU copy of the served module (PPO and SAC greedy; recurrent PPO
    sampled, its noise each row's own hash); then the median time of a
    64-row step of the family's function, ``calls`` calls."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.serve_policy import run_selftest

    accel = "cpu" if device == "cpu" else "cuda"
    out = {}
    for family, ovr in SERVE_FAMILIES.items():
        cfg = compose(overrides=[*ovr, f"fabric.accelerator={accel}", "metric.log_level=0"])
        greedy = family != "ppo_recurrent"
        server, keys, space = _family_server(family, cfg, device, greedy)
        replica, _, _ = _family_server(family, cfg, "cpu", greedy)
        try:
            module, replica_module = server.params, replica.params
            replica_module.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
            res = run_selftest(server, keys, space, 2, steps, rows=[1, 3], close_sessions=False)
            st = res["selftest"]
            if st["failures"] or st["dead_reason"] or res["acted"] != 2 * steps:
                raise AssertionError(f"{family}: not every request was answered remote: {st}")
            worst = 0.0
            for cid, log in enumerate(res["log"]):
                state = None if greedy else replica.init_fn(len(log[0][0][keys[0]]), cid, replica_module)
                for sent, reply in log:
                    if state is None:
                        want = replica.policy_fn(replica_module, sent, 0)
                    else:
                        want, state = replica.session_fn(replica_module, sent, state)
                    for k, v in want.items():
                        if v.dtype.kind in "iu" and not np.array_equal(v, reply[k]):
                            raise AssertionError(f"{family}: client {cid} {k} differ from the CPU replay")
                        worst = max(worst, float(np.abs(np.asarray(v, np.float64) - reply[k]).max()))
            if worst > SERVE_FAMILY_TOL:
                raise AssertionError(f"{family}: served vs CPU replay differ by {worst} > {SERVE_FAMILY_TOL}")
            obs = {k: np.random.default_rng(0).normal(size=(64,) + tuple(space[k].shape)).astype(np.float32) for k in keys}
            state64 = None if greedy else server.init_fn(64, 0, module)

            def step():
                return server.policy_fn(module, obs, 1) if greedy else server.session_fn(module, obs, state64)

            step_ms = []
            for _ in range(calls + 2):
                if accel == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            step_ms = sorted(step_ms[2:])
            out[family] = {"config": " ".join(ovr), "greedy": greedy, "requests": res["acted"], "batches": res["batches"],
                           "batch_hist": res["batch_hist"], "latency_ms": res["latency_ms"],
                           "max_abs_err_vs_cpu": worst, "tol": SERVE_FAMILY_TOL,
                           "step64_ms_median": step_ms[len(step_ms) // 2], "step64_ms_min": step_ms[0],
                           "step64_ms_max": step_ms[-1]}
        finally:
            server.close()
            replica.close()
    return out


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name (each counts its launches)."""
    from sheeprl_tpu_torch.ops import gather, gru_cell, per, seq_gru

    return {
        "gru_cell": gru_cell.gru_cell, "gru_sequence": seq_gru.gru_sequence,
        "gru_input_product": seq_gru.gru_input_product, "gather_windows": gather.gather_windows,
        "gather_transitions": gather.gather_transitions, "sum_tree_sample": per.sum_tree_sample,
        "sum_tree_write": per.sum_tree_write, "sum_tree_update": per.sum_tree_update,
        "sum_tree_descend": per.sum_tree_descend, "sum_tree_scatter": per.sum_tree_scatter,
    }


def _uncounted(fn):
    """``fn()`` with every kernel count put back after it: launches made to
    hold a kernel against its plain version do not count."""
    counters = kernel_counters()
    saved = {k: c.launches for k, c in counters.items()}
    try:
        return fn()
    finally:
        for k, c in counters.items():
            c.launches = saved[k]


def cache_draw_vs_plain(cache, *, n_samples: int, batch: int, seq_len=None, beta: float = 0.0, sample_next_obs: bool = False,
                        obs_keys=(), flush_rows: int = 0) -> dict:
    """One draw of ``n_samples`` batches from a CLI run's own device cache,
    at the run's shapes, through the kernels
    (``cache.kernel = "pallas"``) and through their plain versions
    (``"lax"``), from the same tree and the same uniforms; the tree, its
    running max and the kernel setting are put back after.

    With ``seq_len`` (DreamerV3) the draw is ``sample``'s windows (#3), or
    ``sample_per``'s (#5, #3, and #6 for the start decay) on a prioritized
    cache.  Without it (SAC) the draw is ``sample_transitions_per`` (#5,
    #4), then the TD update of the drawn leaves (#7) and the write of the
    next flush's ``flush_rows`` rows an env at the running max (#6).  The
    drawn leaves, the batches, the tree and the running max must be
    byte-identical; the IS weights agree to W_RTOL (powf on the card)."""
    import numpy as np
    import torch

    tree, kernel0 = cache.tree, cache.kernel
    snap = None if tree is None else (tree.tree.clone(), tree.max_priority.clone())
    kernels = ["gather_windows" if seq_len is not None else "gather_transitions"]
    runs = {}
    try:
        for kernel in ("pallas", "lax"):
            if snap is not None:
                tree.tree.copy_(snap[0])
                tree.max_priority = snap[1].clone()
            cache.kernel = kernel
            gen = torch.Generator(device=cache.device).manual_seed(11)
            got = {}
            if seq_len is not None and tree is None:
                batch_out = cache.sample(n_samples, batch, seq_len, gen)
            elif seq_len is not None:
                inner = tree.sample

                def recording(*a, **kw):
                    leaf, w = inner(*a, **kw)
                    got["leaves"] = leaf.clone()
                    return leaf, w

                tree.sample = recording
                try:
                    batch_out = cache.sample_per(n_samples, batch, seq_len, gen, beta=beta)
                finally:
                    del tree.sample
            else:
                batch_out, leaves = cache.sample_transitions_per(
                    n_samples, batch, gen, beta, sample_next_obs=sample_next_obs, obs_keys=obs_keys)
                got["leaves"], got["weights"] = leaves, batch_out.pop("is_weights")
                cache.update_priorities(leaves, torch.rand(leaves.shape, generator=gen, device=cache.device) * 4)
                rows = (cache._pos[None, :] + np.arange(flush_rows)[:, None]) % cache.capacity
                flush = torch.from_numpy((rows * cache.n_envs + np.arange(cache.n_envs)[None, :]).reshape(-1))
                tree.seed_max(flush.to(cache.device), torch.ones(flush.shape, dtype=torch.bool, device=cache.device))
            if isinstance(batch_out, list):
                batch_out = {k: torch.stack([b[k] for b in batch_out]) for k in batch_out[0]}
            got.update({f"batch/{k}": v for k, v in batch_out.items()})
            if tree is not None:
                got["tree"], got["max_priority"] = tree.tree[1:].clone(), tree.max_priority.clone()
            runs[kernel] = got
    finally:
        if snap is not None:
            tree.tree.copy_(snap[0])
            tree.max_priority = snap[1]
        cache.kernel = kernel0
    fast, plain = runs["pallas"], runs["lax"]
    w_err = 0.0
    for k, want in plain.items():
        have = fast[k]
        if have.dtype != want.dtype or have.shape != want.shape:
            raise AssertionError(f"draw from the run's cache: '{k}' is {have.dtype} {tuple(have.shape)} from the "
                                 f"kernels, {want.dtype} {tuple(want.shape)} from the plain versions")
        if k == "weights":
            w_err = float(((have - want).abs() / want.abs()).max())
            if not np.isfinite(w_err) or w_err > W_RTOL:
                raise AssertionError(f"draw from the run's cache: IS weights differ by {w_err} > {W_RTOL}")
        elif not torch.equal(have, want):
            raise AssertionError(f"draw from the run's cache: '{k}' from the kernels is not byte-identical "
                                 "to the plain versions")
    if tree is not None:
        kernels += ["sum_tree_sample", "sum_tree_write"] + ([] if seq_len is not None else ["sum_tree_update"])
    return {"kernels": kernels, "rows": n_samples * batch * (seq_len or 1), "draws": n_samples * batch,
            "keys": sorted(k[6:] for k in plain if k.startswith("batch/")), "bytes_equal": True,
            "max_rel_err_w": w_err if "weights" in plain else None,
            "tree_leaves": None if tree is None else tree.n_leaves}


def _dv3_draw_check(state, rb, cache, cfg, gradient_steps, *args, **kwargs) -> dict:
    """``cache_draw_vs_plain`` at the DreamerV3 call's gradient steps, batch
    and sequence length."""
    return cache_draw_vs_plain(cache, n_samples=int(gradient_steps), batch=int(cfg.algo.per_rank_batch_size),
                               seq_len=int(cfg.algo.per_rank_sequence_length))


def _sac_draw_check(state, rb, cache, cfg, ema_flags, policy_step, beta_fn, *args, **kwargs) -> dict:
    """``cache_draw_vs_plain`` at the SAC dispatch's gradient steps, batch,
    beta and flush window."""
    from sheeprl_tpu_torch.algos.sac.sac import OBS_KEYS

    return cache_draw_vs_plain(
        cache, n_samples=len(ema_flags), batch=int(cfg.algo.per_rank_batch_size), beta=float(beta_fn(policy_step)),
        sample_next_obs=bool(cfg.buffer.sample_next_obs), obs_keys=OBS_KEYS,
        flush_rows=max(1, int(cfg.algo.dispatch_batch) // int(cfg.env.num_envs)),
    )


class _TrainWindow:
    """Wraps the loop's training call (``module.<name>``) of a CLI run: keeps
    each call's host time (``call_ms``), and puts ``torch.profiler`` over
    ``iters`` training iterations, starting before the ``start``-th call and
    ending before the ``start + iters``-th (whole iterations, collect
    included).  With ``check``, right after the first call returns,
    ``check(*its arguments)`` holds a draw from the run's own cache against
    the plain versions (``checked``: its result; ``check_s``: its seconds,
    which the rates leave out); its launches do not count."""

    def __init__(self, module, name: str, start: int, iters: int, enabled: bool, check=None):
        self.module, self.name, self.inner = module, name, getattr(module, name)
        self.start, self.iters, self.enabled = start, iters, enabled
        self.calls, self.prof, self.t0, self.result, self.call_ms = 0, None, 0.0, None, []
        self.check, self.checked, self.check_s = check, None, 0.0

    def _edge(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        if self.calls == self.start:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.calls == self.start + self.iters and self.prof is not None:
            wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.stop()
            self.result = _device_time(torch, self.prof, self.iters, wall_ms / self.iters)
            self.result["window_iterations"] = self.iters
            self.prof = None

    def __enter__(self):
        def wrapped(*args, **kwargs):
            if self.enabled and self.calls in (self.start, self.start + self.iters):
                self._edge()
            self.calls += 1
            t0 = time.perf_counter()
            out = self.inner(*args, **kwargs)
            self.call_ms.append((time.perf_counter() - t0) * 1e3)
            if self.check is not None and self.checked is None:
                t0 = time.perf_counter()
                self.checked = _uncounted(lambda: self.check(*args, **kwargs))
                self.check_s = time.perf_counter() - t0
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)
        if self.prof is not None:
            self.prof.stop()
            self.prof = None


def _cli_run(args, device: str, window: "_TrainWindow") -> tuple:
    """``cli.run(args)`` with every kernel count set to 0 just before and
    read just after; with the wall time and the peak device memory.  The
    window times each training call (no profiler) and runs its check, whose
    seconds leave the wall time and the run's training seconds."""
    import torch

    from sheeprl_tpu_torch.cli import run

    counters = kernel_counters()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with window:
        out = run(args)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - window.check_s
    out = dict(out, training_s=out["training_s"] - window.check_s, train_s=out["train_s"] - window.check_s)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    return out, wall, launches, peak


def _profiled_run(module, name: str, args, total_steps: int, run_name: str) -> dict:
    """The same configuration once more, ``total_steps`` long, with the
    profiler over CLI_PROFILE_ITERS training calls after CLI_PROFILE_START:
    device time by group and the device's idle share."""
    from sheeprl_tpu_torch.cli import run

    window = _TrainWindow(module, name, CLI_PROFILE_START, CLI_PROFILE_ITERS, True)
    with window:
        run(args + [f"algo.total_steps={total_steps}", f"run_name={run_name}", "algo.run_test=False"])
    if window.result is None:
        raise AssertionError(f"{run_name}: the run made fewer than {CLI_PROFILE_START + CLI_PROFILE_ITERS + 1} training calls")
    return window.result


def _loop_rates(out: dict, num_envs: int, window: "_TrainWindow") -> dict:
    """Policy steps/s of the warm-up iterations (collect only) and of the
    iterations from ``learning_starts`` on (collect and train), gradient
    steps/s over those iterations and inside their training calls, and the
    training calls' host ms (first, median, min, max)."""
    import numpy as np

    warm_iters = max(0, out["learning_starts"] - 1)
    train_iters = out["iterations"] - warm_iters
    calls = window.call_ms
    return {
        "train_call_ms": {"first": calls[0], "median": float(np.median(calls)), "min": min(calls), "max": max(calls),
                          "calls": len(calls)} if calls else None,
        "iterations": out["iterations"], "warmup_iterations": warm_iters, "training_iterations": train_iters,
        "gradient_steps": out["gradient_steps"],
        "policy_steps_per_s_collect": warm_iters * num_envs / out["warmup_s"] if out["warmup_s"] else None,
        "policy_steps_per_s_with_training": train_iters * num_envs / out["training_s"] if out["training_s"] else None,
        "gradient_steps_per_s": out["gradient_steps"] / out["training_s"] if out["training_s"] else None,
        "gradient_steps_per_s_in_train_calls": out["gradient_steps"] / out["train_s"] if out["train_s"] else None,
        "warmup_s": out["warmup_s"], "training_s": out["training_s"], "train_s": out["train_s"],
    }


def _require_launches(run: str, launches: dict, needed, device: str) -> None:
    idle = [k for k in needed if launches[k] < 1]
    if device != "cpu" and idle:
        raise AssertionError(f"{run}: kernels its configuration reaches launched no time: {idle} ({launches})")


def _require_checked(run: str, window: "_TrainWindow", needed) -> None:
    """The run's cache draw was held against the plain versions, for every
    kernel of ``needed`` that a draw, a write or an update makes."""
    drawn = {"gather_windows", "gather_transitions", "sum_tree_sample", "sum_tree_write", "sum_tree_update"}
    missing = sorted(set(needed) & drawn - set((window.checked or {}).get("kernels", ())))
    if window.checked is None or missing:
        raise AssertionError(f"{run}: no draw from the run's cache was held against the plain versions of {missing}")


def _resume_one(args, out: dict, per_iter: int, root: str, name: str) -> dict:
    """Resume a CLI run from its last checkpoint for exactly one iteration."""
    from sheeprl_tpu_torch.cli import run

    resumed = run(args + [f"algo.total_steps={out['policy_step'] + per_iter}", f"run_name={name}",
                          f"checkpoint.resume_from={out['checkpoint']}"])
    if resumed["iterations"] != 1 or resumed["policy_step"] != out["policy_step"] + per_iter \
            or not os.path.exists(resumed["checkpoint"] or "") or resumed["test_reward"] is None:
        raise AssertionError(f"{name}: the resume did not run one more iteration to a checkpoint and a test: {resumed}")
    return {"iterations": resumed["iterations"], "policy_steps": resumed["policy_step"],
            "test_reward": resumed["test_reward"], "checkpoint": os.path.relpath(resumed["checkpoint"], root)}


def dv3_player_vs_plain(cfg, ckpt_path: str, device: str, steps: int = 16, actor_key: str = "actor") -> dict:
    """The checkpoint's player (its world model and the actor under
    ``actor_key``) on ``device`` against the same player on the CPU (plain
    versions): the same GridWorld observations (a CPU rollout of 4 envs)
    and the same Gumbel noise for 16 steps; the recurrent states within
    STATE_TOL at every step, the greedy actions identical."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_player
    from sheeprl_tpu_torch.envs.device import DeviceVectorEnv
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint
    from sheeprl_tpu_torch.utils.convert import load_flax_params
    from sheeprl_tpu_torch.utils.env import make_device_env_from_cfg

    saved = load_checkpoint(ckpt_path, select=("world_model", actor_key))
    state = {"world_model": saved["world_model"], "actor": saved[actor_key]}
    env = make_device_env_from_cfg(cfg)
    n = 4
    actions_dim = (env.action_space.n,)
    wm_cfg = cfg.algo.world_model
    s, d = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    players = {}
    for dev in (device, "cpu"):
        player = build_player(MeshRuntime(device=dev, seed=0).launch(), actions_dim, False, cfg, env.observation_space)
        players[dev] = load_flax_params(player, state)
    vec = DeviceVectorEnv(env, n, device="cpu", seed=3)
    obs = vec.reset(seed=3)[0]
    gen = torch.Generator().manual_seed(4)
    runs = {dev: {} for dev in players}
    worst = 0.0
    with torch.no_grad():
        for t in range(steps):
            noise = -torch.log(-torch.log(torch.rand((1, n, s, d), generator=gen).clamp_min(1e-30)))
            acts = {}
            for dev, player in players.items():
                st = runs[dev]
                rssm = player.world_model.rssm
                if not st:
                    rec, stoch = rssm.get_initial_states((1, n))
                    st.update(rec=rec, stoch=stoch.reshape(1, n, -1), act=torch.zeros(1, n, sum(actions_dim), device=dev))
                o = {"state": torch.from_numpy(obs["state"]).to(dev).reshape(1, n, -1)}
                emb = player.world_model.encoder(o)
                st["rec"] = rssm.recurrent_step(torch.cat([st["stoch"], st["act"]], -1), st["rec"])
                _, stoch = rssm._representation(emb, st["rec"], noise=noise.to(dev))
                st["stoch"] = stoch.reshape(1, n, s * d)
                heads, _ = player.actor(torch.cat([st["stoch"], st["rec"]], -1), True)
                st["act"] = torch.cat(heads, -1)
                acts[dev] = st["act"].argmax(-1).cpu()
            if not torch.equal(acts[device], acts["cpu"]):
                raise AssertionError(f"step {t}: greedy actions differ between {device} and the plain CPU player")
            err = float((runs[device]["rec"].cpu() - runs["cpu"]["rec"]).abs().max())
            worst = max(worst, err)
            if not np.isfinite(err) or err > STATE_TOL:
                raise AssertionError(f"step {t}: recurrent states differ by {err} > {STATE_TOL}")
            obs = vec.step(acts["cpu"].numpy().reshape(n))[0]
    return {"steps": steps, "envs": n, "actor": actor_key, "max_abs_state_err": worst, "tol": STATE_TOL,
            "actions": "identical"}


def run_dv3_cli(device: str, *, overrides=(), learning_starts: int = DV3_CLI_LEARNING_STARTS,
                train_iters: int = DV3_CLI_TRAIN_ITERS, profile: bool = True) -> dict:
    """DreamerV3 through ``sheeprl_tpu_torch.cli.run`` on ``device``: the two
    runs of DV3_CLI_RUNS (``learning_starts`` warm-up steps, then about
    ``train_iters`` training iterations), each with its loop rates, a
    profiled window, peak memory and its kernels' launches; run (a) resumed
    for one iteration and its checkpoint's player held against the plain CPU
    player."""
    import tempfile

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose

    accel = "cpu" if device == "cpu" else "cuda"
    out = {}
    with tempfile.TemporaryDirectory(prefix="dv3_cli_") as root:
        for name, extra in DV3_CLI_RUNS.items():
            args = [*DV3_CLI_EXP, *extra, f"fabric.accelerator={accel}", f"root_dir={root}", f"run_name=dv3_{name}",
                    f"algo.learning_starts={learning_starts}", *overrides]
            cfg = compose(overrides=args)
            n = int(cfg.env.num_envs)
            total = learning_starts + train_iters * n
            window = _TrainWindow(dv3, "train_steps", 0, 0, False, check=_dv3_draw_check)
            res, wall, launches, peak = _cli_run(args + [f"algo.total_steps={total}"], device, window)
            if res["test_reward"] is None or not os.path.exists(res["checkpoint"] or ""):
                raise AssertionError(f"dv3 {name}: no test reward or no final checkpoint: {res}")
            _require_launches(f"dv3 {name}", launches, DV3_CLI_KERNELS[name], device)
            _require_checked(f"dv3 {name}", window, DV3_CLI_KERNELS[name])
            row = {"env": cfg.env.id, "num_envs": n, "wall_s": wall, **_loop_rates(res, n, window), "peak_memory_bytes": peak,
                   "launches": {k: v for k, v in launches.items() if v}, "draw_vs_plain": window.checked,
                   "test_reward": res["test_reward"]}
            if profile and device != "cpu":
                steps = learning_starts + (CLI_PROFILE_START + CLI_PROFILE_ITERS + 3) * n
                row["profile"] = _profiled_run(dv3, "train_steps", args, steps, f"dv3_{name}_profiled")
            if name == "gridworld":
                row["resumed"] = _resume_one(args, res, n, root, f"dv3_{name}_resumed")
                row["player_vs_plain"] = dv3_player_vs_plain(cfg, res["checkpoint"], device)
            out[name] = row
    return out


def run_sac_cli(device: str, *, overrides=(), dispatches: int = SAC_CLI_DISPATCHES, profile: bool = True) -> dict:
    """SAC on Pendulum through ``sheeprl_tpu_torch.cli.run`` on ``device``:
    about ``dispatches`` dispatches of ``algo.dispatch_batch`` gradient steps
    after the warm-up, the loop rates, ms a dispatch, a profiled window of
    dispatches, peak memory and the launches of #4-#7; then a resume for one
    iteration."""
    import tempfile

    from sheeprl_tpu_torch.algos.sac import sac as sac_mod
    from sheeprl_tpu_torch.config import compose

    accel = "cpu" if device == "cpu" else "cuda"
    with tempfile.TemporaryDirectory(prefix="sac_cli_") as root:
        args = [*SAC_CLI_EXP, f"fabric.accelerator={accel}", f"root_dir={root}", "run_name=sac_pendulum", *overrides]
        cfg = compose(overrides=args)
        n = int(cfg.env.num_envs)
        per_dispatch_iters = max(1, int(cfg.algo.dispatch_batch) // n)
        warm = int(cfg.algo.learning_starts) // n
        total = (warm + dispatches * per_dispatch_iters) * n
        window = _TrainWindow(sac_mod, "train_dispatch", 0, 0, False, check=_sac_draw_check)
        res, wall, launches, peak = _cli_run(args + [f"algo.total_steps={total}"], device, window)
        if res["test_reward"] is None or not os.path.exists(res["checkpoint"] or ""):
            raise AssertionError(f"sac: no test reward or no final checkpoint: {res}")
        _require_launches("sac", launches, SAC_CLI_KERNELS, device)
        _require_checked("sac", window, SAC_CLI_KERNELS)
        row = {"env": cfg.env.id, "num_envs": n, "dispatch_batch": int(cfg.algo.dispatch_batch), "wall_s": wall,
               **_loop_rates(res, n, window), "dispatches": res["dispatches"],
               "ms_per_dispatch": 1e3 * res["train_s"] / max(1, res["dispatches"]), "peak_memory_bytes": peak,
               "launches": {k: v for k, v in launches.items() if v}, "draw_vs_plain": window.checked,
               "test_reward": res["test_reward"]}
        if profile and device != "cpu":
            steps = (warm + (CLI_PROFILE_START + CLI_PROFILE_ITERS + 2) * per_dispatch_iters) * n
            row["profile"] = _profiled_run(sac_mod, "train_dispatch", args, steps, "sac_pendulum_profiled")
        row["resumed"] = _resume_one(args, res, n, root, "sac_pendulum_resumed")
    return row


def run_droq_cli(device: str, *, overrides=(), iters: int = DROQ_CLI_ITERS, profile: bool = True) -> dict:
    """DroQ on Pendulum through ``sheeprl_tpu_torch.cli.run`` on ``device``:
    ``iters`` training iterations after the warm-up (one dispatch each), the
    loop rates, ms a training iteration, a profiled window of dispatches,
    peak memory and the launches of #4-#7, a draw from the run's own cache
    held against the plain versions; then a resume for one iteration."""
    import tempfile

    from sheeprl_tpu_torch.algos.droq import droq as droq_mod
    from sheeprl_tpu_torch.config import compose

    accel = "cpu" if device == "cpu" else "cuda"
    with tempfile.TemporaryDirectory(prefix="droq_cli_") as root:
        args = [*DROQ_CLI_EXP, f"fabric.accelerator={accel}", f"root_dir={root}", "run_name=droq_pendulum", *overrides]
        cfg = compose(overrides=args)
        n = int(cfg.env.num_envs)
        warm = int(cfg.algo.learning_starts) // n
        window = _TrainWindow(droq_mod, "train_dispatch", 0, 0, False, check=_sac_draw_check)
        res, wall, launches, peak = _cli_run(args + [f"algo.total_steps={(warm + iters) * n}"], device, window)
        if res["test_reward"] is None or not os.path.exists(res["checkpoint"] or ""):
            raise AssertionError(f"droq: no test reward or no final checkpoint: {res}")
        _require_launches("droq", launches, SAC_CLI_KERNELS, device)
        _require_checked("droq", window, SAC_CLI_KERNELS)
        rates = _loop_rates(res, n, window)
        row = {"env": cfg.env.id, "num_envs": n, "replay_ratio": float(cfg.algo.replay_ratio),
               "dropout": float(cfg.algo.critic.dropout), "wall_s": wall, **rates, "dispatches": res["dispatches"],
               "ms_per_training_iteration": 1e3 * res["training_s"] / max(1, rates["training_iterations"]),
               "ms_per_dispatch": 1e3 * res["train_s"] / max(1, res["dispatches"]), "peak_memory_bytes": peak,
               "launches": {k: v for k, v in launches.items() if v}, "draw_vs_plain": window.checked,
               "test_reward": res["test_reward"]}
        if profile and device != "cpu":
            steps = (warm + CLI_PROFILE_START + CLI_PROFILE_ITERS + 2) * n
            row["profile"] = _profiled_run(droq_mod, "train_dispatch", args, steps, "droq_pendulum_profiled")
        row["resumed"] = _resume_one(args, res, n, root, "droq_pendulum_resumed")
    return row


def _p2e_finetune(root: str, ckpt: str, accel: str, device: str, overrides, learning_starts: int, iters: int) -> dict:
    """P2E-DV3 finetuning from an exploration checkpoint on GridWorld: the
    player acts with the exploration actor, then the task actor from the
    first gradient step; the loop rates, launches (#1, #3) and a resume."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose

    args = [*P2E_FINETUNE_EXP, *DV3_CLI_RUNS["gridworld"], f"fabric.accelerator={accel}", f"root_dir={root}",
            "run_name=p2e_finetuning", f"checkpoint.exploration_ckpt_path={ckpt}",
            f"algo.learning_starts={learning_starts}", *overrides]
    n = int(compose(overrides=args).env.num_envs)
    window = _TrainWindow(dv3, "train_steps", 0, 0, False, check=_dv3_draw_check)
    res, wall, launches, peak = _cli_run(args + [f"algo.total_steps={learning_starts + iters * n}"], device, window)
    if res["test_reward"] is None or not os.path.exists(res["checkpoint"] or "") or not res["actor_switched"]:
        raise AssertionError(f"p2e finetuning: no test reward, no final checkpoint or no switch to the task actor: {res}")
    _require_launches("p2e finetuning", launches, DV3_CLI_KERNELS["gridworld"], device)
    _require_checked("p2e finetuning", window, DV3_CLI_KERNELS["gridworld"])
    return {"wall_s": wall, **_loop_rates(res, n, window), "peak_memory_bytes": peak,
            "launches": {k: v for k, v in launches.items() if v}, "draw_vs_plain": window.checked,
            "actor_switched": res["actor_switched"], "test_reward": res["test_reward"],
            "resumed": _resume_one(args, res, n, root, "p2e_finetuning_resumed")}


def run_p2e_dv3_cli(device: str, *, overrides=(), learning_starts: int = DV3_CLI_LEARNING_STARTS,
                    train_iters=None, finetune_starts: int = P2E_FINETUNE_LEARNING_STARTS,
                    finetune_iters: int = P2E_FINETUNE_ITERS, profile: bool = True) -> dict:
    """Plan2Explore-DreamerV3 through ``sheeprl_tpu_torch.cli.run`` on
    ``device``: exploration on the two DV3 runs' configurations
    (``learning_starts`` warm-up steps, then ``train_iters`` training
    iterations), each with its loop rates, peak memory, its kernels'
    launches and a draw from its own cache against the plain versions; the
    GridWorld run profiled, resumed for one iteration, its checkpoint's
    exploration player held against the plain CPU player, and finetuned."""
    import tempfile

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose

    train_iters = dict(P2E_CLI_TRAIN_ITERS, **(train_iters or {}))
    accel = "cpu" if device == "cpu" else "cuda"
    out = {}
    with tempfile.TemporaryDirectory(prefix="p2e_cli_") as root:
        for name, extra in DV3_CLI_RUNS.items():
            args = [*P2E_CLI_EXP, *extra, f"fabric.accelerator={accel}", f"root_dir={root}", f"run_name=p2e_{name}",
                    f"algo.learning_starts={learning_starts}", *overrides]
            cfg = compose(overrides=args)
            n = int(cfg.env.num_envs)
            window = _TrainWindow(dv3, "train_steps", 0, 0, False, check=_dv3_draw_check)
            total = learning_starts + train_iters[name] * n
            res, wall, launches, peak = _cli_run(args + [f"algo.total_steps={total}"], device, window)
            if res["test_reward"] is None or not os.path.exists(res["checkpoint"] or ""):
                raise AssertionError(f"p2e {name}: no test reward or no final checkpoint: {res}")
            _require_launches(f"p2e {name}", launches, DV3_CLI_KERNELS[name], device)
            _require_checked(f"p2e {name}", window, DV3_CLI_KERNELS[name])
            row = {"env": cfg.env.id, "num_envs": n, "ensembles": int(cfg.algo.ensembles.n), "wall_s": wall,
                   **_loop_rates(res, n, window), "peak_memory_bytes": peak,
                   "launches": {k: v for k, v in launches.items() if v}, "draw_vs_plain": window.checked,
                   "test_reward": res["test_reward"]}
            if name == "gridworld":
                if profile and device != "cpu":
                    steps = learning_starts + (CLI_PROFILE_START + CLI_PROFILE_ITERS + 3) * n
                    row["profile"] = _profiled_run(dv3, "train_steps", args, steps, f"p2e_{name}_profiled")
                row["resumed"] = _resume_one(args, res, n, root, f"p2e_{name}_resumed")
                row["player_vs_plain"] = dv3_player_vs_plain(cfg, res["checkpoint"], device, actor_key="actor_exploration")
                row["finetuning"] = _p2e_finetune(root, res["checkpoint"], accel, device, overrides, finetune_starts,
                                                  finetune_iters)
            out[name] = row
    return out


def _dreamer_family(algo: str):
    """The loop module of a Dreamer family and its family."""
    from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2

    return {"dreamer_v2": (dreamer_v2, dreamer_v2.DV2_FAMILY), "dreamer_v1": (dreamer_v1, dreamer_v1.DV1_FAMILY)}[algo]


def _dreamer_run(cfg, state, device: str):
    """A Dreamer family's agent and train state for ``cfg`` on ``device``,
    loaded from the port checkpoint ``state``, and the env's action sizes."""
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.parallel.mesh import MeshRuntime
    from sheeprl_tpu_torch.utils.env import make_device_env_from_cfg

    env = make_device_env_from_cfg(cfg)
    actions_dim, continuous = spaces.action_space_dims(env.action_space)
    _, family = _dreamer_family(cfg.algo.name)
    runtime = MeshRuntime(device=device, seed=0).launch()
    run = family.setup(runtime, cfg, actions_dim, continuous, env.observation_space, state)
    return run.train_state, actions_dim, continuous, env


def dreamer_step_vs_cpu(cfg, ckpt_path: str, device: str) -> dict:
    """One gradient step of a DreamerV2 or V1 checkpoint on ``device``
    against the same step on the CPU: the same parameters and Adam states,
    one batch drawn from the checkpoint's replay buffer and the same noise
    drawn on the CPU.  Each metric within LOSS_RTOL (LOSS_ATOL), the
    parameters after the step within PARAM_ATOL; the step's host time on
    each side."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.resilience.manager import restore_buffer
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

    module, _ = _dreamer_family(cfg.algo.name)
    state = load_checkpoint(ckpt_path)
    T, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    sample = restore_buffer(state["rb"]).sample(B, sequence_length=T, n_samples=1)
    batch = {k: torch.as_tensor(np.asarray(v[0]), dtype=torch.float32) for k, v in sample.items()}
    runs = {}
    for dev in ("cpu", device):
        ts, _, _, _ = _dreamer_run(cfg, state, dev)
        noise = module.draw_noise(cfg, T, B, ts.agent.actor, device="cpu", generator=torch.Generator().manual_seed(7))
        data = {k: v.to(dev) for k, v in batch.items()}
        noise = {k: v.to(dev) for k, v in noise.items()}
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = ts.train_fn(ts.opt_states, ts.moments, data, noise=noise)
        metrics = {k: float(v) for k, v in metrics.items()}
        ms = (time.perf_counter() - t0) * 1e3
        runs[dev] = {"metrics": metrics, "ms": ms, "params": {k: v.detach().cpu() for k, v in ts.agent.state_dict().items()}}
    cpu, card = runs["cpu"], runs[device]
    rel = {}
    for k, want in cpu["metrics"].items():
        have = card["metrics"][k]
        tol = LOSS_RTOL.get(k, 0.1 if k.startswith("Grads/") else LOSS_RTOL_DEFAULT)
        rel[k] = abs(have - want) / max(abs(want), 1e-12)
        if not np.isfinite(have) or abs(have - want) > tol * abs(want) + LOSS_ATOL:
            raise AssertionError(f"{cfg.algo.name} step on {device} against the CPU: {k} {have} vs {want}")
    err = max(float((card["params"][k] - v).abs().max()) for k, v in cpu["params"].items())
    if not np.isfinite(err) or err > PARAM_ATOL:
        raise AssertionError(f"{cfg.algo.name} step on {device} against the CPU: parameters differ by {err} > {PARAM_ATOL}")
    return {"max_abs_param_err": err, "param_tol": PARAM_ATOL, "metric_rel_err": rel, "metrics": card["metrics"],
            "step_ms": card["ms"], "cpu_step_ms": cpu["ms"], "T": T, "B": B}


def dreamer_player_vs_plain(cfg, ckpt_path: str, device: str, steps: int = 16) -> dict:
    """A DreamerV2 or V1 checkpoint's player on ``device`` against the same
    player on the CPU (plain versions): the same observations (a CPU rollout
    of 4 envs acting on the CPU's actions) and the same latent noise (Gumbel
    for V2's discrete latents, normals for V1's) for 16 steps; the recurrent
    states within STATE_TOL at every step, the greedy actions identical
    (discrete) or within STATE_TOL (continuous)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.envs.device import DeviceVectorEnv
    from sheeprl_tpu_torch.utils.ckpt_format import load_checkpoint

    state = load_checkpoint(ckpt_path)
    agents = {}
    for dev in (device, "cpu"):
        ts, actions_dim, continuous, env = _dreamer_run(cfg, state, dev)
        agents[dev] = ts.agent.player()
    wm_cfg = cfg.algo.world_model
    latent = (int(wm_cfg.stochastic_size),) + ((int(wm_cfg.discrete_size),) if cfg.algo.name == "dreamer_v2" else ())
    n = 4
    vec = DeviceVectorEnv(env, n, device="cpu", seed=3)
    obs = vec.reset(seed=3)[0]
    gen = torch.Generator().manual_seed(4)
    runs = {dev: {} for dev in agents}
    worst = worst_act = 0.0
    with torch.no_grad():
        for t in range(steps):
            u = torch.rand((1, n, *latent), generator=gen)
            noise = -torch.log(-torch.log(u.clamp_min(1e-30))) if len(latent) == 2 else torch.randn((1, n, *latent), generator=gen)
            acts = {}
            for dev, player in agents.items():
                st, rssm = runs[dev], player.world_model.rssm
                if not st:
                    st.update(rec=torch.zeros(1, n, rssm.recurrent_state_size, device=dev),
                              stoch=torch.zeros(1, n, int(np.prod(latent)), device=dev),
                              act=torch.zeros(1, n, sum(actions_dim), device=dev))
                emb = player.world_model.encoder({"state": torch.from_numpy(obs["state"]).to(dev).reshape(1, n, -1)})
                st["rec"] = rssm.recurrent_step(torch.cat([st["stoch"], st["act"]], -1), st["rec"])
                _, stoch = rssm._representation(st["rec"], emb, noise=noise.to(dev))
                st["stoch"] = stoch.reshape(1, n, -1)
                heads, _ = player.actor(torch.cat([st["stoch"], st["rec"]], -1), True)
                st["act"] = torch.cat(heads, -1)
                acts[dev] = st["act"].cpu()
            if continuous:
                worst_act = max(worst_act, float((acts[device] - acts["cpu"]).abs().max()))
                if not np.isfinite(worst_act) or worst_act > STATE_TOL:
                    raise AssertionError(f"step {t}: greedy actions differ by {worst_act} > {STATE_TOL}")
                step_actions = acts["cpu"].numpy().reshape(n, -1)
            else:
                if not torch.equal(acts[device].argmax(-1), acts["cpu"].argmax(-1)):
                    raise AssertionError(f"step {t}: greedy actions differ between {device} and the plain CPU player")
                step_actions = acts["cpu"].argmax(-1).numpy().reshape(n)
            err = float((runs[device]["rec"].cpu() - runs["cpu"]["rec"]).abs().max())
            worst = max(worst, err)
            if not np.isfinite(err) or err > STATE_TOL:
                raise AssertionError(f"step {t}: recurrent states differ by {err} > {STATE_TOL}")
            obs = vec.step(step_actions)[0]
    return {"steps": steps, "envs": n, "max_abs_state_err": worst, "tol": STATE_TOL,
            "actions": f"max abs err {worst_act}" if continuous else "identical"}


def run_dreamer_cli(algo: str, device: str, *, overrides=(), learning_starts: int = DREAMER_CLI_LEARNING_STARTS,
                    train_iters=None, profile: bool = True) -> dict:
    """DreamerV2 (``algo`` dreamer_v2: DV2_CLI_RUNS) or DreamerV1
    (dreamer_v1: DV1_CLI_RUNS) through ``sheeprl_tpu_torch.cli.run`` on
    ``device``, as ``run_dv3_cli`` runs DreamerV3: each run's loop rates,
    peak memory, its kernels' launches and a draw from its own cache against
    the plain versions, a profiled window; the first run resumed for one
    iteration, its checkpoint's player held against the plain CPU player and
    one gradient step on the card against the CPU."""
    import tempfile

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose

    exp, runs, kernels = {"dreamer_v2": (DV2_CLI_EXP, DV2_CLI_RUNS, DV2_CLI_KERNELS),
                          "dreamer_v1": (DV1_CLI_EXP, DV1_CLI_RUNS, DV1_CLI_KERNELS)}[algo]
    train_iters = DREAMER_CLI_TRAIN_ITERS[algo] if train_iters is None else train_iters
    accel = "cpu" if device == "cpu" else "cuda"
    out = {}
    with tempfile.TemporaryDirectory(prefix=f"{algo}_cli_") as root:
        for i, (name, extra) in enumerate(runs.items()):
            tag = f"{algo} {name}"
            args = [*exp, *extra, f"fabric.accelerator={accel}", f"root_dir={root}", f"run_name={algo}_{name}",
                    f"algo.learning_starts={learning_starts}", *overrides]
            cfg = compose(overrides=args)
            n = int(cfg.env.num_envs)
            window = _TrainWindow(dv3, "train_steps", 0, 0, False, check=_dv3_draw_check)
            res, wall, launches, peak = _cli_run(args + [f"algo.total_steps={learning_starts + train_iters * n}"], device,
                                                 window)
            if res["test_reward"] is None or not os.path.exists(res["checkpoint"] or ""):
                raise AssertionError(f"{tag}: no test reward or no final checkpoint: {res}")
            _require_launches(tag, launches, kernels[name], device)
            _require_checked(tag, window, kernels[name])
            row = {"env": cfg.env.id, "num_envs": n, "wall_s": wall, **_loop_rates(res, n, window),
                   "peak_memory_bytes": peak, "launches": {k: v for k, v in launches.items() if v},
                   "draw_vs_plain": window.checked, "test_reward": res["test_reward"]}
            if profile and device != "cpu":
                # a training call every 1 / replay_ratio iterations
                every = max(1, round(1 / float(cfg.algo.replay_ratio)))
                steps = learning_starts + (CLI_PROFILE_START + CLI_PROFILE_ITERS + 2) * every * n
                row["profile"] = _profiled_run(dv3, "train_steps", args, steps, f"{algo}_{name}_profiled")
            if i == 0:
                row["resumed"] = _resume_one(args, res, n, root, f"{algo}_{name}_resumed")
                row["player_vs_plain"] = dreamer_player_vs_plain(cfg, res["checkpoint"], device)
                row["step_vs_cpu"] = dreamer_step_vs_cpu(cfg, res["checkpoint"], device)
            out[name] = row
    return out


def run_dv2_cli(device: str, **kwargs) -> dict:
    return run_dreamer_cli("dreamer_v2", device, **kwargs)


def run_dv1_cli(device: str, **kwargs) -> dict:
    return run_dreamer_cli("dreamer_v1", device, **kwargs)


def mma_sync_peak(torch) -> dict:
    """TFLOP/s of independent ``mma.sync`` products (TF32 m16n8k8, bf16
    m16n8k16) on 264 blocks of 8 warps: the ceiling of the GRU step's
    product, which issues the same instructions."""
    import ctypes

    from sheeprl_tpu_torch.ops.build import BUILD_DIR, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib_path = BUILD_DIR / "mma_peak.cu", BUILD_DIR / "mma_peak.so"
    src.write_text(_MMA_PEAK_CU)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_peak_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    blocks, iters = 2 * torch.cuda.get_device_properties(0).multi_processor_count, 20000
    out = torch.empty(blocks * 256, device="cuda")
    res = {}
    for bf16, name, flop in ((0, "tf32", 2 * 16 * 8 * 8), (1, "bfloat16", 2 * 16 * 8 * 16)):
        if lib.mma_peak_run(bf16, out.data_ptr(), blocks, 100) != 0:
            raise RuntimeError("mma_peak launch failed")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lib.mma_peak_run(bf16, out.data_ptr(), blocks, iters)
        end.record()
        torch.cuda.synchronize()
        res[f"{name}_tflops"] = blocks * 8 * iters * 8 * flop / (start.elapsed_time(end) * 1e-3) / 1e12
    return res


def gru_bench(torch) -> int:
    """``--gru-bench [--root DIR]``: only the GRU step's check and timing rows
    (``check_gru_kernel``), for the package under DIR (default: this
    checkout).  Two checkouts compare on one card by alternating calls."""
    from sheeprl_tpu_torch.ops import gru_cell as gru_ops

    smi = nvidia_smi()
    phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, root=sys.path[0])
    phase("build", **build_kernels([gru_ops.LIBRARY]))
    torch.backends.cuda.matmul.allow_tf32 = False
    check_gru_kernel(torch, gru_ops.gru_cell, gru_ops.gru_cell_plain)
    phase("mma_sync_peak", **mma_sync_peak(torch))
    print(smi, flush=True)
    return 0


# One turn of --tree-bench: the sum-tree kernels' checks and rows and the
# transition gather's row of the checkout at argv[1], by that checkout's own
# chip_smoke.py.
_TREE_TURN = """
import sys
import torch
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as smoke
from sheeprl_tpu_torch.ops import per
smoke.phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smoke.nvidia_smi(), root=root)
smoke.phase("build", **smoke.build_kernels([per.LIBRARY]))
smoke.check_sum_tree_kernels(torch)
smoke.check_sharded_tree_kernels(torch)
# the transition gather at the SAC dispatch's shape: walker-walk rings of
# 250,000 rows x 4 envs (1,000,000 transitions), one draw's 16,384 rows
from types import SimpleNamespace
from sheeprl_tpu_torch.ops import gather
smoke.phase("build", **smoke.build_kernels([getattr(gather, "TRANSITIONS_LIBRARY", gather.LIBRARY)]))
g = torch.Generator(device="cuda").manual_seed(6)
cap, n_envs = 250000, 4
feats = {"terminated": (torch.uint8, 1), "truncated": (torch.uint8, 1), "actions": (torch.float32, smoke.WALKER_ACTIONS),
         "observations": (torch.float32, smoke.WALKER_OBS), "next_observations": (torch.float32, smoke.WALKER_OBS),
         "rewards": (torch.float32, 1)}
rings = {k: (torch.randint(0, 2, (cap, n_envs, f), generator=g, device="cuda", dtype=dt) if dt == torch.uint8
             else torch.randn(cap, n_envs, f, generator=g, device="cuda")) for k, (dt, f) in feats.items()}
leaves = torch.randint(0, cap * n_envs, (smoke.TREE_DRAWS,), generator=g, device="cuda")
smoke.time_transitions_gather(torch, SimpleNamespace(buffers=rings, n_envs=n_envs, capacity=cap), leaves)
print(smoke.nvidia_smi(), flush=True)
"""


def tree_bench(parent: str) -> int:
    """``--tree-bench DIR``: the sum-tree kernels' checks and rows of the
    checkout under DIR (the parent, unpacked with ``git archive``) and of
    this one in turns, parent, this, this, parent, each by its own
    ``chip_smoke.py`` in a process of its own on the one card, and the
    transition gather at the SAC shape on seeded walker-walk rings.  Each
    turn's output goes to ``chiprun_out/tree_bench_<turn>.log`` and its rows
    (``sum_tree_sample``, ``sum_tree_descend``, ``sum_tree_write``,
    ``sum_tree_update``, ``sum_tree_scatter``, the write cases and
    ``gather_transitions``) to ``chiprun_out/tree_bench.json``."""
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    turns = []
    for k, (label, root) in enumerate((("parent", parent), ("change", here), ("change", here), ("parent", parent))):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _TREE_TURN, root], capture_output=True, text=True, timeout=900)
        with open(os.path.join(out_dir, f"tree_bench_{k}_{label}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the tree turn under {root} failed ({proc.returncode})")
        rows = {}
        for ln in proc.stdout.splitlines():
            tag, _, body = ln.partition(" ")
            name = tag[1:-1]
            if name in ("sum_tree_sample", "sum_tree_descend"):
                row = json.loads(body)
                row.pop("checks", None)
                rows[f"{name}_e{row['exclusions']}"] = row
            elif name in ("sum_tree_write", "sum_tree_update", "gather_transitions"):
                rows[name] = json.loads(body)
            elif name == "sum_tree_scatter":
                row = json.loads(body)
                rows[f"{name}_{row['lanes']}"] = row
            elif name == "sum_tree_write_case":
                row = json.loads(body)
                rows[f"{name}_{row['kind']}_{row['lanes']}"] = row
        smi = proc.stdout.strip().splitlines()[-1]
        turns.append({"turn": label, "root": root, "nvidia_smi": smi, "rows": rows})
        phase("tree_bench", turn=label, root=root, nvidia_smi=smi, rows=rows)
    with open(os.path.join(out_dir, "tree_bench.json"), "w") as f:
        json.dump(turns, f, indent=1)
    print(turns[0]["nvidia_smi"], flush=True)
    return 0


# One turn of --seq-bench: the sequence's and the window gather's checks and
# rows of the checkout at argv[1], by that checkout's own chip_smoke.py, then
# the same measurements of both ops, taken the same way for every checkout.
_SEQ_TURN = """
import sys
import torch
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as smoke
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.ops import gather, gru_cell, seq_gru
smoke.phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smoke.nvidia_smi(), root=root)
smoke.phase("build", **smoke.build_kernels([gru_cell.LIBRARY, seq_gru.LIBRARY, gather.LIBRARY]))
torch.backends.cuda.matmul.allow_tf32 = False
smoke.check_seq_gru_kernel(torch)
g = torch.Generator(device="cuda").manual_seed(11)
dev = {}
for steps in (16, 64):
    is_first = torch.zeros(steps, 16, 1, device="cuda")
    is_first[steps // 2, 3] = 1.0
    args = [torch.tanh(torch.randn(16, 512, device="cuda", generator=g)), torch.randn(steps, 16, 512, device="cuda", generator=g),
            torch.randn(1024, 1536, device="cuda", generator=g) / 32, 1 + 0.1 * torch.randn(1536, device="cuda", generator=g),
            0.1 * torch.randn(1536, device="cuda", generator=g), is_first, torch.tanh(torch.randn(16, 512, device="cuda", generator=g))]
    call = lambda: seq_gru.gru_sequence(*args)
    dev[steps] = smoke.device_ms(torch, call, ops=True)
leaves = [a.clone().requires_grad_(i != 5) for i, a in enumerate(args)]
up = torch.randn(64, 16, 512, device="cuda", generator=g)
fwd_bwd = lambda: torch.autograd.grad(seq_gru.gru_sequence(*leaves), [a for i, a in enumerate(leaves) if i != 5], up)
smoke.phase("seq_bench_gru_sequence", shape="T=64, B=16, H=X=512", ms=smoke.time_ms(torch, call), device_ms=dev[64][0],
            device_ops=dev[64][1], host_us=smoke.host_us(torch, call, calls=200),
            per_step_us=(dev[64][0] - dev[16][0]) / 48 * 1e3, fwd_bwd_ms=smoke.time_ms(torch, fwd_bwd, iters=5, warmup=1))
rb, cache, fill = smoke.fill_replay(dotdict(smoke.XL_CRAFTER), "cuda", smoke.TRAIN_CAPACITY)
smoke.check_gather_kernel(torch, cache, 64, 16)
starts = torch.randint(0, smoke.TRAIN_CAPACITY - 64, (16,), generator=g, device="cuda", dtype=torch.int32)
envs = torch.zeros(16, dtype=torch.int32, device="cuda")
call = lambda: gather.gather_windows(cache.buffers, starts, envs, seq_len=64, batch_size=16)
d_ms, d_ops = smoke.device_ms(torch, call, ops=True)
smoke.phase("seq_bench_gather_windows", rows=1024, ms=smoke.time_ms(torch, call, iters=50), device_ms=d_ms, device_ops=d_ops,
            host_us=smoke.host_us(torch, call))
print(smoke.nvidia_smi(), flush=True)
"""


def seq_bench(parent: str) -> int:
    """``--seq-bench DIR``: the sequence GRU's and the window gather's checks
    and rows of the checkout under DIR (the parent, unpacked with ``git
    archive``) and of this one in turns, parent, this, this, parent, each by
    its own ``chip_smoke.py`` in a process of its own on the one card: the
    sequence at the decoupled DV3-S shape (T = 64, B = 16, H = X = 512) and
    the window gather of 64 x 16 windows from the seeded Crafter ring of the
    XL training phase.  Each turn also measures both ops the same way for
    every checkout (phases ``seq_bench_gru_sequence`` and
    ``seq_bench_gather_windows``: event, device and host time a call, device
    operations, the per-step slope, forward + backward).  Each turn's output
    goes to ``chiprun_out/seq_bench_<turn>.log`` and its rows to
    ``chiprun_out/seq_bench.json``."""
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    turns = []
    for k, (label, root) in enumerate((("parent", parent), ("change", here), ("change", here), ("parent", parent))):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _SEQ_TURN, root], capture_output=True, text=True, timeout=900)
        with open(os.path.join(out_dir, f"seq_bench_{k}_{label}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the sequence turn under {root} failed ({proc.returncode})")
        rows = {}
        for ln in proc.stdout.splitlines():
            tag, _, body = ln.partition(" ")
            name = tag[1:-1]
            if name in ("gru_sequence", "gru_input_product", "gather_windows", "seq_bench_gru_sequence",
                        "seq_bench_gather_windows"):
                rows[name] = json.loads(body)
        smi = proc.stdout.strip().splitlines()[-1]
        turns.append({"turn": label, "root": root, "nvidia_smi": smi, "rows": rows})
        phase("seq_bench", turn=label, root=root, nvidia_smi=smi,
              rows={k: rows[k] for k in ("seq_bench_gru_sequence", "seq_bench_gather_windows") if k in rows})
    with open(os.path.join(out_dir, "seq_bench.json"), "w") as f:
        json.dump(turns, f, indent=1)
    print(turns[0]["nvidia_smi"], flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if "--root" in sys.argv:
        root = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
    sys.path.insert(0, root)
    if "--gru-bench" in sys.argv:
        return gru_bench(torch)
    if "--tree-bench" in sys.argv:
        return tree_bench(sys.argv[sys.argv.index("--tree-bench") + 1])
    if "--seq-bench" in sys.argv:
        return seq_bench(sys.argv[sys.argv.index("--seq-bench") + 1])
    from sheeprl_tpu_torch.config import dotdict
    from sheeprl_tpu_torch.ops import gather as gather_ops
    from sheeprl_tpu_torch.ops import gru_cell as gru_ops
    from sheeprl_tpu_torch.ops import per as per_ops
    from sheeprl_tpu_torch.ops import seq_gru as seq_ops

    gru_cell, gru_cell_plain = gru_ops.gru_cell, gru_ops.gru_cell_plain

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    phase("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: every kernel of both paths, side by side
    phase("build", **build_kernels(
        [gru_ops.LIBRARY, gather_ops.LIBRARY, per_ops.LIBRARY, seq_ops.LIBRARY, launch_floor_library()]
    ))
    phase("gru_cell_sass", **gru_cell_sass(gru_ops.LIBRARY))

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
    tree_rows = check_sum_tree_kernels(torch)
    shard_rows = check_sharded_tree_kernels(torch)
    check_transitions_gather(torch)
    seq_row = check_seq_gru_kernel(torch)

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
    per_train = train.pop("per")
    phase("training_losses", kernels=train.pop("losses_kernels"), plain=train.pop("losses_plain"))
    phase("training", **train)
    phase("training_per", **per_train)
    torch.cuda.empty_cache()

    # 7. SAC: train_dispatch on walker-walk with prioritized replay, kernels then lax
    sac = run_sac(dotdict(SAC_WALKER), "cuda")
    transitions_row = sac.pop("gather")
    sac_profile = sac.pop("profile", None)
    phase("sac_losses", kernels=sac.pop("losses_kernels"), lax=sac.pop("losses_lax"))
    phase("sac_training", **sac)
    if sac_profile is not None:
        phase("sac_profile", **sac_profile)
    torch.cuda.empty_cache()

    # 7b. SAC on a mesh of 4 shards: the env-sharded cache and its per-shard
    # sum-trees (kernels #8 and #9), kernels then lax
    sharded = run_sac_sharded(dotdict(SAC_WALKER_SHARDED), "cuda", single_ms=sac["dispatch_ms_kernels"])
    sharded_profile = sharded.pop("profile", None)
    phase("sac_sharded_losses", kernels=sharded.pop("losses_kernels"), lax=sharded.pop("losses_lax"))
    phase("sac_sharded", **sharded)
    if sharded_profile is not None:
        phase("sac_sharded_profile", **sharded_profile)
    torch.cuda.empty_cache()

    # 8. decoupled DV3-S training on the full MsPacman ring: gru_sequence,
    # the GRU step (imagination) and the window gather, then plain
    dec = run_training(
        dotdict(S_PACMAN), PACMAN_OBS, PACMAN_ACTIONS, "cuda", capacity=PACMAN_CAPACITY,
        transitions=pacman_transitions, per=False, profile=True,
    )
    dec.pop("gather")
    dec_profile = dec.pop("profile")
    phase("training_decoupled_losses", kernels=dec.pop("losses_kernels"), plain=dec.pop("losses_plain"))
    phase("training_decoupled", **dec)
    phase("training_decoupled_profile", **dec_profile)
    torch.cuda.empty_cache()

    # 9. PPO and A2C on the device envs: the update at the published config,
    # the card against the CPU, collect at 256 envs, the CLI end to end
    ppo = run_ppo_training("cuda")
    phase("ppo_training", **ppo)
    phase("ppo_cli", **run_ppo_cli("cuda"))
    torch.cuda.empty_cache()

    # 9b. recurrent PPO (no kernel on this path): the update at the
    # published config, the card against the CPU, then the CLI end to end
    phase("rppo_training", card=smi, **run_rppo_training("cuda"))
    phase("rppo_cli", card=smi, **run_rppo_cli("cuda"))
    torch.cuda.empty_cache()

    # 9c. the PPO, SAC and recurrent-PPO servers, replayed on the CPU
    for family, row in run_serve_families("cuda").items():
        phase("serve_families", family=family, card=smi, **row)
    torch.cuda.empty_cache()

    # 10. DreamerV3 and SAC through the CLI on the device envs: the loops
    # reach the kernels (launches counted over each run)
    dv3_cli = run_dv3_cli("cuda")
    for label, row in dv3_cli.items():
        phase("dv3_cli", run=label, card=smi, **row)
    torch.cuda.empty_cache()
    sac_cli = run_sac_cli("cuda")
    phase("sac_cli", card=smi, **sac_cli)
    torch.cuda.empty_cache()

    # 10b. DroQ and Plan2Explore-DreamerV3 through the CLI: the prioritized
    # transition kernels on DroQ's critic draws, the GRU step, the sequence
    # GRU and the window gather on P2E's exploration and finetuning
    droq_cli = run_droq_cli("cuda")
    phase("droq_cli", card=smi, **droq_cli)
    torch.cuda.empty_cache()
    p2e_cli = run_p2e_dv3_cli("cuda")
    for label, row in p2e_cli.items():
        phase("p2e_dv3_cli", run=label, card=smi, **row)
    torch.cuda.empty_cache()

    # 10c. DreamerV2 and DreamerV1 through the CLI: the window gather, and
    # DV2's prioritized starts (#3, #5, #6), on the shared Dreamer loop
    dv2_cli = run_dv2_cli("cuda")
    for label, row in dv2_cli.items():
        phase("dv2_cli", run=label, card=smi, **row)
    torch.cuda.empty_cache()
    dv1_cli = run_dv1_cli("cuda")
    for label, row in dv1_cli.items():
        phase("dv1_cli", run=label, card=smi, **row)
    torch.cuda.empty_cache()

    def cli_launches(name: str) -> dict:
        dv3 = sum(row["launches"].get(name, 0) for row in dv3_cli.values())
        p2e = sum(row["launches"].get(name, 0) for row in p2e_cli.values()) \
            + p2e_cli["gridworld"]["finetuning"]["launches"].get(name, 0)
        paths = (("dv3_cli", dv3), ("sac_cli", sac_cli["launches"].get(name, 0)),
                 ("droq_cli", droq_cli["launches"].get(name, 0)), ("p2e_dv3_cli", p2e),
                 ("dv2_cli", sum(row["launches"].get(name, 0) for row in dv2_cli.values())),
                 ("dv1_cli", sum(row["launches"].get(name, 0) for row in dv1_cli.values())))
        return {k: v for k, v in paths if v}

    # 11. purity
    bad = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu", "gymnasium")
    )
    if bad:
        raise AssertionError(f"the port imported JAX-side modules: {bad[:5]}")
    phase("purity", jax_modules=0)

    # the GRU row at the training path's largest shape (imagination, B = 1024)
    main_row = next(r for r in gru_rows if r["batch"] == 1024 and r["hidden"] == 4096 and r["wdtype"] == "float32")
    kernels = [
        {
            "name": "gru_cell",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/gru_cell.cu",
            "replaces": "sheeprl_tpu/ops/pallas_gru.py:134",
            "launches": serve_launches + train["launches"]["gru_cell"] + dec["launches"]["gru_cell"]
            + sum(cli_launches("gru_cell").values()),
            "launches_by_path": {"serving": serve_launches, "training": train["launches"]["gru_cell"],
                                 "training_decoupled": dec["launches"]["gru_cell"], **cli_launches("gru_cell")},
            "max_abs_err": max(r["max_abs_err"] for r in gru_rows if r["wdtype"] == "float32"),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms": main_row["device_ms"],
            "library_device_ms": main_row["library_device_ms"],
            "bound_cuda_cores_ms": main_row["bound_cuda_cores_ms"],
            "shape": "B=1024, H=4096, X=1024, f32",
            "by_shape": [
                {k: r[k] for k in ("batch", "hidden", "wdtype", "ms", "device_ms", "plain_ms", "library_ms",
                                   "library_device_ms", "bound_ms", "bound_cuda_cores_ms", "max_abs_err")}
                for r in gru_rows
            ],
        },
        _kernel_entry("gather_windows", "sheeprl_tpu_torch/csrc/gather.cu", "sheeprl_tpu/ops/pallas_gather.py:84",
                      {"training": train["launches"]["gather_windows"],
                       "training_per": per_train["launches"]["gather_windows"],
                       "training_decoupled": dec["launches"]["gather_windows"],
                       "sac_sharded": sharded["state_check"]["uniform_window_gather_launches"],
                       **cli_launches("gather_windows")},
                      gather_row, f"{gather_row['rows']} rows x {gather_row['row_bytes']} B",
                      **{k: gather_row[k] for k in ("host_us", "launch_floor_ms", "device_ops", "plain_device_ms",
                                                    "library_device_ms")}),
        _kernel_entry("gather_transitions", "sheeprl_tpu_torch/csrc/gather.cu",
                      "sheeprl_tpu/ops/pallas_gather.py:127",
                      {"sac": sac["launches"]["gather_transitions"],
                       "sac_sharded": sharded["state_check"]["uniform_gather_launches"],
                       **cli_launches("gather_transitions")},
                      transitions_row, f"{transitions_row['rows']} rows x {transitions_row['row_bytes']} B",
                      **{k: transitions_row[k] for k in ("host_us", "launch_floor_ms", "device_ops", "library_device_ms")}),
        _kernel_entry("sum_tree_sample", "sheeprl_tpu_torch/csrc/sum_tree.cu", "sheeprl_tpu/ops/pallas_per.py:171",
                      {"sac": sac["launches"]["sum_tree_sample"], "training_per": per_train["launches"]["sum_tree_sample"],
                       **cli_launches("sum_tree_sample")},
                      tree_rows["sample_e0"], f"{TREE_DRAWS} draws, {TREE_LEAVES} leaves, no exclusions",
                      **{k: tree_rows["sample_e0"][k] for k in ("host_us", "launch_floor_ms", "device_ops")},
                      ms_e63=tree_rows["sample_e63"]["ms"], bound_ms_e63=tree_rows["sample_e63"]["bound_ms"],
                      device_ms_e63=tree_rows["sample_e63"]["device_ms"], device_ops_e63=tree_rows["sample_e63"]["device_ops"],
                      flips_f32_e63=tree_rows["sample_e63"]["checks"]["f32"]["flips"],
                      ms_e2016=tree_rows["sample_e2016"]["ms"], device_ms_e2016=tree_rows["sample_e2016"]["device_ms"],
                      bound_ms_e2016=tree_rows["sample_e2016"]["bound_ms"],
                      flips_integer_e2016=tree_rows["sample_e2016"]["checks"]["integer"]["flips"]),
        _kernel_entry("sum_tree_write", "sheeprl_tpu_torch/csrc/sum_tree.cu", "sheeprl_tpu/ops/pallas_per.py:252",
                      {"sac": sac["launches"]["sum_tree_write"], "training_per": per_train["launches"]["sum_tree_write"],
                       **cli_launches("sum_tree_write")},
                      tree_rows["sum_tree_write"], "256 lanes (one SAC flush), 2^20-leaf tree",
                      **{k: tree_rows["sum_tree_write"][k] for k in ("host_us", "launch_floor_ms", "device_ops")},
                      cases=_cases(tree_rows["write_cases"], "write")),
        _kernel_entry("sum_tree_update", "sheeprl_tpu_torch/csrc/sum_tree.cu", "sheeprl_tpu/ops/pallas_per.py:275",
                      {"sac": sac["launches"]["sum_tree_update"], **cli_launches("sum_tree_update")},
                      tree_rows["sum_tree_update"], f"{TREE_DRAWS} lanes, 2^20-leaf tree",
                      **{k: tree_rows["sum_tree_update"][k] for k in ("host_us", "launch_floor_ms", "device_ops")},
                      cases=_cases(tree_rows["write_cases"], "update")),
        _kernel_entry("gru_sequence", "sheeprl_tpu_torch/csrc/seq_gru.cu", "sheeprl_tpu/ops/seq_gru.py:126",
                      {"training_decoupled": dec["launches"]["gru_sequence"], **cli_launches("gru_sequence")},
                      seq_row, seq_row["shape"],
                      seq_route=seq_row["route"],
                      **{k: seq_row[k] for k in ("route_by_shape", "max_abs_err_f64_by_shape", "f32_tol",
                                                 "device_ops", "host_us", "per_step_us",
                                                 "fwd_bwd_ms", "plain_fwd_bwd_ms", "bound_cuda_cores_ms",
                                                 "device_ms_by_shape")}),
        _kernel_entry("gru_input_product", "sheeprl_tpu_torch/csrc/gru_cell.cu", "sheeprl_tpu/ops/seq_gru.py:126",
                      {"training_decoupled": dec["launches"]["gru_input_product"], **cli_launches("gru_input_product")},
                      seq_row["input_product"],
                      seq_row["input_product"]["shape"],
                      **{k: seq_row["input_product"][k] for k in ("device_ops", "host_us", "bound_cuda_cores_ms",
                                                                  "max_rel_err", "rtol")}),
        _kernel_entry("sum_tree_descend", "sheeprl_tpu_torch/csrc/sum_tree.cu", "sheeprl_tpu/ops/pallas_per.py:224",
                      {"sac_sharded": sharded["launches"]["sum_tree_descend"]}, shard_rows["descend_e4"],
                      f"{SHARDED_DRAWS} draws, one shard's {SHARD_LEAVES}-leaf sub-tree, 4 exclusions",
                      **{k: shard_rows["descend_e4"][k] for k in ("host_us", "launch_floor_ms", "device_ops")},
                      ms_e0=shard_rows["descend_e0"]["ms"], device_ms_e0=shard_rows["descend_e0"]["device_ms"],
                      bound_ms_e0=shard_rows["descend_e0"]["bound_ms"],
                      ms_e252=shard_rows["descend_e252"]["ms"], device_ms_e252=shard_rows["descend_e252"]["device_ms"],
                      bound_ms_e252=shard_rows["descend_e252"]["bound_ms"],
                      ms_e2016=shard_rows["descend_e2016"]["ms"], device_ms_e2016=shard_rows["descend_e2016"]["device_ms"],
                      flips_f32_e252=shard_rows["descend_e252"]["checks"]["f32"]["flips"]),
        _kernel_entry("sum_tree_scatter", "sheeprl_tpu_torch/csrc/sum_tree.cu", "sheeprl_tpu/ops/pallas_per.py:238",
                      {"sac_sharded": sharded["launches"]["sum_tree_scatter"]}, shard_rows[f"scatter_{SHARDED_DRAWS}"],
                      f"{SHARDED_DRAWS} lanes over 4 shards (one TD update's), one shard's {SHARD_LEAVES}-leaf sub-tree",
                      **{k: shard_rows[f"scatter_{SHARDED_DRAWS}"][k] for k in ("host_us", "launch_floor_ms", "device_ops")},
                      ms_1024=shard_rows["scatter_1024"]["ms"], device_ms_1024=shard_rows["scatter_1024"]["device_ms"],
                      bound_ms_1024=shard_rows["scatter_1024"]["bound_ms"],
                      host_us_1024=shard_rows["scatter_1024"]["host_us"],
                      device_ops_1024=shard_rows["scatter_1024"]["device_ops"],
                      cases=_cases(shard_rows["write_cases"], "scatter")),
    ]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels launched no time on the main path: {idle}")
    phase("wall", script_s=time.perf_counter() - _T0)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

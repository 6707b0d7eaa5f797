"""The port's training entry point (counterpart of ``sheeprl_tpu/cli.py``:
``run``, ``run_algorithm``, ``check_configs``, ``_build_runtime`` and
``resume_from_checkpoint``).

    python -m sheeprl_tpu_torch exp=ppo env=jax_cartpole algo.env_backend=jax

composes the port's own config tree (``sheeprl_tpu_torch/configs``),
builds the ``fabric`` runtime and calls the registered algorithm's entry
point.  It runs on ``cuda`` unless ``fabric.accelerator=cpu``; with no card
and no such override it raises.  ``evaluation`` and ``registration`` wait
for ROADMAP A2 and A7.
"""

from __future__ import annotations

import importlib
import os
import sys
from typing import Any, Optional, Sequence

from sheeprl_tpu_torch.config import compose, dotdict
from sheeprl_tpu_torch.config.compose import deep_merge, yaml_load
from sheeprl_tpu_torch.utils.registry import find_algorithm

__all__ = ["check_configs", "resume_from_checkpoint", "run", "run_algorithm"]


def resume_from_checkpoint(cfg: dotdict) -> dotdict:
    """The config of the checkpoint's run (``config.yaml`` of its log dir),
    with this invocation's steps, seed, names, checkpoint cadence, fabric
    and metric knobs (``sheeprl_tpu/cli.py:resume_from_checkpoint``)."""
    ckpt_path = cfg.checkpoint.resume_from
    old_cfg_path = os.path.join(os.path.dirname(os.path.dirname(ckpt_path)), "config.yaml")
    if not os.path.exists(old_cfg_path):
        old_cfg_path = os.path.join(os.path.dirname(ckpt_path), "config.yaml")
    if not os.path.exists(old_cfg_path):
        raise RuntimeError(f"Cannot find the config file of the checkpoint: {old_cfg_path}")
    with open(old_cfg_path) as f:
        old_cfg = yaml_load(f.read())
    if old_cfg["env"]["id"] != cfg.env.id:
        raise RuntimeError(
            f"This experiment is run with a different environment from the checkpoint: {old_cfg['env']['id']} vs {cfg.env.id}"
        )
    if old_cfg["algo"]["name"] != cfg.algo.name:
        raise RuntimeError(
            f"This experiment is run with a different algorithm from the checkpoint: {old_cfg['algo']['name']} vs {cfg.algo.name}"
        )
    merged = dict(old_cfg)
    deep_merge(
        merged,
        {
            "checkpoint": {
                "resume_from": ckpt_path,
                "every": cfg.checkpoint.every,
                "keep_last": cfg.checkpoint.keep_last,
                "save_last": cfg.checkpoint.save_last,
                "async_save": cfg.checkpoint.get("async_save", True),
                "sharded": cfg.checkpoint.get("sharded", False),
                "device_digests": cfg.checkpoint.get("device_digests", False),
            },
            "fabric": dict(cfg.fabric.items()),
            "metric": {
                "log_every": cfg.metric.log_every,
                "log_level": cfg.metric.log_level,
                "fetch_every": cfg.metric.get("fetch_every", 1),
                "disable_timer": cfg.metric.get("disable_timer", False),
            },
        },
    )
    merged["algo"]["total_steps"] = cfg.algo.total_steps
    if cfg.algo.get("learning_starts") is not None:
        merged["algo"]["learning_starts"] = cfg.algo.learning_starts
    for key in ("root_dir", "run_name", "exp_name", "seed"):
        merged[key] = cfg[key]
    return dotdict(merged)


def check_configs(cfg: dotdict) -> None:
    """Config validation: a registered algorithm, DDP-style layouts only."""
    strategy = str(cfg.fabric.get("strategy", "auto"))
    if strategy not in ("auto", "dp", "ddp"):
        raise ValueError(f"Unknown or unported fabric strategy '{strategy}'; the port has auto, dp and ddp (FSDP: ROADMAP A5)")
    find_algorithm(cfg.algo.name)


def _build_runtime(cfg: dotdict):
    """The ``fabric`` node instantiated (``sheeprl_tpu_torch.parallel.mesh.MeshRuntime``) and launched."""
    from sheeprl_tpu_torch.config import instantiate

    runtime = instantiate(dict(cfg.fabric), seed=int(cfg.seed))
    return runtime.launch()


def run_algorithm(cfg: dotdict) -> Any:
    """Registry lookup, the aggregator filtered to the algorithm's keys, the
    runtime, then the entry point; returns what the entry point returns."""
    module, entrypoint = find_algorithm(cfg.algo.name)
    algo_module = importlib.import_module(f"{module}.{cfg.algo.name}")
    utils_module = importlib.import_module(f"{module}.utils")
    keys = getattr(utils_module, "AGGREGATOR_KEYS", set())
    if "aggregator" in cfg.metric and "metrics" in cfg.metric.aggregator:
        cfg.metric.aggregator.metrics = dotdict({k: v for k, v in cfg.metric.aggregator.metrics.items() if k in keys})

    from sheeprl_tpu_torch.utils.metric import MetricAggregator
    from sheeprl_tpu_torch.utils.timer import timer

    # class-level flags: set both ways (an earlier run in this process may have disabled them)
    MetricAggregator.disabled = cfg.metric.log_level == 0
    timer.disabled = cfg.metric.log_level == 0 or bool(cfg.metric.get("disable_timer", False))
    runtime = _build_runtime(cfg)
    return getattr(algo_module, entrypoint)(runtime, cfg)


def run(args: Optional[Sequence[str]] = None) -> Any:
    """The training app: ``python -m sheeprl_tpu_torch exp=... [overrides]``."""
    overrides = list(args if args is not None else sys.argv[1:])
    cfg = compose(config_name="config", overrides=overrides)
    if cfg.checkpoint.resume_from == "auto":
        raise NotImplementedError("checkpoint.resume_from=auto (the newest valid checkpoint) waits for ROADMAP A6")
    if cfg.checkpoint.resume_from:
        cfg = resume_from_checkpoint(cfg)
    check_configs(cfg)
    return run_algorithm(cfg)

"""Algorithm registry (counterpart of ``sheeprl_tpu/utils/registry.py``).

Modules register their entry point at import with ``@register_algorithm``
and the CLI resolves ``cfg.algo.name`` to it.  :func:`find_algorithm`
imports the port's algorithm modules first (:data:`ALGORITHM_MODULES`), so
the registry is full without importing the package eagerly.  Evaluation
entry points wait for ROADMAP A2.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List

__all__ = ["ALGORITHM_MODULES", "algorithm_registry", "find_algorithm", "load_algorithms", "register_algorithm"]

# {module_root: [{"name": algo_name, "entrypoint": fn_name}]}
algorithm_registry: Dict[str, List[Dict[str, Any]]] = {}

#: the port's modules that register a training entry point
ALGORITHM_MODULES = (
    "sheeprl_tpu_torch.algos.ppo.ppo",
    "sheeprl_tpu_torch.algos.a2c.a2c",
    "sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent",
    "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
    "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2",
    "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1",
    "sheeprl_tpu_torch.algos.sac.sac",
    "sheeprl_tpu_torch.algos.droq.droq",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning",
    "sheeprl_tpu_torch.algos.sac_ae.sac_ae",
)


def register_algorithm() -> Callable:
    """Register ``fn`` under its module's file name (``.../ppo/ppo.py`` is
    ``ppo``).  Decoupled algorithms wait for ROADMAP A6."""

    def wrap(fn: Callable) -> Callable:
        root, name = fn.__module__.rsplit(".", 1)
        entries = algorithm_registry.setdefault(root, [])
        if not any(e["name"] == name for e in entries):
            entries.append({"name": name, "entrypoint": fn.__name__})
        return fn

    return wrap


def load_algorithms() -> None:
    for module in ALGORITHM_MODULES:
        importlib.import_module(module)


def find_algorithm(algo_name: str):
    """``(module, entrypoint)`` of a registered algorithm."""
    load_algorithms()
    for module, entries in algorithm_registry.items():
        for e in entries:
            if e["name"] == algo_name:
                return module, e["entrypoint"]
    raise RuntimeError(
        f"Algorithm '{algo_name}' is not registered in the port. Known: "
        + ", ".join(e["name"] for v in algorithm_registry.values() for e in v)
    )

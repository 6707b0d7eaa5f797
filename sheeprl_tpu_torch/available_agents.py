"""``python -m sheeprl_tpu_torch.available_agents``: the table of the port's
registered algorithms (counterpart of ``sheeprl_tpu/available_agents.py``)."""

from __future__ import annotations

from sheeprl_tpu_torch.utils.registry import algorithm_registry, load_algorithms


def available_agents() -> None:
    load_algorithms()
    rows = [("Module", "Algorithm", "Entrypoint")]
    for module, registrations in algorithm_registry.items():
        rows += [(module, a["name"], a["entrypoint"]) for a in registrations]
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))


if __name__ == "__main__":
    available_agents()

"""Metric accumulation on the host (counterpart of ``sheeprl_tpu/utils/metric.py``).

Values reach these metrics as host numbers (the loops fetch device
scalars at ``metric.fetch_every``).  ``sync_on_compute`` is accepted and
has nothing to gather: the port runs one process (multi-process runs wait
for ROADMAP A5).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["MeanMetric", "Metric", "MetricAggregator", "SumMetric"]


class Metric:
    """Accumulate / compute / reset."""

    def __init__(self, sync_on_compute: bool = False, **kwargs: Any):
        self.sync_on_compute = sync_on_compute
        self.reset()

    def update(self, value: Any) -> None:
        raise NotImplementedError

    def compute(self) -> float:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class MeanMetric(Metric):
    def update(self, value: Any) -> None:
        value = np.asarray(value, dtype=np.float64)
        self._total += float(np.nansum(value))
        self._count += int(np.isfinite(value).sum())

    def compute(self) -> float:
        return float("nan") if self._count == 0 else self._total / self._count

    def reset(self) -> None:
        self._total = 0.0
        self._count = 0


class SumMetric(Metric):
    def update(self, value: Any) -> None:
        self._total += float(np.asarray(value, dtype=np.float64).sum())

    def compute(self) -> float:
        return self._total

    def reset(self) -> None:
        self._total = 0.0


class MetricAggregator:
    """name -> :class:`Metric`, with a class-wide ``disabled`` flag; NaNs
    (metrics never updated) are dropped on compute."""

    disabled: bool = False

    def __init__(self, metrics: Optional[Dict[str, Metric]] = None, raise_on_missing: bool = False):
        self.metrics: Dict[str, Metric] = dict(metrics or {})
        self._raise_on_missing = raise_on_missing

    def update(self, name: str, value: Any) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            if self._raise_on_missing:
                raise KeyError(f"Unknown metric '{name}'")
            return
        self.metrics[name].update(value)

    def reset(self) -> None:
        if self.disabled:
            return
        for m in self.metrics.values():
            m.reset()

    def compute(self) -> Dict[str, float]:
        if self.disabled:
            return {}
        out = {}
        for name, metric in self.metrics.items():
            v = metric.compute()
            if v == v:  # not NaN
                out[name] = v
        return out

    def __contains__(self, name: str) -> bool:
        return name in self.metrics

"""Wall-clock timer accumulating into metrics (counterpart of
``sheeprl_tpu/utils/timer.py``).

Used around env interaction and train steps for the ``Time/sps_*``
throughputs; ``timer.disabled`` turns it into a no-op.  CUDA work is
asynchronous, so a region times what the host spent launching it unless
the region ends in a synchronisation (as on the JAX package, whose
regions end before ``block_until_ready``).
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator
from typing import Any, Dict, Type

from sheeprl_tpu_torch.utils.metric import Metric, SumMetric

__all__ = ["timer"]


class timer(ContextDecorator):
    disabled: bool = False
    timers: Dict[str, Metric] = {}

    def __init__(self, name: str, metric_cls: Type[Metric] = SumMetric, **metric_kwargs: Any):
        self.name = name
        self._metric_cls = metric_cls
        self._metric_kwargs = metric_kwargs

    def __enter__(self) -> "timer":
        if not timer.disabled:
            if self.name not in timer.timers:
                timer.timers[self.name] = self._metric_cls(**self._metric_kwargs)
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if not timer.disabled:
            timer.timers[self.name].update(time.perf_counter() - self._start)
        return False

    @classmethod
    def compute(cls) -> Dict[str, float]:
        if cls.disabled:
            return {}
        out = {}
        for name, metric in cls.timers.items():
            v = metric.compute()
            if v == v:
                out[name] = v
        return out

    @classmethod
    def reset(cls) -> None:
        cls.timers = {}

"""Host-to-device batch feed (counterpart of ``sheeprl_tpu/data/feed.py``).

When the replay window is not on the card, every gradient step's batch is
sampled on the host and copied over.  :func:`batched_feed` walks the leading
(n_samples) axis of a sampled dict on a worker thread, copies each batch to
the device from pinned memory, and keeps ``depth`` batches ahead so that
the copy of batch i + 1 overlaps step i.  ``uint8`` images stay ``uint8``
(the train step normalises on the device); every other key becomes f32.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["DevicePrefetcher", "batched_feed"]


def batched_feed(local_data: Dict[str, Any], n_batches: int, device, depth: int = 2) -> "DevicePrefetcher":
    counter = iter(range(n_batches))

    def producer() -> Optional[Dict[str, np.ndarray]]:
        i = next(counter, None)
        if i is None:
            return None
        return {
            k: np.asarray(v[i]) if getattr(v, "dtype", None) == np.uint8 else np.asarray(v[i], dtype=np.float32)
            for k, v in local_data.items()
        }

    return DevicePrefetcher(producer, device, depth=depth)


class DevicePrefetcher:
    """Iterator over ``producer()``'s numpy dicts (None ends it), each
    copied to ``device`` on a worker thread, ``depth`` batches ahead.  An
    error on the worker is raised by the next ``__next__``."""

    def __init__(self, producer: Callable[[], Optional[Dict[str, np.ndarray]]], device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._producer = producer
        self._device = torch.device(device)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, name="sheeprl-torch-prefetcher", daemon=True)
        self._thread.start()

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self._device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device) for k, v in batch.items()}
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(self._device, non_blocking=True) for k, v in batch.items()}
        # the consumer's stream may use the batch only once the copy is done
        torch.cuda.current_stream(self._device).synchronize()
        return out

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                batch = self._producer()
                if batch is None:
                    self._queue.put(None)
                    return
                batch = self._to_device(batch)
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised on the consumer's next __next__
            self._error = e
            try:
                self._queue.put(None, timeout=0.1)
            except queue.Full:
                pass

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        while True:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                raise StopIteration
            return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        while not self._queue.empty():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

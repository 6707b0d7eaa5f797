"""Client side of the inference service.

The port's copy of ``sheeprl_tpu/serve/client.py``: :class:`InferenceClient`
owns the failure envelope of one remote request (per-request deadline,
retry with exponential backoff under the same request id, optional hedged
resend, and a circuit breaker that sends the caller to its local fallback).
The flight-recorder spans and events are still to be ported.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.parallel.transport import INFER_REP_TAG, INFER_REQ_TAG
from sheeprl_tpu_torch.resilience.peer import PeerDiedError

__all__ = ["CircuitBreaker", "InferenceClient"]


class CircuitBreaker:
    """closed -> (threshold consecutive failures) -> open -> (cooldown)
    -> half_open -> one probe -> closed | open."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 3.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"
        self.failures = 0
        self.trips = 0
        self.reopens = 0
        self.promotions = 0
        self._opened_at = 0.0

    def allow_remote(self) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                self.state = "half_open"
                return True
            return False
        return True  # half_open: the single in-flight probe

    def record_success(self) -> None:
        if self.state == "half_open":
            self.promotions += 1
        self.state = "closed"
        self.failures = 0

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open":
            self.state = "open"
            self.reopens += 1
            self._opened_at = time.monotonic()
        elif self.state == "closed" and self.failures >= self.threshold:
            self.state = "open"
            self.trips += 1
            self._opened_at = time.monotonic()


class InferenceClient:
    """One worker's remote-inference endpoint.  ``infer(arrays, rows)``
    returns ``(outputs, "remote")`` or ``(None, "local")`` when the caller
    must act on its own."""

    def __init__(
        self,
        channel,
        client_id: int,
        *,
        request_timeout_s: float = 2.0,
        max_retries: int = 2,
        backoff_base_s: float = 0.05,
        hedge_s: float = 0.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 3.0,
    ):
        self._chan = channel
        self.client_id = int(client_id)
        self.request_timeout_s = float(request_timeout_s)
        self.max_retries = max(0, int(max_retries))
        self.backoff_base_s = float(backoff_base_s)
        self.hedge_s = float(hedge_s)
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown_s)
        self._next_id = 1
        self._last_arrays: List[Tuple[str, np.ndarray]] = []
        self._last_rows = 0
        self._last_reply_extra: tuple = ()  # the session tier reads reply flags here
        self._server_stopped = False
        self.requests = 0
        self.remote_used = 0
        self.local_fallbacks = 0
        self.retries = 0
        self.hedges = 0
        self.stale_replies = 0
        self.send_failures = 0
        self._lat = _LatencyWindow()

    def _send(self, req_id: int, arrays: List[Tuple[str, np.ndarray]], rows: int) -> None:
        self._chan.send(
            INFER_REQ_TAG, arrays=arrays, extra=(self.client_id, int(rows)), seq=req_id,
            timeout=self.request_timeout_s,
        )

    def _hedge_send(self, req_id: int, timeout: float) -> None:
        self._chan.send(
            INFER_REQ_TAG, arrays=self._last_arrays, extra=(self.client_id, self._last_rows),
            seq=req_id, timeout=timeout,
        )

    def _await_reply(self, req_id: int, timeout: float) -> Optional[Dict[str, np.ndarray]]:
        """Wait for the reply to exactly ``req_id``; duplicates and late
        replies to earlier ids are dropped by seq."""
        deadline = time.monotonic() + timeout
        hedged = False
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            if self.hedge_s > 0 and not hedged and timeout - remaining >= self.hedge_s:
                hedged = True
                self.hedges += 1
                try:
                    self._hedge_send(req_id, remaining)
                except (PeerDiedError, queue_mod.Full, OSError):
                    pass  # a failed hedge is a missing optimization, not an error
            try:
                frame = self._chan.recv(timeout=min(remaining, self.hedge_s or remaining, 0.25))
            except queue_mod.Empty:
                continue
            except PeerDiedError:
                return None
            if frame.tag == "stop":
                frame.release()
                self._server_stopped = True
                return None
            if frame.tag != INFER_REP_TAG or frame.seq != req_id:
                self.stale_replies += 1
                frame.release()
                continue
            self._last_reply_extra = tuple(frame.extra or ())
            out = frame.arrays_copy()
            frame.release()
            return out

    def _try_remote(self, arrays, rows: int, probe: bool = False) -> Optional[Dict[str, np.ndarray]]:
        req_id = self._next_id
        self._next_id += 1
        self._last_arrays, self._last_rows = arrays, rows
        attempts = 1 if probe else self.max_retries + 1
        t0 = time.monotonic()
        for attempt in range(attempts):
            try:
                self._send(req_id, arrays, rows)
            except (PeerDiedError, queue_mod.Full, OSError):
                self.send_failures += 1
                return None
            out = self._await_reply(req_id, self.request_timeout_s)
            if out is not None:
                self._lat.add(time.monotonic() - t0)
                return out
            if self._server_stopped:
                return None
            if attempt + 1 < attempts:
                self.retries += 1
                time.sleep(min(self.backoff_base_s * (2**attempt), 1.0))
        return None

    def infer(self, arrays: List[Tuple[str, np.ndarray]], rows: int) -> Tuple[Optional[Dict[str, np.ndarray]], str]:
        """One observation frame through the failure envelope."""
        self.requests += 1
        if self._server_stopped or not self.breaker.allow_remote():
            self.local_fallbacks += 1
            return None, "local"
        out = self._try_remote(arrays, rows, probe=self.breaker.state == "half_open")
        if out is not None:
            self.breaker.record_success()
            self.remote_used += 1
            return out, "remote"
        self.breaker.record_failure()
        self.local_fallbacks += 1
        return None, "local"

    def stats(self) -> Dict[str, Any]:
        return {
            "role": "client",
            "client_id": self.client_id,
            "breaker": self.breaker.state,
            "breaker_trips": self.breaker.trips,
            "requests": self.requests,
            "remote_used": self.remote_used,
            "local_fallbacks": self.local_fallbacks,
            # the audit invariant: every request was served exactly once
            "unaccounted": self.requests - self.remote_used - self.local_fallbacks,
            "retries": self.retries,
            "hedges": self.hedges,
            "stale_replies": self.stale_replies,
            "send_failures": self.send_failures,
            "latency_ms": self._lat.percentiles(),
        }

    def close(self) -> None:
        self._chan.close()


class _LatencyWindow:
    """Bounded request-latency sample for p50/p95/p99 (thread-safe)."""

    def __init__(self, depth: int = 512):
        self._depth = depth
        self._buf: List[float] = []
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self._buf.append(float(seconds))
            if len(self._buf) > self._depth:
                del self._buf[: len(self._buf) - self._depth]

    def percentiles(self) -> Dict[str, float]:
        with self._lock:
            buf = list(self._buf)
        return latency_percentiles(buf)


def latency_percentiles(seconds: List[float]) -> Dict[str, float]:
    """p50/p95/p99 in ms of a latency sample (empty dict when there is none)."""
    if not seconds:
        return {}
    arr = np.asarray(seconds) * 1e3
    return {
        "p50": float(np.percentile(arr, 50)),
        "p95": float(np.percentile(arr, 95)),
        "p99": float(np.percentile(arr, 99)),
        "n": len(seconds),
    }

"""Server side of the inference service: deadline batching over channels.

The port's copy of ``sheeprl_tpu/serve/service.py:InferenceServer``.
Clients ship observation frames; the server batches them (dispatch when the
oldest request is ``deadline_ms`` old, ``max_batch`` rows are pending, or
every attached client is waiting), zero-pads the batch up to a power-of-two
bucket, runs the policy once, and answers each request under its id.
Answered requests stay in a bounded per-client cache, so a retried
duplicate is answered from the cache and never acted twice.

``policy_fn(params, obs_dict, key) -> Dict[str, np.ndarray]`` is the
pluggable; ``key`` is an integer drawn from the server's seeded stream.
The flight-recorder spans, the fault-injection sites, drain-recover
respawn and the validated checkpoint hot-swap are still to be ported.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.parallel.transport import INFER_REP_TAG, INFER_REQ_TAG
from sheeprl_tpu_torch.resilience.peer import PeerDiedError
from sheeprl_tpu_torch.serve.client import latency_percentiles

__all__ = ["InferenceServer", "bucket_for"]


def bucket_for(rows: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= rows; an oversize batch runs at its own width."""
    for b in buckets:
        if rows <= b:
            return b
    return rows


def _default_buckets(max_batch: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


class _Request:
    __slots__ = ("client_id", "req_id", "rows", "arrays", "t_arrival")

    def __init__(self, client_id: int, req_id: int, rows: int, arrays: Dict[str, np.ndarray]):
        self.client_id = client_id
        self.req_id = req_id
        self.rows = rows
        self.arrays = arrays
        self.t_arrival = time.monotonic()


class InferenceServer:
    """Deadline-batched policy serving (see module docstring)."""

    def __init__(
        self,
        policy_fn: Optional[Callable[[Any, Dict[str, np.ndarray], Any], Dict[str, np.ndarray]]],
        params: Any,
        *,
        deadline_ms: float = 5.0,
        max_batch: int = 64,
        buckets: Optional[Tuple[int, ...]] = None,
        dedupe_depth: int = 256,
        seed: int = 0,
        name: str = "serve",
    ):
        self._policy_fn = policy_fn
        self._params = params
        self.deadline_s = max(0.0, float(deadline_ms)) / 1e3
        self.max_batch = max(1, int(max_batch))
        self.buckets = tuple(buckets) if buckets else _default_buckets(self.max_batch)
        self.dedupe_depth = int(dedupe_depth)
        self.name = name
        self._key_rng = np.random.default_rng(int(seed))
        self._channels: Dict[int, Any] = {}
        self._lock = threading.RLock()  # params + channel map
        self._pending: List[_Request] = []
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._dead: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        # dedupe: per client, answered req_id -> cached reply arrays
        self._acted: Dict[int, Dict[int, List[Tuple[str, np.ndarray]]]] = {}
        self.requests = 0
        self.acted = 0
        self.replies = 0
        self.dedup_hits = 0
        self.rows_served = 0
        self.batches = 0
        self.batch_hist: Dict[int, int] = {}  # bucket -> batches
        self.rows_hist: Dict[int, int] = {}  # real rows -> batches
        self.busy_s = 0.0  # time inside the policy calls
        self._lat: List[float] = []  # bounded request-latency window

    # ------------------------------------------------------------ lifecycle
    def attach(self, client_id: int, channel) -> None:
        with self._lock:
            self._channels[int(client_id)] = channel
            self._acted.setdefault(int(client_id), {})

    def start(self) -> "InferenceServer":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._dead = None
        self._thread = threading.Thread(target=self._serve_loop, name=f"sheeprl-infer-{self.name}", daemon=True)
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive() and self._dead is None

    @property
    def dead_reason(self) -> Optional[str]:
        return self._dead

    @property
    def params(self) -> Any:
        """The params (for the DreamerV3 family, the module) being served."""
        with self._lock:
            return self._params

    def close(self, timeout: float = 10.0) -> None:
        self._drain.set()
        t = self._thread
        if t is not None and t.is_alive() and t is not threading.current_thread():
            t.join(timeout=timeout)
        self._stop.set()
        with self._lock:
            channels = list(self._channels.values())
        for ch in channels:
            ch.close()

    # ------------------------------------------------------------ the loop
    def _serve_loop(self) -> None:
        try:
            while not self._stop.is_set():
                got = self._poll_requests()
                batch = self._form_batch(force=self._drain.is_set())
                if batch:
                    self._run_batch(batch)
                elif self._drain.is_set() and not self._pending:
                    self._send_stops()
                    return
                elif not got:
                    time.sleep(min(self.deadline_s / 2 if self.deadline_s else 0.001, 0.01))
        except Exception as e:  # the loop's death is reported through alive/dead_reason
            self._dead = f"{type(e).__name__}: {e}"

    def _poll_requests(self) -> int:
        """Drain whatever sits on the client channels; duplicates of
        answered requests are answered from the cache."""
        got = 0
        with self._lock:
            channels = list(self._channels.items())
        for cid, ch in channels:
            for _ in range(64):  # bounded sweep: a flooding client cannot starve the others
                try:
                    frame = ch.recv(timeout=0.0005)
                except (queue_mod.Empty, PeerDiedError):
                    break
                if frame.tag != INFER_REQ_TAG:
                    frame.release()
                    continue
                self.requests += 1
                req_cid = int(frame.extra[0]) if frame.extra else cid
                rows = int(frame.extra[1]) if len(frame.extra) > 1 else 1
                cache = self._acted.setdefault(req_cid, {})
                if frame.seq in cache:
                    self.dedup_hits += 1
                    self._reply(req_cid, frame.seq, cache[frame.seq])
                    frame.release()
                    continue
                self._pending.append(_Request(req_cid, frame.seq, rows, frame.arrays_copy()))
                frame.release()
                got += 1
        return got

    def _form_batch(self, force: bool = False) -> List[_Request]:
        if not self._pending:
            return []
        rows = sum(r.rows for r in self._pending)
        oldest_age = time.monotonic() - self._pending[0].t_arrival
        # clients are synchronous (one request in flight each): once every
        # attached client is pending nothing more can arrive before a reply
        covered = bool(self._channels) and len({r.client_id for r in self._pending}) >= len(self._channels)
        if not force and not covered and rows < self.max_batch and oldest_age < self.deadline_s:
            return []
        batch: List[_Request] = []
        taken = 0
        while self._pending:
            nxt = self._pending[0]
            if batch and taken + nxt.rows > self.max_batch:
                break
            batch.append(self._pending.pop(0))
            taken += nxt.rows
        return batch

    @staticmethod
    def _pad_concat(parts: List[np.ndarray], bucket: int, rows: int) -> np.ndarray:
        cat = np.concatenate(parts, axis=0) if len(parts) > 1 else np.asarray(parts[0])
        if bucket > rows:  # zero-pad up to the bucket; pad rows are sliced off the replies
            pad = np.zeros((bucket - rows,) + cat.shape[1:], dtype=cat.dtype)
            cat = np.concatenate([cat, pad], axis=0)
        return cat

    def _note_batch(self, bucket: int, rows: int, seconds: float) -> None:
        self.batches += 1
        self.batch_hist[bucket] = self.batch_hist.get(bucket, 0) + 1
        self.rows_hist[rows] = self.rows_hist.get(rows, 0) + 1
        self.busy_s += seconds

    def _run_batch(self, batch: List[_Request]) -> None:
        rows = sum(r.rows for r in batch)
        bucket = bucket_for(rows, self.buckets)
        obs = {k: self._pad_concat([r.arrays[k] for r in batch], bucket, rows) for k in batch[0].arrays}
        with self._lock:
            params = self._params
        t0 = time.monotonic()
        out = self._policy_fn(params, obs, int(self._key_rng.integers(0, 2**62)))
        self._note_batch(bucket, rows, time.monotonic() - t0)
        offset = 0
        now = time.monotonic()
        for r in batch:
            sliced = [(k, np.asarray(v[offset : offset + r.rows])) for k, v in out.items()]
            offset += r.rows
            cache = self._acted.setdefault(r.client_id, {})
            cache[r.req_id] = sliced
            while len(cache) > self.dedupe_depth:
                cache.pop(next(iter(cache)))
            self.acted += 1
            self.rows_served += r.rows
            self._lat.append(now - r.t_arrival)
            self._reply(r.client_id, r.req_id, sliced)
        if len(self._lat) > 512:
            del self._lat[: len(self._lat) - 512]

    def _reply(self, client_id: int, req_id: int, arrays: List[Tuple[str, np.ndarray]]) -> None:
        ch = self._channels.get(client_id)
        if ch is None:
            return
        try:
            ch.send(INFER_REP_TAG, arrays=arrays, extra=(client_id,), seq=req_id, timeout=5.0)
            self.replies += 1
        except (PeerDiedError, queue_mod.Full, OSError):
            pass  # a gone client re-requests or falls back locally

    def _send_stops(self) -> None:
        with self._lock:
            channels = list(self._channels.values())
        for ch in channels:
            try:
                ch.send("stop", timeout=2.0)
            except (PeerDiedError, queue_mod.Full, OSError):
                pass

    # ------------------------------------------------------------ telemetry
    def stats(self) -> Dict[str, Any]:
        state = "dead" if self._dead else ("draining" if self._drain.is_set() else "serving")
        return {
            "role": "server",
            "state": state,
            "requests": self.requests,
            "acted": self.acted,
            "replies": self.replies,
            "dedup_hits": self.dedup_hits,
            "rows_served": self.rows_served,
            "batches": self.batches,
            "batch_hist": {str(k): v for k, v in sorted(self.batch_hist.items())},
            "rows_hist": {str(k): v for k, v in sorted(self.rows_hist.items())},
            "busy_s": self.busy_s,
            "queue_depth": len(self._pending),
            "latency_ms": latency_percentiles(list(self._lat)),
        }

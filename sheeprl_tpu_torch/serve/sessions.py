"""Session-cached recurrent inference (the stateful serving tier).

The port's copy of ``sheeprl_tpu/serve/sessions.py``.  A client opens a
session and ships raw observations; the server keeps the session's
recurrent state between that client's requests, on the ``infer_req`` /
``infer_rep`` frames of the stateless service:

- request ``extra`` is ``(client_id, rows, op, session_id, seed)`` with
  ``op`` one of open/step/close (0 = a stateless request); replies carry
  ``(client_id, flag, session_id)``;
- :class:`SessionCache` holds per-session state under a capacity bound
  with LRU and idle-TTL eviction; a step against an unknown session is
  answered ``session_lost`` and the :class:`SessionClient` reopens and
  replays its observation;
- a duplicate of an acted request is answered from the cache, and a
  duplicate of a still-pending one is dropped, so a session never steps
  twice for one request;
- each batch gathers its sessions' state rows in request order and pads
  them up to the bucket with throwaway initial-state rows.

The flight-recorder events and the elastic pool's shared caches are still
to be ported.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.parallel.transport import INFER_REP_TAG, INFER_REQ_TAG
from sheeprl_tpu_torch.resilience.peer import PeerDiedError
from sheeprl_tpu_torch.serve.client import InferenceClient
from sheeprl_tpu_torch.serve.service import InferenceServer, _Request, bucket_for

__all__ = [
    "REPLY_CLOSED",
    "REPLY_LOST",
    "REPLY_OK",
    "REPLY_OPENED",
    "SESSION_CLOSE",
    "SESSION_NONE",
    "SESSION_OPEN",
    "SESSION_STEP",
    "SessionCache",
    "SessionClient",
    "SessionInferenceServer",
    "build_server",
    "session_knobs",
]

# request ops (request extra[2])
SESSION_NONE = 0
SESSION_OPEN = 1
SESSION_STEP = 2
SESSION_CLOSE = 3

# reply flags (reply extra[1])
REPLY_OK = 0
REPLY_LOST = 1  # session evicted/unknown: reopen + replay
REPLY_OPENED = 2  # reply extra[2] carries the server-assigned session id
REPLY_CLOSED = 3


def session_knobs(cfg) -> Dict[str, Any]:
    """The ``algo.serve.sessions.*`` surface, resolved with defaults."""
    serve = cfg.algo.get("serve", None) or {}
    sess = serve.get("sessions", None) or {}
    return {
        "enabled": bool(sess.get("enabled", False)),
        "capacity": int(sess.get("capacity", 1024)),
        "idle_ttl_s": float(sess.get("idle_ttl_s", 300.0)),
    }


def build_server(
    policy_fn,
    params,
    *,
    session: Optional[Dict[str, Any]] = None,
    session_policy_fn=None,
    init_state_fn=None,
    **kw,
):
    """``session["enabled"]`` and a stateful adapter pair ->
    :class:`SessionInferenceServer`; anything else -> the stateless
    :class:`~sheeprl_tpu_torch.serve.service.InferenceServer`."""
    session = session or {}
    if session.get("enabled") and session_policy_fn is not None and init_state_fn is not None:
        return SessionInferenceServer(
            policy_fn,
            params,
            session_policy_fn=session_policy_fn,
            init_state_fn=init_state_fn,
            capacity=int(session.get("capacity", 1024)),
            idle_ttl_s=float(session.get("idle_ttl_s", 300.0)),
            **kw,
        )
    return InferenceServer(policy_fn, params, **kw)


class _Session:
    __slots__ = ("sid", "rows", "state", "opened_ts", "last_used", "steps")

    def __init__(self, sid: int, rows: int, state: Dict[str, np.ndarray]):
        self.sid = sid
        self.rows = rows
        self.state = state
        self.opened_ts = time.monotonic()
        self.last_used = self.opened_ts
        self.steps = 0


class SessionCache:
    """Bounded per-session state store: LRU at the capacity bound, idle-TTL
    sweep between batches.  Thread-safe."""

    def __init__(self, capacity: int = 1024, idle_ttl_s: float = 300.0):
        self.capacity = max(1, int(capacity))
        self.idle_ttl_s = float(idle_ttl_s)
        self._lock = threading.RLock()
        self._sessions: "OrderedDict[int, _Session]" = OrderedDict()
        self._next_sid = 1
        self.opened = 0
        self.closed = 0
        self.hits = 0
        self.misses = 0
        self.evictions_lru = 0
        self.evictions_ttl = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def open(self, rows: int, state: Dict[str, np.ndarray]) -> int:
        with self._lock:
            while len(self._sessions) >= self.capacity:
                self._sessions.popitem(last=False)
                self.evictions_lru += 1
            sid = self._next_sid
            self._next_sid += 1
            self._sessions[sid] = _Session(sid, int(rows), state)
            self.opened += 1
            return sid

    def lookup(self, sid: int) -> Optional[_Session]:
        """The session, freshly touched (LRU move-to-end), or None."""
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                self.misses += 1
                return None
            self._sessions.move_to_end(sid)
            sess.last_used = time.monotonic()
            self.hits += 1
            return sess

    def update(self, sid: int, state: Dict[str, np.ndarray]) -> None:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                sess.state = state
                sess.steps += 1
                sess.last_used = time.monotonic()

    def close(self, sid: int) -> bool:
        with self._lock:
            if self._sessions.pop(sid, None) is not None:
                self.closed += 1
                return True
            return False

    def sweep_idle(self, now: Optional[float] = None) -> int:
        """Evict sessions idle past the TTL; returns the count."""
        if self.idle_ttl_s <= 0:
            return 0
        now = time.monotonic() if now is None else now
        with self._lock:
            idle = [s.sid for s in self._sessions.values() if now - s.last_used > self.idle_ttl_s]
            for sid in idle:
                del self._sessions[sid]
            self.evictions_ttl += len(idle)
        return len(idle)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._sessions),
                "rows": sum(s.rows for s in self._sessions.values()),
                "capacity": self.capacity,
                "opened": self.opened,
                "closed": self.closed,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / lookups if lookups else None,
                "evictions_lru": self.evictions_lru,
                "evictions_ttl": self.evictions_ttl,
            }


class _SessionRequest(_Request):
    __slots__ = ("op", "sid", "seed")

    def __init__(self, client_id, req_id, rows, arrays, op, sid, seed):
        super().__init__(client_id, req_id, rows, arrays)
        self.op = op
        self.sid = sid
        self.seed = seed


class SessionInferenceServer(InferenceServer):
    """The stateless server plus the session tier (see module docstring).

    ``session_policy_fn(params, obs, state) -> (out, new_state)`` steps a
    row-stacked batch of sessions; ``init_state_fn(rows, seed, params)``
    builds fresh per-row state (including the per-row noise stream).
    ``policy_fn`` may be None: stateless requests are then refused
    (counted) and their clients fall back locally."""

    def __init__(
        self,
        policy_fn,
        params,
        *,
        session_policy_fn: Callable[[Any, Dict, Dict], Tuple[Dict, Dict]],
        init_state_fn: Callable[[int, int, Any], Dict[str, np.ndarray]],
        capacity: int = 1024,
        idle_ttl_s: float = 300.0,
        **kw,
    ):
        super().__init__(policy_fn, params, **kw)
        self._session_policy_fn = session_policy_fn
        self._init_state_fn = init_state_fn
        self.sessions = SessionCache(capacity, idle_ttl_s)
        # (client_id, req_id) -> (reply flag, session id), evicted with the
        # acted-cache entry it annotates
        self._reply_meta: Dict[Tuple[int, int], Tuple[int, int]] = {}
        # ids queued but not yet acted: a duplicate landing here is dropped
        self._inflight: set = set()
        self.session_losses = 0
        self.dup_pending_dropped = 0
        self.stateless_refused = 0

    # ------------------------------------------------------------- protocol
    def _poll_requests(self) -> int:
        got = 0
        with self._lock:
            channels = list(self._channels.items())
        for cid, ch in channels:
            for _ in range(64):
                try:
                    frame = ch.recv(timeout=0.0005)
                except (queue_mod.Empty, PeerDiedError):
                    break
                if frame.tag != INFER_REQ_TAG:
                    frame.release()
                    continue
                self.requests += 1
                extra = frame.extra or ()
                req_cid = int(extra[0]) if extra else cid
                rows = int(extra[1]) if len(extra) > 1 else 1
                op = int(extra[2]) if len(extra) > 2 and extra[2] is not None else SESSION_NONE
                sid = int(extra[3]) if len(extra) > 3 and extra[3] is not None else 0
                seed = int(extra[4]) if len(extra) > 4 and extra[4] is not None else 0
                cache = self._acted.setdefault(req_cid, {})
                if frame.seq in cache:
                    # duplicate of an acted request: answered from the cache,
                    # with its original session flags
                    self.dedup_hits += 1
                    self._reply(req_cid, frame.seq, cache[frame.seq])
                    frame.release()
                    continue
                if (req_cid, frame.seq) in self._inflight:
                    # duplicate of a pending request: the original replies
                    self.dup_pending_dropped += 1
                    frame.release()
                    continue
                if op == SESSION_CLOSE:
                    closed = self.sessions.close(sid)
                    self._remember(req_cid, frame.seq, REPLY_CLOSED if closed else REPLY_LOST, sid)
                    self._store_acted(req_cid, frame.seq, [])
                    self._reply(req_cid, frame.seq, [])
                    frame.release()
                    continue
                self._pending.append(_SessionRequest(req_cid, frame.seq, rows, frame.arrays_copy(), op, sid, seed))
                frame.release()
                self._inflight.add((req_cid, frame.seq))
                got += 1
        return got

    # ------------------------------------------------------------- batches
    def _run_batch(self, batch: List[_Request]) -> None:
        stateless = [r for r in batch if getattr(r, "op", SESSION_NONE) == SESSION_NONE]
        stateful = [r for r in batch if getattr(r, "op", SESSION_NONE) != SESSION_NONE]
        if stateless:
            if self._policy_fn is None:
                self.stateless_refused += len(stateless)
            else:
                super()._run_batch(stateless)
            for r in stateless:
                self._inflight.discard((r.client_id, r.req_id))
        if stateful:
            self._run_session_batch(stateful)

    def _run_session_batch(self, batch: List[_SessionRequest]) -> None:
        with self._lock:
            params = self._params
        # opens create state, steps gather it, an unknown sid is answered
        # session_lost right away
        ready: List[_SessionRequest] = []
        states: List[Dict[str, np.ndarray]] = []
        for r in batch:
            if r.op == SESSION_OPEN:
                init = self._init_state_fn(r.rows, r.seed, params)
                r.sid = self.sessions.open(r.rows, init)
                states.append(init)
                ready.append(r)
                continue
            sess = self.sessions.lookup(r.sid)
            if sess is None or sess.rows != r.rows:
                self.session_losses += 1
                self._remember(r.client_id, r.req_id, REPLY_LOST, r.sid)
                self._store_acted(r.client_id, r.req_id, [])
                self._inflight.discard((r.client_id, r.req_id))
                self._reply(r.client_id, r.req_id, [])
                continue
            states.append(sess.state)
            ready.append(r)
        if not ready:
            return
        rows = sum(r.rows for r in ready)
        bucket = bucket_for(rows, self.buckets)
        obs = {k: self._pad_concat([r.arrays[k] for r in ready], bucket, rows) for k in ready[0].arrays}
        # pad rows get throwaway initial state; their outputs are sliced off
        pad_state = self._init_state_fn(bucket - rows, 0, params) if bucket > rows else None
        state: Dict[str, np.ndarray] = {}
        for k in states[0]:
            parts = [s[k] for s in states] + ([pad_state[k]] if pad_state is not None else [])
            state[k] = np.concatenate(parts, axis=0) if len(parts) > 1 else np.asarray(parts[0])
        t0 = time.monotonic()
        out, new_state = self._session_policy_fn(params, obs, state)
        self._note_batch(bucket, rows, time.monotonic() - t0)
        offset = 0
        now = time.monotonic()
        for r in ready:
            sliced = [(k, np.asarray(v[offset : offset + r.rows])) for k, v in out.items()]
            st = {k: np.asarray(v[offset : offset + r.rows]) for k, v in new_state.items()}
            offset += r.rows
            # the state transition commits with the acted-cache entry: a
            # later duplicate is answered from the cache, never re-stepped
            self.sessions.update(r.sid, st)
            self._remember(r.client_id, r.req_id, REPLY_OPENED if r.op == SESSION_OPEN else REPLY_OK, r.sid)
            self._store_acted(r.client_id, r.req_id, sliced)
            self.acted += 1
            self.rows_served += r.rows
            self._lat.append(now - r.t_arrival)
            self._inflight.discard((r.client_id, r.req_id))
            self._reply(r.client_id, r.req_id, sliced)
        if len(self._lat) > 512:
            del self._lat[: len(self._lat) - 512]
        self.sessions.sweep_idle()

    # ------------------------------------------------------------- plumbing
    def _remember(self, cid: int, req_id: int, flag: int, sid: int) -> None:
        self._reply_meta[(cid, req_id)] = (flag, sid)

    def _store_acted(self, cid: int, req_id: int, sliced) -> None:
        cache = self._acted.setdefault(cid, {})
        cache[req_id] = sliced
        while len(cache) > self.dedupe_depth:
            old = next(iter(cache))
            cache.pop(old)
            self._reply_meta.pop((cid, old), None)

    def _reply(self, client_id: int, req_id: int, arrays) -> None:
        ch = self._channels.get(client_id)
        if ch is None:
            return
        meta = self._reply_meta.get((client_id, req_id))
        extra = (client_id,) + tuple(meta) if meta is not None else (client_id,)
        try:
            ch.send(INFER_REP_TAG, arrays=arrays, extra=extra, seq=req_id, timeout=5.0)
            self.replies += 1
        except (PeerDiedError, queue_mod.Full, OSError):
            pass  # a gone client re-requests or falls back locally

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out["sessions"] = self.sessions.stats()
        out["session_losses"] = self.session_losses
        out["dup_pending_dropped"] = self.dup_pending_dropped
        out["stateless_refused"] = self.stateless_refused
        return out


class SessionClient(InferenceClient):
    """A stateless client of the session tier: the failure envelope plus
    the session handshake.  :meth:`step` opens the session on first use and
    reopens + replays the current observation when the server answers
    ``session_lost`` (the state then restarts from the session seed)."""

    def __init__(self, channel, client_id: int, *, seed: int = 0, **kw):
        super().__init__(channel, client_id, **kw)
        self.seed = int(seed)
        self.session_id = 0  # 0 = no open session
        self._op = SESSION_NONE
        self.session_losses = 0
        self.session_reopens = 0
        self.sessions_opened = 0

    def _session_extra(self, rows: int) -> tuple:
        return (self.client_id, int(rows), self._op, self.session_id, self.seed)

    def _send(self, req_id: int, arrays, rows: int) -> None:
        self._chan.send(
            INFER_REQ_TAG, arrays=arrays, extra=self._session_extra(rows), seq=req_id,
            timeout=self.request_timeout_s,
        )

    def _hedge_send(self, req_id: int, timeout: float) -> None:
        self._chan.send(
            INFER_REQ_TAG, arrays=self._last_arrays, extra=self._session_extra(self._last_rows),
            seq=req_id, timeout=timeout,
        )

    def _parse_reply(self) -> Tuple[int, int]:
        extra = self._last_reply_extra or ()
        flag = int(extra[1]) if len(extra) > 1 and extra[1] is not None else REPLY_OK
        sid = int(extra[2]) if len(extra) > 2 and extra[2] is not None else 0
        return flag, sid

    def step(self, arrays, rows: int):
        """One session step: ``(out, "remote")`` or ``(None, "local")``."""
        self._op = SESSION_STEP if self.session_id else SESSION_OPEN
        for _ in range(2):  # at most one transparent reopen-and-replay
            out, source = self.infer(arrays, rows)
            if source != "remote" or out is None:
                return None, "local"
            flag, sid = self._parse_reply()
            if flag == REPLY_LOST:
                self.session_losses += 1
                self.session_id = 0
                self.session_reopens += 1
                self._op = SESSION_OPEN
                continue
            if flag == REPLY_OPENED and sid:
                self.session_id = sid
                self.sessions_opened += 1
            return out, "remote"
        return None, "local"

    def close_session(self) -> None:
        if not self.session_id:
            return
        self._op = SESSION_CLOSE
        try:
            self.infer([], 0)
        finally:
            self.session_id = 0
            self._op = SESSION_NONE

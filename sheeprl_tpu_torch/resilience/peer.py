"""Peer-death detection for blocking queue operations.

The port's copy of what ``sheeprl_tpu/resilience/peer.py`` gives the
transport: :class:`PeerDiedError` and a queue ``get`` that polls the peer's
liveness between short waits, so a dead peer surfaces as an error instead
of a hang.
"""

from __future__ import annotations

import queue as queue_mod
import time
from typing import Any, Callable

__all__ = ["PeerDiedError", "queue_get_from_peer"]

_PEER_POLL_S = 0.5


class PeerDiedError(RuntimeError):
    """The peer died while a message was pending."""

    def __init__(self, who: str, detail: str = ""):
        self.who = who
        super().__init__(
            f"{who} died while a message was pending" + (f" ({detail})" if detail else "")
        )


def queue_get_from_peer(
    q,
    *,
    timeout: float,
    peer_alive: Callable[[], bool],
    who: str,
    poll_s: float = _PEER_POLL_S,
) -> Any:
    """``q.get`` with liveness polling: :class:`PeerDiedError` once the peer
    is seen dead (after one last drain), ``queue.Empty`` on a timeout."""
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise queue_mod.Empty
        try:
            return q.get(timeout=min(poll_s, remaining))
        except queue_mod.Empty:
            if not peer_alive():
                try:
                    return q.get_nowait()
                except queue_mod.Empty:
                    raise PeerDiedError(who) from None

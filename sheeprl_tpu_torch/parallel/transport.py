"""In-process queue transport for the serving plane.

The port's copy of the queue backend of ``sheeprl_tpu/parallel/transport.py``:
:class:`Frame`, the duplex :class:`Channel` API, :class:`QueueChannel` over
a bounded queue pair, :class:`ChannelSpec`, :class:`TransportHub` and
:func:`make_transport`, here over ``queue.Queue`` pairs for clients that are
threads of the serving process.  Queues between processes, and the shm and
tcp backends, are still to be ported.
"""

from __future__ import annotations

import queue as queue_mod
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.resilience.peer import PeerDiedError, queue_get_from_peer

__all__ = [
    "INFER_REP_TAG",
    "INFER_REQ_TAG",
    "Channel",
    "ChannelSpec",
    "Frame",
    "QueueChannel",
    "TransportHub",
    "make_transport",
]

# inference-service tags: a client ships one observation frame per request
# (seq = its monotonic request id, the dedupe key on both sides); the server
# answers with the action arrays under the same seq
INFER_REQ_TAG = "infer_req"
INFER_REP_TAG = "infer_rep"


class Frame:
    """One received transport message (arrays valid until :meth:`release`)."""

    __slots__ = ("tag", "seq", "extra", "arrays", "_release_cb")

    def __init__(self, tag: str, seq: int = -1, extra: Tuple = (), arrays=None, release_cb=None):
        self.tag = tag
        self.seq = int(seq)
        self.extra = tuple(extra)
        self.arrays: Dict[str, np.ndarray] = arrays or {}
        self._release_cb = release_cb

    def release(self) -> None:
        cb, self._release_cb = self._release_cb, None
        if cb is not None:
            cb()

    def arrays_copy(self) -> Dict[str, np.ndarray]:
        return {k: np.array(v) for k, v in self.arrays.items()}


class Channel:
    """One duplex link; ``peer_alive``/``who`` drive the liveness polling
    of every blocking operation."""

    def __init__(
        self,
        peer_alive: Optional[Callable[[], bool]] = None,
        who: str = "peer",
        poll_s: float = 0.5,
    ):
        self.peer_alive = peer_alive or (lambda: True)
        self.who = who
        self.poll_s = float(poll_s)

    def send(self, tag, arrays=None, extra=(), seq=-1, timeout=600.0) -> None:
        raise NotImplementedError

    def recv(self, timeout: float) -> Frame:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _put_with_peer(q, item, timeout: float, peer_alive, who: str) -> None:
    """Bounded-queue put that notices a dead peer instead of hanging."""
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise queue_mod.Full
        try:
            q.put(item, timeout=min(0.5, remaining))
            return
        except queue_mod.Full:
            if not peer_alive():
                raise PeerDiedError(who) from None


class QueueChannel(Channel):
    """Frames over a bounded queue pair."""

    _PICKLED = "__frame__"

    def __init__(self, send_q, recv_q, **kw):
        super().__init__(**kw)
        self._send_q = send_q
        self._recv_q = recv_q

    def send(self, tag, arrays=None, extra=(), seq=-1, timeout=600.0) -> None:
        payload = {k: np.asarray(v) for k, v in arrays} if arrays else None
        _put_with_peer(
            self._send_q, (self._PICKLED, tag, seq, tuple(extra), payload), timeout, self.peer_alive, self.who
        )

    def recv(self, timeout: float) -> Frame:
        msg = queue_get_from_peer(
            self._recv_q, timeout=timeout, peer_alive=self.peer_alive, who=self.who, poll_s=self.poll_s
        )
        if msg[0] != self._PICKLED:
            raise ValueError(f"unexpected message {msg[0]!r}")
        _, tag, seq, extra, payload = msg
        return Frame(tag, seq, extra, payload)


class ChannelSpec:
    """Recipe for the client side of one channel."""

    def __init__(self, player_id: int, *, to_trainer_q, to_player_q, poll_s: float = 0.5):
        self.player_id = int(player_id)
        self.to_trainer_q = to_trainer_q
        self.to_player_q = to_player_q
        self.poll_s = poll_s

    def player_channel(self, peer_alive=None, who: str = "server") -> Channel:
        return QueueChannel(self.to_trainer_q, self.to_player_q, peer_alive=peer_alive, who=who, poll_s=self.poll_s)


class TransportHub:
    """Server-side owner of the per-client channels."""

    def __init__(self, channels: Dict[int, Channel]):
        self._channels = channels

    def channel(self, player_id: int) -> Channel:
        return self._channels[player_id]

    def close(self) -> None:
        for ch in self._channels.values():
            ch.close()


def make_transport(
    num_players: int, *, window: int = 2, poll_s: float = 0.5
) -> Tuple[TransportHub, List[ChannelSpec]]:
    """The hub and per-client specs of ``num_players`` in-process clients.
    Each direction is a queue bounded at ``window + 2`` frames."""
    specs: List[ChannelSpec] = []
    channels: Dict[int, Channel] = {}
    for pid in range(num_players):
        to_t, to_p = queue_mod.Queue(maxsize=window + 2), queue_mod.Queue(maxsize=window + 2)
        specs.append(ChannelSpec(pid, to_trainer_q=to_t, to_player_q=to_p, poll_s=poll_s))
        channels[pid] = QueueChannel(to_p, to_t, who=f"client[{pid}]", poll_s=poll_s)
    return TransportHub(channels), specs

"""Channels: how router and workers talk, local or across processes (a
copy of `accelerate_tpu/serving/pod/distributed/transport.py`).

Three implementations of one tiny contract (`send` / `poll` / `closed`):

- `LocalChannel` — an in-process pair of deques that still pushes every
  message through the wire codec (encode on send, decode on poll), so
  the deterministic in-process pod tests exercise the exact bytes the
  socket path ships. This is what keeps the `local` transport honest:
  if a field can't survive the frame format, the in-process tests see it.
- `SocketChannel` — one TCP connection, a reader thread decoding frames
  into an inbox, and a writer thread draining a **bounded** send queue.
  The bound is the backpressure story: when a decode worker can't
  absorb shipments, `send` blocks the *router's* forwarding step (which
  already counts the stall); prefill workers keep extracting because
  nothing upstream of the router ever waits on a full queue.
- `FlakyTransport` — a deterministic fault injector wrapping any
  channel: drop / duplicate / delay / reorder individual messages, or
  kill / hang the link entirely. Plans are scripted or seeded so every
  recovery test replays identically.

Poll is non-blocking everywhere; the router's step loop owns pacing.
"""

from __future__ import annotations

import collections
import queue
import random
import socket
import threading
from typing import Callable, Iterable

from ....telemetry.lockwatch import maybe_tracked
from .wire import (Message, decode_message, encode_message, read_frame,
                   write_frame)

__all__ = [
    "Channel",
    "LocalChannel",
    "SocketChannel",
    "ChannelListener",
    "FlakyTransport",
    "DEFAULT_SEND_QUEUE_DEPTH",
]

# Enough for a heartbeat + a couple of shipments in flight; small enough
# that a stuck worker stalls the router within one window of traffic.
DEFAULT_SEND_QUEUE_DEPTH = 8


class Channel:
    """Bidirectional, ordered (per direction), message-oriented link."""

    def send(self, msg: Message) -> None:
        raise NotImplementedError

    def poll(self) -> list[Message]:
        """All messages that have arrived; never blocks."""
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class LocalChannel(Channel):
    """One endpoint of an in-process pair. Every message round-trips
    through the frame codec so in-process tests pin wire fidelity."""

    def __init__(self) -> None:
        self._inbox: collections.deque[bytes] = collections.deque()
        self._peer: "LocalChannel | None" = None
        self._closed = False
        self.bytes_sent = 0
        self.bytes_received = 0

    @classmethod
    def pair(cls) -> tuple["LocalChannel", "LocalChannel"]:
        a, b = cls(), cls()
        a._peer, b._peer = b, a
        return a, b

    def send(self, msg: Message) -> None:
        if self._closed or self._peer is None or self._peer._closed:
            raise ConnectionError("local channel closed")
        frame = encode_message(msg)
        self.bytes_sent += len(frame)
        self._peer._inbox.append(frame)

    def poll(self) -> list[Message]:
        out = []
        while self._inbox:
            frame = self._inbox.popleft()
            self.bytes_received += len(frame)
            out.append(decode_message(frame))
        return out

    @property
    def closed(self) -> bool:
        return self._closed or (self._peer is not None and self._peer._closed)

    def close(self) -> None:
        self._closed = True


class SocketChannel(Channel):
    """One TCP connection with a bounded send queue.

    `send` blocks when the queue is full (that IS the backpressure), and
    raises ConnectionError once the link is dead so callers fail fast
    instead of queueing into the void. Any socket error in either
    thread marks the channel closed; the owner notices via `.closed`
    and runs its recovery path — no exception escapes a daemon thread.
    """

    def __init__(self, sock: socket.socket,
                 send_queue_depth: int = DEFAULT_SEND_QUEUE_DEPTH) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._sendq: queue.Queue[bytes | None] = queue.Queue(
            maxsize=max(1, send_queue_depth))
        self._inbox: collections.deque[Message] = collections.deque()
        self._lock = maybe_tracked("pod-channel")
        self._closed = threading.Event()
        self.bytes_sent = 0
        self.bytes_received = 0
        self._reader = threading.Thread(
            target=self._read_loop, name="atp-pod-reader", daemon=True)
        self._writer = threading.Thread(
            target=self._write_loop, name="atp-pod-writer", daemon=True)
        self._reader.start()
        self._writer.start()

    @classmethod
    def connect(cls, host: str, port: int, timeout_s: float = 30.0,
                **kwargs) -> "SocketChannel":
        sock = socket.create_connection((host, port), timeout=timeout_s)
        sock.settimeout(None)
        return cls(sock, **kwargs)

    def _read_loop(self) -> None:
        try:
            while not self._closed.is_set():
                frame = read_frame(self._sock)
                msg = decode_message(frame)
                with self._lock:
                    self.bytes_received += len(frame)
                    self._inbox.append(msg)
        except Exception:
            self._mark_closed()

    def _write_loop(self) -> None:
        try:
            while True:
                frame = self._sendq.get()
                if frame is None:
                    return
                write_frame(self._sock, frame)
                with self._lock:
                    self.bytes_sent += len(frame)
        except Exception:
            self._mark_closed()

    def _mark_closed(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # unblock any sender parked on a full queue
        try:
            self._sendq.put_nowait(None)
        except queue.Full:
            pass

    def send(self, msg: Message) -> None:
        frame = encode_message(msg)
        while True:
            if self._closed.is_set():
                raise ConnectionError("socket channel closed")
            try:
                self._sendq.put(frame, timeout=0.1)
                return
            except queue.Full:
                continue  # bounded queue full: block the caller (router)

    def poll(self) -> list[Message]:
        out = []
        with self._lock:
            while self._inbox:
                out.append(self._inbox.popleft())
        return out

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        self._mark_closed()
        # reap the IO threads: the socket shutdown kicks the reader out
        # of read_frame and the None sentinel kicks the writer off the
        # queue, so both exit promptly. `_mark_closed` itself must NOT
        # join — it runs on the reader/writer's own error paths, and a
        # thread cannot join itself.
        me = threading.current_thread()
        if self._reader is not me:
            self._reader.join(timeout=5.0)
        if self._writer is not me:
            self._writer.join(timeout=5.0)


class ChannelListener:
    """Router-side accept socket: workers dial in, the router polls
    `accept_all()` each step for new channels (non-blocking)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 send_queue_depth: int = DEFAULT_SEND_QUEUE_DEPTH) -> None:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self._srv.setblocking(False)
        self._depth = send_queue_depth
        self.host, self.port = self._srv.getsockname()[:2]

    def accept_all(self) -> list[SocketChannel]:
        out = []
        while True:
            try:
                sock, _addr = self._srv.accept()
            except (BlockingIOError, OSError):
                return out
            sock.setblocking(True)
            out.append(SocketChannel(sock, send_queue_depth=self._depth))

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

_ACTIONS = ("ok", "drop", "dup", "delay", "reorder")


class FlakyTransport(Channel):
    """Deterministic fault injector around any channel.

    Each message (per direction, sequence-numbered) is assigned one of:

    - ``ok``      — pass through
    - ``drop``    — silently discarded (lost datagram / dead hop)
    - ``dup``     — delivered twice (retransmit race)
    - ``delay``   — held for ``delay_ticks`` calls of the moving side
    - ``reorder`` — held until the *next* message passes, then delivered

    The plan is either an explicit ``rules(direction, kind, seq)``
    callable (direction is ``"send"`` or ``"recv"``) or a seeded RNG via
    ``flake_rate`` — both replay identically run to run. Beyond message
    faults, ``kill()`` closes the link (dropped-connection recovery) and
    ``hang()`` keeps it open but silent both ways (the missed-heartbeat
    path: the worker looks alive at the TCP layer and says nothing).
    """

    def __init__(self, inner: Channel,
                 rules: Callable[[str, str, int], str] | None = None,
                 flake_rate: float = 0.0, seed: int = 0,
                 delay_ticks: int = 2,
                 protect_kinds: Iterable[str] = ()) -> None:
        self.inner = inner
        self._rules = rules
        self._rng = random.Random(seed)
        self._flake_rate = flake_rate
        self._delay_ticks = delay_ticks
        self._protect = frozenset(protect_kinds)
        self._seq = {"send": 0, "recv": 0}
        self._held: dict[str, list[list]] = {"send": [], "recv": []}
        self._hung = False
        self.faults: collections.Counter[str] = collections.Counter()

    def _action(self, direction: str, kind: str) -> str:
        seq = self._seq[direction]
        self._seq[direction] = seq + 1
        if kind in self._protect:
            return "ok"
        if self._rules is not None:
            action = self._rules(direction, kind, seq)
            if action not in _ACTIONS:
                raise ValueError(f"unknown fault action {action!r}")
        elif self._flake_rate and self._rng.random() < self._flake_rate:
            action = self._rng.choice(("drop", "dup", "delay", "reorder"))
        else:
            action = "ok"
        if action != "ok":
            self.faults[f"{direction}:{action}"] += 1
        return action

    def _tick_held(self, direction: str, deliver) -> None:
        kept = []
        for entry in self._held[direction]:
            mode, msg, ticks = entry
            if mode == "delay":
                ticks -= 1
                if ticks <= 0:
                    deliver(msg)
                else:
                    kept.append([mode, msg, ticks])
            else:
                kept.append(entry)
        self._held[direction] = kept

    def _release_reorders(self, direction: str, deliver) -> None:
        kept = []
        for entry in self._held[direction]:
            if entry[0] == "reorder":
                deliver(entry[1])
            else:
                kept.append(entry)
        self._held[direction] = kept

    def _route(self, direction: str, msg: Message, deliver) -> None:
        action = self._action(direction, msg.kind)
        if action == "drop":
            return
        if action == "dup":
            deliver(msg)
            deliver(msg)
            return
        if action == "delay":
            self._held[direction].append(["delay", msg, self._delay_ticks])
            return
        if action == "reorder":
            self._held[direction].append(["reorder", msg, 0])
            return
        deliver(msg)
        # a message got through: anything held for reordering now follows it
        self._release_reorders(direction, deliver)

    def send(self, msg: Message) -> None:
        if self.inner.closed:
            # kill beats hang: a dead link fails fast even while wedged
            raise ConnectionError("flaky transport: link closed")
        if self._hung:
            return  # swallowed: the link looks open, nothing moves
        self._tick_held("send", self.inner.send)
        self._route("send", msg, self.inner.send)

    def poll(self) -> list[Message]:
        if self._hung:
            self.inner.poll()  # drain so a later un-hang can't replay
            return []
        out: list[Message] = []
        self._tick_held("recv", out.append)
        for msg in self.inner.poll():
            self._route("recv", msg, out.append)
        return out

    def kill(self) -> None:
        """Hard-drop the link: `.closed` flips, sends raise."""
        self.faults["kill"] += 1
        self.inner.close()

    def hang(self) -> None:
        """Wedge the link silently: open at the transport layer, but no
        message moves in either direction (missed-heartbeat recovery)."""
        self.faults["hang"] += 1
        self._hung = True

    @property
    def closed(self) -> bool:
        return self.inner.closed

    def close(self) -> None:
        self.inner.close()

"""Cross-host ring channels for compiled graphs (NetRing v1); a port of
``ray_tpu/core/net_ring.py``.

The shm rings in :mod:`ray_tpu_torch.experimental.channel` are /dev/shm — both
endpoints must share a host.  This module is the cross-host data plane:
the SAME slot/seq ring discipline carried over an authenticated
message-passing session (``multiprocessing.connection`` over TCP, the
peer-mesh transport ``core/object_transfer.py`` uses), where messages —
unlike mmap stores — can be lost, duplicated, and reordered across
connection breaks, and an endpoint process can restart mid-protocol.

The protocol is NOT designed here.  It implements, rule for rule, the
machine-checked contract in ``ray_tpu/tools/lint/ring_model_net.py``
(the JAX package's lint check ``ring-protocol-net``, exhaustively explored for
``n_slots ∈ {1, 2}`` under loss + duplication + reordering + one
crash-restart, every guard mutation-tested):

- **Send window** — the writer produces only while ``w - acked <
  n_slots``; unacked payloads are retained in ``_unacked`` (the net
  analog of ring slots) until acknowledged, so a data message can never
  overwrite an unconsumed slot.
- **Slot stamping + seq cross-check** — a data message ``(nrd, seq, …)``
  stamps receive slot ``(seq-1) % n_slots``; the reader consumes
  strictly in seq order and cross-checks the stamped seq against
  ``r + 1`` exactly like the shm per-slot header check.
- **Cumulative acks, folded by max()** — the reader acks ``(nra, r)``
  after every consume; stale/reordered/duplicated acks are harmless.
- **Go-Back-N re-ack** — a data message outside ``r < seq <= r +
  n_slots`` is dropped AND re-acked with the cumulative ack.  The
  re-ack is load-bearing: a lost final ack would otherwise pin the
  writer's window shut forever (the wedge the spec's model checker
  caught in its first draft).
- **Retransmit** — the writer re-sends ``acked + 1`` whenever an
  unacked message exists and no ack progress was observed for a
  retransmit interval (and immediately after a reconnect).  Retransmit
  + re-ack also heal a writer-session restart with no handshake:
  ``acked`` is a session-volatile cache that rebuilds from re-acks.
- **Hybrid park/wake** — bounded spin, then raise the own parked flag,
  RECHECK the condition, sleep; a delivery (the network doorbell) rings
  the parked side iff its flag is up.  Here the flag/recheck/sleep
  sequence runs under the endpoint's condition lock, which is strictly
  stronger than the model's interleaving (the model proves the
  lock-free ordering; the lock can only remove interleavings).
- **Reader-only resync** — a reader attaching without a cursor sends
  ``(nrrq)``; the writer answers ``(nrbase, acked)`` and the reader
  adopts ``r = acked`` (delivery degrades to at-least-once across a
  reader restart — the DAG layer's seq-tagged results make
  re-execution idempotent).  In the compiled-graph integration a
  restarted executor gets FRESH rings at rebind, so resync is the
  transport-level recovery path (same-ring reader re-attach), kept
  conformant to the spec and exercised by the conformance tests.

Wire session (one duplex authenticated connection per edge, writer
dials the reader process's :class:`NetRingHost` listener):

    writer -> host:   ("nring", ring_id)          attach to the ring
    writer -> reader: ("nrd", seq, tag, payload)  data (seq from 1)
                      ("nrdv", seq, tag, nbytes)  data header; the next
                                                  frame is the raw
                                                  writev'd segment body
                                                  (tensor zero-copy)
                      ("nrbase", acked)           resync reply
    reader -> writer: ("nra", r)                  cumulative ack
                      ("nrrq",)                   resync request

Every send passes the ``wire.send.<tag>`` chaos point
(``RAY_TPU_TEST_FAULT_SPEC``: ``wire.send.nra=drop@3`` loses the 3rd
ack, ``wire.send.nrd=delay:50`` stalls data), so the fault harness can
drive exactly the loss cases the model checker proved recoverable.

The endpoints expose the same channel API the shm rings present
(``wait_writable`` / ``write`` / ``write_serialized`` / ``write_array``
/ ``read`` / ``occupancy`` / ``close``), so the compiled-graph layer
picks shm or net per edge without the driver or executor loops caring.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ray_tpu_torch.experimental.channel import (
    RETRANSMITS,
    STALLS,
    STATS,
    TAG_BYTES,
    TAG_DATA,
    TAG_ERROR,
    TAG_STOP,
    TAG_STREAM,
    TAG_TENSOR,
    ChannelClosed,
    ChannelTimeout,
    _maybe_flush,
    _sp_park,
    _sp_wait_read,
    _sp_wait_write,
    host_bytes,
    parse_tensor,
    tensor_payload,
)
from ray_tpu_torch.util import flight_recorder as _fr

# net-side retransmission instants (the shared RETRANSMITS counter cell
# feeds the registry; the span gives each event a timeline position)
_sp_retransmit = _fr.register_span("net.retransmit", tag_keys=("channel",))

from .fault_injection import should_drop as _fault_should_drop

# wait tuning: bounded optimistic spin before parking on the condition
# (on a busy edge data arrives on the rx thread soon after the send;
# parking costs a futex round trip per message)
_SPIN_ITERS = 1000


class _Segments(tuple):
    """A tensor payload kept as its framed segments — (len-prefix, meta,
    raw buffer view) — all the way to the socket write.

    ``_LockedSend.send_segments`` writevs the segments straight into
    the connection as one mpc-framed body, so NO joined intermediate
    copy of the tensor ever exists on the send path (the shm rings'
    pack-into-the-slot equivalent for TCP). Instances sit in
    ``_unacked`` as-is for retransmission: the segments are VIEWS of
    the produced array, retained until acked per the durable-slot
    contract — which makes ``write_array`` of a numpy array an
    ownership transfer (MPI_Isend semantics): the caller must not mutate
    the array until it is acked, or a retransmit after a session
    break/stall ships the mutated bytes; a caller recycling one host
    buffer must copy before writing. A torch tensor is not borrowed:
    a CUDA tensor's bytes are copied to a fresh host buffer by the
    device-to-host transfer anyway, and a CPU tensor is snapshotted
    (counted in ``STATS["tensor_copy_bytes"]``), because tensors are
    mutable and a method may return a view of state it keeps
    updating (see ``channel.host_bytes``)."""

    __slots__ = ()

    @property
    def total(self) -> int:
        return sum(len(s) for s in self)

    def join(self) -> bytes:
        """Materialize (the non-writev fallback); counted as a copy."""
        STATS["tensor_copy_bytes"] += self.total
        return b"".join(bytes(s) if not isinstance(s, bytes) else s
                        for s in self)


def _writev_all(fd, buffers) -> None:
    """``os.writev`` the buffer list fully (blocking fd): partial writes
    advance across segment boundaries without re-buffering."""
    bufs = [memoryview(b).cast("B") for b in buffers if len(b)]
    while bufs:
        n = os.writev(fd, bufs)
        while bufs and n >= len(bufs[0]):
            n -= len(bufs[0])
            bufs.pop(0)
        if n and bufs:
            bufs[0] = bufs[0][n:]


class _LockedSend:
    """Serialize sends on one duplex connection: the consume thread's
    acks and the serve/rx thread's protocol replies share the socket,
    and ``multiprocessing.connection`` framing is not thread-safe."""

    __slots__ = ("_conn", "_lock")

    def __init__(self, conn):
        self._conn = conn
        self._lock = threading.Lock()

    def __call__(self, msg) -> None:
        # deliberate: this lock exists ONLY to serialize the socket
        # write and is a leaf — no other lock is ever taken under it,
        # and it is never held across anything but this one send
        with self._lock:
            self._conn.send(msg)  # graftlint: ignore[blocking-under-lock]

    def send_segments(self, header_msg, segments: _Segments) -> None:
        """Two frames under one lock hold: the pickled header tuple,
        then the segments writev'd as a single raw mpc-framed body
        (``!i`` length prefix — same framing ``Connection.send_bytes``
        emits, so the peer's ``recv_bytes`` reads it back verbatim).
        The lock keeps the frame pair adjacent on the stream."""
        import struct

        total = segments.total
        if total > 0x7FFFFFFF:  # mpc large-frame pre-header territory
            raise ValueError(f"segment body of {total}B exceeds the "
                             f"single-frame limit")
        frame = [struct.pack("!i", total)] + list(segments)
        with self._lock:
            self._conn.send(header_msg)  # graftlint: ignore[blocking-under-lock]
            _writev_all(self._conn.fileno(), frame)  # graftlint: ignore[blocking-under-lock]


def _net_send(send, tag: str, *payload) -> bool:
    """Send one net-ring message through ``send`` with the chaos
    wire-point applied. Returns False when the message was dropped (by
    injection or a broken session) — callers never raise: the protocol
    recovers every loss via retransmit/re-ack.

    A data message whose payload is a :class:`_Segments` rides the
    writev path when the session sender supports it: the wire carries
    ``("nrdv", seq, tag, nbytes)`` followed by the raw framed body (the
    serve loop reassembles ``("nrd", seq, tag, body)`` before applying
    it, so the protocol state machine sees one identical "nrd" either
    way — the chaos point is likewise keyed "nrd" for both spellings).
    Senders without a socket (model-conformance harnesses, scripted
    traces) fall back to joining — the copy the counter then records."""
    if _fault_should_drop("wire.send", tag):
        return False
    try:
        if payload and isinstance(payload[-1], _Segments):
            body = payload[-1]
            if tag == "nrd" and hasattr(send, "send_segments"):
                send.send_segments(
                    ("nrdv",) + payload[:-1] + (body.total,), body)
                return True
            send((tag,) + payload[:-1] + (body.join(),))
            return True
        send((tag,) + payload)
        return True
    except Exception:
        return False  # session broke mid-send: reconnect + retransmit


class _Endpoint:
    """State + park/wake shared by both ring ends."""

    def __init__(self, ring_id: str, n_slots: int, capacity: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.ring_id = ring_id
        self.n_slots = n_slots
        self.capacity = capacity
        self.path = f"net:{ring_id}"  # error messages parity with shm
        base = ring_id.split("_", 1)[-1] if "_" in ring_id else ring_id
        self._metric_name = f"net:{base}"
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.parked = 0  # the model's wflag/rflag (wake elision)
        self._closed: Optional[BaseException] = None
        self._send: Optional[Callable] = None  # attached session send

    def attach_send(self, send: Optional[Callable]) -> None:
        with self._lock:
            self._send = send

    # set by each concrete end: which side of the ring stalls here
    _wait_role = "read"

    def _wait(self, ready, timeout: Optional[float]) -> None:
        """Hybrid wait for ``ready()`` (called under no lock): bounded
        spin, then flag-RECHECK-sleep under the condition lock — the
        delivering rx thread notifies iff the flag is up."""
        if ready():
            return
        # real wait: time it for the stall counter + flight-rec span
        # (shared dicts with the shm channel layer — one flush path)
        t0 = time.monotonic()
        try:
            self._wait_slow(ready, timeout)
        finally:
            dur = time.monotonic() - t0
            key = (self._metric_name, self._wait_role)
            STALLS[key] = STALLS.get(key, 0.0) + dur
            (_sp_wait_write if self._wait_role == "write"
             else _sp_wait_read).end_at(t0, dur, self._metric_name)

    def _wait_slow(self, ready, timeout: Optional[float]) -> None:
        for i in range(_SPIN_ITERS):
            if ready():
                return
            if i & 7 == 7:
                os.sched_yield()
        _sp_park.instant(self._metric_name, self._wait_role)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if self._closed is not None:
                    raise ChannelClosed(self.path) from self._closed
                self.parked = 1
                try:
                    if ready():
                        return
                    remaining = 0.2 if deadline is None else min(
                        0.2, deadline - time.monotonic())
                    if remaining <= 0:
                        raise ChannelTimeout(self.path)
                    self._cv.wait(remaining)
                finally:
                    self.parked = 0

    def _ring_bell(self) -> None:
        """Wake a parked peer thread (call under self._lock)."""
        if self.parked:
            self._cv.notify_all()

    def poison(self, cause: Optional[BaseException] = None) -> None:
        """Fail every current and future wait with ChannelClosed (the
        death-path analog of the shm STOP sentinel: a dead peer's ring
        has no live writer, so the local end unwedges itself)."""
        with self._cv:
            if self._closed is None:
                self._closed = cause or ChannelClosed(self.path)
            self._cv.notify_all()

    def occupancy(self) -> int:
        raise NotImplementedError

    def _check_closed(self) -> None:
        if self._closed is not None:
            raise ChannelClosed(self.path) from self._closed


class NetRingWriter(_Endpoint):
    """Producing end: owns ``w`` and the unacked payload window.

    ``_unacked`` retains every produced payload until the cumulative ack
    covers it — the durable-slot contract the model's writer-restart
    recovery relies on. ``acked`` is a session-volatile cache rebuilt
    from (re-)acks."""

    _wait_role = "write"

    def __init__(self, ring_id: str, n_slots: int, capacity: int,
                 send: Optional[Callable] = None):
        super().__init__(ring_id, n_slots, capacity)
        self.w = 0
        self.acked = 0
        self._unacked: Dict[int, Tuple[int, bytes]] = {}  # seq -> (tag, b)
        self._send = send
        self._last_acked_seen = 0
        # TCP session machinery (None in harness/conformance mode)
        self._conn = None
        self._conn_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []

    # ---- protocol state ----

    def writable(self) -> bool:
        return self.w - self.acked < self.n_slots

    def occupancy(self) -> int:
        return self.w - self.acked

    def wait_writable(self, timeout: Optional[float] = None) -> None:
        """Block until the send window is open WITHOUT producing. A
        window observed open stays open until this (single-writer)
        thread produces — acks only widen it — so multi-edge input
        rounds stay all-or-nothing exactly as with shm rings."""
        self._check_closed()
        self._wait(self.writable, timeout)

    def produce(self, payload: bytes, tag: int = TAG_DATA) -> int:
        """Window-checked produce + send (the model's ``w:produce``).
        Callers must have observed the window open (wait_writable)."""
        with self._lock:
            self._check_closed()
            if not self.writable():
                raise ChannelTimeout(
                    f"{self.path}: send window closed (w={self.w} "
                    f"acked={self.acked} n_slots={self.n_slots})")
            self.w += 1
            seq = self.w
            self._unacked[seq] = (tag, payload)
            send = self._send
        if send is not None:
            _net_send(send, "nrd", seq, tag, payload)
        STATS["messages"] += 1
        _maybe_flush(self)
        return seq

    # ---- channel API (shm parity) ----

    def write(self, payload: bytes, tag: int = TAG_DATA,
              timeout: Optional[float] = None) -> None:
        if len(payload) > self.capacity:
            raise ValueError(
                f"message of {len(payload)}B exceeds channel slot capacity "
                f"{self.capacity}B (raise buffer_size_bytes)")
        self._wait(self.writable, timeout)
        self.produce(bytes(payload), tag)
        if tag == TAG_DATA or tag == TAG_ERROR:
            STATS["serialized_bytes"] += len(payload)
        elif tag == TAG_BYTES or tag == TAG_STREAM:
            STATS["raw_bytes"] += len(payload)

    def write_serialized(self, sobj, timeout: Optional[float] = None) -> None:
        total = sobj.total_bytes
        if total > self.capacity:
            raise ValueError(
                f"message of {total}B exceeds channel slot capacity "
                f"{self.capacity}B (raise buffer_size_bytes)")
        self._wait(self.writable, timeout)
        self.produce(sobj.to_bytes(), TAG_DATA)
        STATS["serialized_bytes"] += total

    def write_array(self, arr, timeout: Optional[float] = None) -> None:
        """Typed-tensor path: same wire format as the shm TENSOR slots
        ([meta_len][meta][raw]) and no OBJECT serializer on either end.
        The payload stays a :class:`_Segments` (prefix, meta, raw view)
        all the way to the socket, where the session sender writevs the
        framed body — zero full-tensor copies between the produced
        array and the TCP stream (``STATS["tensor_copy_bytes"]``
        asserts it; the pre-writev code paid one copy joining the
        segments and a second pickling the joined payload).

        Zero-copy contract: a numpy array is borrowed until acked (the
        retransmit buffer holds views, not a snapshot — see
        :class:`_Segments`). Don't mutate a numpy ``arr`` after
        writing; pass a copy if the buffer is recycled. A tensor's
        bytes go through one host buffer of their own
        (``channel.host_bytes``)."""
        meta, raw = tensor_payload(arr)
        payload = _Segments((len(meta).to_bytes(4, "little"), meta,
                             memoryview(host_bytes(raw)).cast("B")))
        if payload.total > self.capacity:
            raise ValueError(
                f"message of {payload.total}B exceeds channel slot "
                f"capacity {self.capacity}B (raise buffer_size_bytes)")
        self._wait(self.writable, timeout)
        self.produce(payload, TAG_TENSOR)
        STATS["tensor_bytes"] += raw.nbytes

    # ---- deliveries (writer side of the session) ----

    def on_message(self, msg: tuple,
                   reply: Optional[Callable] = None) -> None:
        """Apply one reader->writer message (the model's ack-channel
        delivery). ``reply`` sends back toward the reader (resync)."""
        kind = msg[0]
        if kind == "nra":
            with self._lock:
                new_acked = max(self.acked, msg[1])
                progressed = new_acked > self.acked
                self.acked = new_acked
                if progressed:
                    for seq in [s for s in self._unacked
                                if s <= new_acked]:
                        del self._unacked[seq]
                    self._ring_bell()
        elif kind == "nrrq":
            # reader resync request: answer with the retained-base seq
            with self._lock:
                base = self.acked
            if reply is not None:
                _net_send(reply, "nrbase", base)

    def retransmit_once(self) -> bool:
        """Re-send ``acked + 1`` while anything is unacked (the model's
        ``w:retransmit``; cumulative-ack Go-Back-N). When the payload
        for that seq is already freed — a restarted writer session
        whose pre-crash acks covered it — send a zero-length PROBE with
        the same seq: the reader's window check classifies it stale and
        answers the cumulative re-ack, which is all a freed seq is ever
        retransmitted for (a stale message's payload is never consumed;
        this is how ``acked`` rebuilds with no handshake)."""
        with self._lock:
            if self.acked >= self.w:
                return False
            seq = self.acked + 1
            tag, payload = self._unacked.get(seq, (TAG_DATA, b""))
            send = self._send
        if send is None:
            return False
        RETRANSMITS[0] += 1
        _sp_retransmit.instant(self._metric_name)
        return _net_send(send, "nrd", seq, tag, payload)

    # ---- TCP session ----

    @classmethod
    def connect(cls, address, authkey: bytes, ring_id: str,
                n_slots: int, capacity: int) -> "NetRingWriter":
        """Dial the reader process's NetRingHost and keep the session
        alive: a broken connection re-dials with backoff, and the
        retransmit timer re-covers whatever the gap lost."""
        self = cls(ring_id, n_slots, capacity)
        self._address = tuple(address)
        self._authkey = authkey
        self._dial()  # first connect synchronous: surface bad addresses
        t_rx = threading.Thread(target=self._rx_loop, daemon=True,
                                name=f"nring-w-rx-{ring_id[:12]}")
        t_rt = threading.Thread(target=self._retransmit_loop, daemon=True,
                                name=f"nring-w-rt-{ring_id[:12]}")
        self._threads = [t_rx, t_rt]
        for t in self._threads:
            t.start()
        return self

    def _dial(self) -> None:
        from multiprocessing import connection as mpc

        from .object_transfer import _tune_conn

        conn = mpc.Client(address=self._address, family="AF_INET",
                          authkey=self._authkey)
        _tune_conn(conn)
        conn.send(("nring", self.ring_id))
        with self._conn_lock:
            self._conn = conn
        self.attach_send(_LockedSend(conn))

    def _rx_loop(self) -> None:
        """Session thread: deliver acks; on EOF re-dial until closed.
        Runs the reconnect too, so there is exactly one thread touching
        the connection lifecycle."""
        backoff = 0.05
        while not self._stop.is_set():
            with self._conn_lock:
                conn = self._conn
            if conn is None:
                try:
                    self._dial()
                    backoff = 0.05
                except Exception:
                    self._stop.wait(backoff)
                    backoff = min(backoff * 2, 2.0)
                continue
            try:
                msg = conn.recv()
            except Exception:
                # peer gone or conn shut down: drop the session; the
                # retransmit timer re-covers the unacked window after
                # the re-dial
                self.attach_send(None)
                with self._conn_lock:
                    if self._conn is conn:
                        self._conn = None
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            try:
                with self._lock:
                    reply = self._send  # the session's locked sender
                self.on_message(msg, reply=reply)
            except Exception:
                pass  # malformed message: the protocol state is untouched

    def _retransmit_loop(self) -> None:
        from .config import global_config

        interval = max(0.005,
                       global_config().net_ring_retransmit_ms / 1000.0)
        while not self._stop.wait(interval):
            with self._lock:
                acked, w = self.acked, self.w
                stale = acked == self._last_acked_seen
                self._last_acked_seen = acked
            if acked < w and stale:
                self.retransmit_once()

    def close(self, unlink: bool = False) -> None:
        self._stop.set()
        self.poison()
        with self._conn_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            try:  # shutdown pops a parked recv immediately (EOF)
                import socket as _socket

                s = _socket.socket(fileno=os.dup(conn.fileno()))
                try:
                    s.shutdown(_socket.SHUT_RDWR)
                finally:
                    s.close()
            except (OSError, ValueError):
                pass
            try:
                conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []


class NetRingReader(_Endpoint):
    """Consuming end: owns ``r`` and the receive ring.

    Created with ``resync=True`` when attaching to a ring whose writer
    may hold state from a previous reader session: consumption defers
    until the ``nrrq``/``nrbase`` handshake adopts ``r = acked``."""

    def __init__(self, ring_id: str, n_slots: int, capacity: int,
                 resync: bool = False):
        super().__init__(ring_id, n_slots, capacity)
        self.r = 0
        self._slots = [None] * n_slots  # (seq, tag, payload) | None
        self.resyncing = resync  # the model's RESYNC pc

    # ---- protocol state ----

    def readable(self) -> bool:
        if self.resyncing:
            return False
        slot = self._slots[self.r % self.n_slots]
        return slot is not None and slot[0] == self.r + 1

    def occupancy(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def start_resync(self) -> None:
        """Send the resync request (the model's ``r:resync-send``);
        at-least-once — re-sent on every session attach while still
        resyncing."""
        with self._lock:
            send = self._send if self.resyncing else None
        if send is not None:
            _net_send(send, "nrrq")

    # ---- deliveries (reader side of the session) ----

    def on_message(self, msg: tuple,
                   reply: Optional[Callable] = None) -> None:
        """Apply one writer->reader message (the model's data-channel
        delivery). ``reply`` sends back toward the writer (acks)."""
        kind = msg[0]
        if kind == "nrd":
            seq = msg[1]
            reack = None
            with self._lock:
                if self.resyncing:
                    # no cursor yet: drop; retransmission re-covers the
                    # unacked window once resync completes
                    return
                if not (self.r < seq <= self.r + self.n_slots):
                    # stale/zombie seq: Go-Back-N re-ack so a lost final
                    # ack cannot pin the writer's window shut
                    reack = self.r
                else:
                    self._slots[(seq - 1) % self.n_slots] = \
                        (seq, msg[2], msg[3])
                    self._ring_bell()
            if reack is not None and reply is not None:
                _net_send(reply, "nra", reack)
        elif kind == "nrbase":
            with self._lock:
                if self.resyncing:
                    self.r = msg[1]
                    self.resyncing = False
                    self._ring_bell()
            # else: stale resync reply — ignore

    # ---- channel API (shm parity) ----

    def consume(self) -> Tuple[int, bytes]:
        """In-order consume with the per-slot seq cross-check; sends the
        cumulative ack. Callers must have observed ``readable()``."""
        with self._lock:
            self._check_closed()
            idx = self.r % self.n_slots
            slot = self._slots[idx]
            if slot is None:
                raise ChannelTimeout(f"{self.path}: nothing readable")
            seq, tag, payload = slot
            if seq != self.r + 1:  # torn/stale stamp: protocol violation
                raise ChannelClosed(
                    f"{self.path}: slot seq {seq} != expected {self.r + 1}")
            self._slots[idx] = None
            self.r += 1
            r = self.r
            send = self._send
        if send is not None:
            _net_send(send, "nra", r)
        return tag, payload

    def read(self, timeout: Optional[float] = None):
        self._wait(self.readable, timeout)
        tag, payload = self.consume()
        _maybe_flush(self)
        if tag == TAG_STOP:
            raise ChannelClosed(self.path)
        if tag == TAG_TENSOR:
            return (TAG_TENSOR, parse_tensor(payload, 0))
        return (tag, payload) if tag in (TAG_ERROR, TAG_BYTES, TAG_STREAM) \
            else (TAG_DATA, payload)

    def close(self, unlink: bool = False) -> None:
        self.poison()
        host = _host_singleton[0]
        if host is not None:
            host.unregister(self.ring_id)


class NetRingHost:
    """Per-process listener the reading side of every net ring shares.

    One authenticated TCP listener per process; writers dial it, name a
    ring id in their hello, and the per-connection serve thread becomes
    that ring's delivery thread.  The listener key is minted per process
    and travels only inside already-authenticated actor-call payloads
    (the compile-time handshake), so ring sessions inherit the cluster's
    trust boundary without a shared global key."""

    def __init__(self, advertise_ip: str = "127.0.0.1"):
        from multiprocessing import connection as mpc

        self.authkey = os.urandom(24)
        self._listener = mpc.Listener(address=("0.0.0.0", 0),
                                      family="AF_INET", authkey=self.authkey)
        _bound_host, self.port = self._listener.address
        self.advertise_ip = advertise_ip or "127.0.0.1"
        self._rings: Dict[str, NetRingReader] = {}
        self._lock = threading.Lock()
        self._alive = True
        self._conns: set = set()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="nring-host-accept")
        self._accept_thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        """Dial-in computed at READ time: the advertise ip can be
        corrected after the host started (a worker learns its real
        node ip via a control message that may land after the first
        ring was created — a host pinned to the init-default loopback
        would hand unroutable addresses to remote writers forever)."""
        return (self.advertise_ip, self.port)

    # ---- registry ----

    def register(self, reader: NetRingReader) -> None:
        with self._lock:
            self._rings[reader.ring_id] = reader

    def unregister(self, ring_id: str) -> None:
        with self._lock:
            self._rings.pop(ring_id, None)

    def get(self, ring_id: str) -> Optional[NetRingReader]:
        with self._lock:
            return self._rings.get(ring_id)

    def poison_prefix(self, prefix: str) -> int:
        """Poison every registered reader whose ring id starts with
        ``prefix`` (a compiled DAG's uid): the death path for stages
        downstream of a dead peer — their parked reads pop with
        ChannelClosed instead of waiting on a corpse."""
        with self._lock:
            victims = [rd for rid, rd in self._rings.items()
                       if rid.startswith(prefix)]
        for rd in victims:
            rd.poison()
        return len(victims)

    # ---- serving ----

    def _accept_loop(self) -> None:
        while self._alive:
            try:
                conn = self._listener.accept()
            except Exception:
                if not self._alive:
                    return
                continue
            if not self._alive:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            from .object_transfer import _tune_conn

            _tune_conn(conn)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="nring-host-serve").start()

    def _serve(self, conn) -> None:
        """Per-session delivery thread: hello, then every received
        message is applied to the ring's reader; the reader's acks ride
        the same duplex connection."""
        reader = None
        my_send = None
        try:
            hello = conn.recv()
            op = hello[0] if isinstance(hello, tuple) and hello else None
            if op == "nring":
                reader = self.get(hello[1])
            if reader is None:
                return  # bad hello / unknown ring: writer re-dials
            my_send = _LockedSend(conn)
            reader.attach_send(my_send)
            # a reader awaiting resync asks on every session attach
            # (at-least-once; stale extra nrrq answers are idempotent)
            reader.start_resync()
            while self._alive:
                msg = conn.recv()
                if (isinstance(msg, tuple) and msg
                        and msg[0] == "nrdv"):
                    # writev'd data: the header frame names the body
                    # length; the next frame on this connection IS the
                    # raw body (the sender holds its lock across the
                    # pair, so no frame interleaves). Reassembled into
                    # the canonical "nrd" before the state machine.
                    body = conn.recv_bytes()
                    msg = ("nrd", msg[1], msg[2], body)
                reader.on_message(msg, reply=my_send)
        except (EOFError, OSError, TypeError, ValueError):
            pass  # session over: writer re-dials and retransmits
        finally:
            if reader is not None:
                with reader._lock:
                    # only clear OUR session: a reconnected writer may
                    # already have attached a fresh sender
                    if reader._send is my_send:
                        reader._send = None
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._alive = False
        from .protocol import close_listener

        close_listener(self._listener)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
            rings = list(self._rings.values())
            self._rings.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        for rd in rings:
            rd.poison()
        self._accept_thread.join(timeout=2.0)


# Process-wide host: every reading endpoint in a process shares one
# listener; the compiled-graph setup RPC returns (address, key) so the
# writing processes can dial it.
_host_singleton: list = [None]
_host_lock = threading.Lock()


def ensure_host(advertise_ip: Optional[str] = None) -> NetRingHost:
    host = _host_singleton[0]
    if host is None or not host._alive:
        with _host_lock:
            host = _host_singleton[0]
            if host is None or not host._alive:
                host = NetRingHost(advertise_ip or "127.0.0.1")
                _host_singleton[0] = host
    # callers pass the CURRENT node ip: adopt a late-arriving real
    # address over the loopback default (never the reverse)
    if advertise_ip and advertise_ip != "127.0.0.1":
        host.advertise_ip = advertise_ip
    return host


def create_reader(ring_id: str, n_slots: int, capacity: int,
                  advertise_ip: Optional[str] = None,
                  resync: bool = False) -> NetRingReader:
    """Create + register the reading end of a ring in this process;
    returns the reader. The host's (address, authkey) — what a writer
    needs to dial in — comes from :func:`ensure_host`."""
    host = ensure_host(advertise_ip)
    reader = NetRingReader(ring_id, n_slots, capacity, resync=resync)
    host.register(reader)
    return reader


def poison_rings(prefix: str) -> int:
    """Poison this process's net-ring readers under a DAG uid (driver
    death-path broadcast; no-op when the process hosts none)."""
    host = _host_singleton[0]
    if host is None:
        return 0
    return host.poison_prefix(prefix)

"""Worker <-> node wire protocol.

Analog of the reference's gRPC ``CoreWorkerService``/``NodeManagerService``
split, collapsed for a single-machine node: each worker process holds one
authenticated unix-socket connection to its node (``multiprocessing.connection``
framing, pickle payloads). Messages are tagged tuples; both ends run a reader
thread and dispatch by tag, so calls in both directions interleave freely
(needed for async actors and nested task submission — reference:
core_worker.proto:439 direct worker push).

Tags (worker -> node):
    register(worker_id, pid)        -- handshake
    done(task_id, results, err)     -- task finished; results inline or sealed
    store(req_id, op, *args)        -- blocking store ops (get/create/seal/..)
    rpc(req_id, op, *args)          -- control-plane ops (submit, actors, kv)

Tags (node -> worker):
    exec(task_payload)              -- run a task
    cancel(task_id)
    rep(req_id, ok, value)          -- reply to store/rpc
    shutdown()
"""

from __future__ import annotations

import itertools
import threading
from multiprocessing import connection as mpc
from typing import Any, Callable, Dict, Optional, Tuple

from .fault_injection import should_drop as _fault_should_drop


# Wire protocol version, carried in every welcome handshake (node daemon
# join, client-driver connect). Bump on any incompatible change to message
# tags/payload shapes — mixed-version clusters fail fast with a clear
# error instead of unpickling garbage (the pickle-schema analog of the
# reference's versioned protobuf wire format, src/ray/protobuf/).
PROTOCOL_VERSION = 13  # v13: the PyTorch runtime's own wire-op set.
# Its compiled-dispatch, device-edge and ring ops differ from the JAX
# runtime's at v12, so the number names this package's op set (the two
# runtimes never join one cluster).
# (v12: cluster stack dump. ADDED the "stack"
# request (head -> worker/daemon: one bounded sampling-profiler round,
# duration_ms) and its one-way "stack_rep" reply (collapsed-stack text
# per process) behind `python -m ray_tpu stack` / GET /api/stacks.
# (v11: flight-recorder span plane. ADDED the
# one-way "spans" tag (worker/daemon -> head: drained flight-recorder
# ring payloads for the cluster timeline, util/flight_recorder.py) and
# EXTENDED the health-prober pong payload to (seq, wall_time) so the
# head can estimate per-host clock offsets (min-RTT midpoint) when
# merging traces.)
# (v10: zero-copy net-ring tensor bodies. ADDED
# "nrdv" (data-with-raw-body: header (nrdv, seq, tag, nbytes) followed
# by one raw mpc frame carrying the writev'd segment body; the serve
# loop reassembles the canonical "nrd" before the protocol state
# machine — see core/net_ring.py _net_send/send_segments).
# (v9: cross-host compiled-graph rings. ADDED the
# NetRing session ops (core/net_ring.py, the machine-checked
# ring-protocol-net transport): "nring" (writer hello naming a ring id),
# "nrd" (data: seq + tag + payload), "nra" (cumulative ack), "nrrq"
# (reader resync request), "nrbase" (resync reply carrying the writer's
# acked base).
# (v8: restartable head — daemon rejoin. ADDED
# head->daemon "reregister" (stale-epoch kick); the "hello" payload may
# carry {"rejoin": node_hex} (daemon re-registering after a head bounce
# keeps its hex), "welcome" carries the head epoch, "node_ready" may
# carry a replay snapshot (store manifest + holder leases + hosted
# actors), and syncer snapshots echo the epoch.
# v7: head-free actor plane — owner-side ref accounting and stream
# publication; DELETED head hot-path ops dpin/pin_delta/is_pinned/
# dspub/dseof/stream_pub_item/stream_pub_eof, ADDED stream_sub/ssub/
# srep/psub/psubrep. v6: dropped dead worker->node "release" tag.
# v5: memory observability — "refs" reports + store_info/store_info_rep.
# v4: pooled object transfer, stat/pullr. v3: ddone/pdone exec_hex)


class ProtocolVersionError(ConnectionError):
    def __init__(self, theirs, ours=PROTOCOL_VERSION):
        super().__init__(
            f"wire protocol mismatch: peer speaks v{theirs}, this process "
            f"speaks v{ours}; upgrade both sides to the same ray_tpu_torch")


def check_protocol(welcome: dict) -> None:
    theirs = welcome.get("proto", 0)
    if theirs != PROTOCOL_VERSION:
        raise ProtocolVersionError(theirs)


class Channel:
    """Thread-safe duplex message channel over a multiprocessing Connection."""

    def __init__(self, conn):
        self.conn = conn
        self._send_lock = threading.Lock()
        self.closed = False

    def send(self, tag: str, *payload) -> None:
        # chaos harness: "wire.send.<tag>=drop@N" silently loses this
        # message, "...=delay:MS" stalls it (fault_injection.py); the
        # fast path when no spec is armed is one string compare
        if _fault_should_drop("wire.send", tag):
            return
        with self._send_lock:
            self.conn.send((tag, payload))

    def recv(self) -> Tuple[str, tuple]:
        return self.conn.recv()

    def close(self) -> None:
        self.closed = True
        # socket shutdown BEFORE close: a thread parked in recv(2) on
        # this connection is not interrupted by closing the fd (it would
        # sit there until the peer sends) — shutdown pops it with EOF
        # immediately, so reader threads can be joined at teardown
        try:
            import os as _os
            import socket as _socket

            s = _socket.socket(fileno=_os.dup(self.conn.fileno()))
            try:
                s.shutdown(_socket.SHUT_RDWR)
            finally:
                s.close()
        except (OSError, ValueError, AttributeError):
            pass  # not socket-backed / already closed
        try:
            self.conn.close()
        except OSError:
            pass


class RpcClient:
    """Request/reply layer over a Channel (used by workers toward the node)."""

    def __init__(self, channel: Channel):
        self.channel = channel
        self._counter = itertools.count()
        self._pending: Dict[int, "Future"] = {}
        self._lock = threading.Lock()

    def call(self, tag: str, op: str, *args, timeout: Optional[float] = None) -> Any:
        req_id = next(self._counter)
        fut = Future()
        with self._lock:
            self._pending[req_id] = fut
        self.channel.send(tag, req_id, op, *args)
        return fut.result(timeout)

    def handle_reply(self, req_id: int, ok: bool, value: Any) -> None:
        with self._lock:
            fut = self._pending.pop(req_id, None)
        if fut is None:
            return
        if ok:
            fut.set_result(value)
        else:
            fut.set_exception(value)

    def fail_all(self, exc: Exception) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut.set_exception(exc)


class Future:
    __slots__ = ("_event", "_value", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc = None

    def set_result(self, v):
        self._value = v
        self._event.set()

    def set_exception(self, e):
        self._exc = e
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("rpc timeout")
        if self._exc is not None:
            raise self._exc
        return self._value


def make_listener(address, authkey: bytes) -> mpc.Listener:
    """Listener over a unix socket (str path) or TCP ((host, port) tuple).

    TCP is the multi-host transport — the analog of the reference's gRPC
    server sockets (src/ray/rpc/grpc_server.h); auth uses the
    multiprocessing HMAC challenge with the cluster key.
    """
    # backlog: mpc's default of 1 drops concurrent connects (prestarted
    # workers racing the accept-side handshake got ECONNREFUSED and died)
    if isinstance(address, str):
        return mpc.Listener(address=address, family="AF_UNIX",
                            backlog=64, authkey=authkey)
    return mpc.Listener(address=tuple(address), family="AF_INET",
                        backlog=64, authkey=authkey)


def close_listener(listener) -> None:
    """Close a Listener AND wake any thread parked in ``accept()``.

    A plain ``close()`` frees the fd but leaves a thread blocked in
    accept(2) parked forever (Linux does not interrupt the syscall), so
    a teardown path that joins its accept loop would wait out the full
    join timeout.  ``shutdown(SHUT_RDWR)`` on the listening socket pops
    accept with an error immediately (verified for AF_UNIX and
    AF_INET)."""
    import socket as _socket

    try:
        listener._listener._socket.shutdown(_socket.SHUT_RDWR)
    except (OSError, AttributeError):
        pass
    try:
        listener.close()
    except OSError:
        pass


def set_nodelay(conn) -> None:
    """Disable Nagle on a TCP multiprocessing Connection. The control
    planes exchange small request/reply messages; Nagle + delayed ACK
    adds tens of ms per round trip (measured: daemon-hosted actor calls
    at 81/s vs 2.5k/s over unix sockets before this)."""
    import socket

    try:
        s = socket.fromfd(conn.fileno(), socket.AF_INET,
                          socket.SOCK_STREAM)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.close()  # fromfd dup'd the fd; the option sticks to the socket
    except OSError:
        pass


def connect(address, authkey: bytes) -> Channel:
    if isinstance(address, str):
        return Channel(mpc.Client(address=address, family="AF_UNIX",
                                  authkey=authkey))
    conn = mpc.Client(address=tuple(address), family="AF_INET",
                      authkey=authkey)
    set_nodelay(conn)
    return Channel(conn)


def infer_node_ip(peer_host: str = "8.8.8.8") -> str:
    """IP of the local interface the kernel would route to ``peer_host``
    (reference: ``services.get_node_ip_address``). The UDP connect never
    sends a packet — it only selects the egress interface. Pass the head's
    host to get the address peers on that network can reach."""
    import socket

    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((peer_host, 80))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def parse_address(addr: str):
    """"host:port" -> (host, port); anything else is a unix-socket path."""
    if ":" in addr and not addr.startswith("/"):
        host, _, port = addr.rpartition(":")
        return (host, int(port))
    return addr

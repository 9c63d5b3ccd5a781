"""Standalone node daemon: joins a head over TCP from another OS process/host.

The multi-host split the reference gets from separate raylet processes
(src/ray/raylet/main.cc:123): ``python -m ray_tpu_torch.core.node_daemon
--address <head_host:port> --key <hex>`` runs a full Node (worker pool +
shm arena + object server) in its own process. The Node's upcalls into the
"head" go through ``RemoteHead``, which forwards them over the registration
channel; object payloads never traverse it — they move via direct chunked
node-to-node pulls (object_transfer.py).

Registration handshake (head side: runtime.py Head._register_daemon):
    daemon -> ("hello", {})
    head   -> ("welcome", {node_hex, job_id, config})   # head config adopted
    daemon -> ("node_ready", {resources, labels, object_addr, pid})
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import threading
import time
from typing import Optional

from .config import Config, global_config, set_global_config
from .exceptions import ObjectLostError
from .ids import JobID, NodeID, ObjectID
from .protocol import Channel, RpcClient, connect, parse_address


# daemon->head messages that MUST NOT be lost across a head bounce: they
# carry state the head can't re-derive (results, seals, death reports,
# batched direct events). Buffered while the link is down and replayed in
# order after re-registration. Telemetry (sync/metrics/logs/pongs) and
# refs reports re-arrive on their own cadence and are droppable.
_RELIABLE_TAGS = frozenset({
    "task_finished", "sealed", "sealed_payload", "stream_item",
    "worker_exit", "worker_crashed", "dispatch_worker_failed",
    "devents", "cevents", "pub1",
})
_OUTBOX_MAX = 10_000


class RemoteHead:
    """Daemon-side proxy implementing the Head interface a Node calls.

    Survives a head bounce: on link EOF (or an explicit ``reregister``
    from a restarted head that spotted our stale epoch) the reader
    re-dials the head address, re-registers under the SAME node hex with
    a replay snapshot (store manifest + holder leases + hosted actors —
    Node.replay_snapshot), and flushes the reliable-message outbox, so
    the restarted head converges to the pre-crash view without any
    daemon-resident state having moved."""

    def __init__(self, channel: Channel, welcome: dict, cluster_key: bytes,
                 address=None):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self.channel = channel
        self.rpc = RpcClient(channel)
        self.job_id = JobID(welcome["job_id"])
        self.node_hex: str = welcome["node_hex"]
        self.cluster_key = cluster_key
        self.address = address  # head endpoint, re-dialed after a bounce
        self.epoch = welcome.get("epoch", 1)  # head incarnation
        # the node_ready payload, retained so re-registration can resend
        # it (main() fills it in before the first send)
        self.ready_payload: dict = {}
        self._outbox: "deque" = deque(maxlen=_OUTBOX_MAX)
        self._outbox_lock = threading.Lock()
        self._closing = False
        # no head-backed pin view: store eviction/delete protection on a
        # daemon is the node-local holder lease (Node._arg_leases) — the
        # old per-object is_pinned head RPC is gone from the wire
        self.ref_counts = None
        self.node = None  # set after Node construction
        self.stopped = threading.Event()
        # fetch_local prefetch kicks (timeout=0 waits): one in-flight
        # background pull per object across concurrent waits
        self._prefetching: set = set()
        self._prefetch_lock = threading.Lock()
        self.cluster_view: list = []          # syncer-broadcast membership
        self.cluster_view_version: int = 0
        # handlers can block on node/store locks (e.g. store_delete vs a
        # reclaim holding the store lock mid pin-check RPC): run them off
        # the read loop so "rep" delivery is never queued behind them.
        # dispatch-family messages keep a dedicated single thread so actor
        # task ordering (send order to the worker channel) is preserved.
        self._ordered_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="head-dispatch")
        self._handler_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="head-msg")
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="head-link")
        self._reader.start()

    def close(self) -> None:
        """Daemon teardown: drop the head link and reap the handler
        machinery (reader exits on channel EOF / the shutdown tag)."""
        self._closing = True
        try:
            self.channel.close()
        except Exception:
            pass
        self._ordered_pool.shutdown(wait=False)
        self._handler_pool.shutdown(wait=False)
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=2.0)

    # ------------------------------------------------------------ channel

    def _send(self, tag: str, *payload) -> None:
        try:
            if self._outbox:
                # opportunistic drain BEFORE this message (keeps order):
                # covers stragglers that failed into the outbox after
                # _reconnect's bounded flush — without this, a seal
                # parked in that window would wait for the NEXT
                # disconnect to ever be delivered
                with self._outbox_lock:
                    while self._outbox:
                        t, p = self._outbox[0]
                        # deliberate: the lock exists precisely to
                        # serialize outbox drains (peek-send-pop must
                        # not interleave across threads or messages
                        # deliver twice); nothing else is taken under it
                        # graftlint: ignore[blocking-under-lock]
                        self.channel.send(t, *p)
                        self._outbox.popleft()
            self.channel.send(tag, *payload)
        except (OSError, EOFError, ValueError):
            # link down (head bouncing, or gone for good): reliable
            # messages park in the outbox and replay after rejoin; the
            # reader thread owns reconnection and final-death decisions
            if tag in _RELIABLE_TAGS and not self._closing:
                self._outbox.append((tag, payload))

    def _read_loop(self) -> None:
        while True:
            try:
                tag, payload = self.channel.recv()
            except (EOFError, OSError):
                self.rpc.fail_all(ConnectionError("head link lost"))
                if self._closing or self.stopped.is_set():
                    self.stopped.set()
                    return
                # head bounce? re-dial and re-register under the same
                # node hex; only a timed-out reconnect kills the daemon
                if self.address is None or not self._reconnect():
                    self.stopped.set()
                    return
                continue
            if tag == "rep":
                self.rpc.handle_reply(*payload)
            elif tag == "shutdown":
                self._closing = True
                self.stopped.set()
                return
            elif tag == "reregister":
                # the head restarted and spotted our stale epoch on the
                # syncer: drop this link; the EOF path re-registers
                self.rpc.fail_all(ConnectionError("head restarted"))
                try:
                    self.channel.close()
                except Exception:
                    pass
                if self.address is None or not self._reconnect():
                    self.stopped.set()
                    return
            elif tag in ("dispatch", "dispatch_worker", "cancel",
                         "kill_worker"):
                self._ordered_pool.submit(self._handle, tag, payload)
            else:
                self._handler_pool.submit(self._handle, tag, payload)

    def _reconnect(self) -> bool:
        """Re-dial the bounced head and re-register (same node hex, full
        replay snapshot), then flush the reliable outbox. Runs on the
        reader thread; other threads' sends keep failing into the outbox
        until the swapped-in channel is live."""
        from .config import global_config
        from .protocol import check_protocol, connect

        deadline = time.monotonic() + global_config().head_rejoin_timeout_s
        while time.monotonic() < deadline and not self._closing:
            try:
                ch = connect(self.address, self.cluster_key)
            except Exception:
                time.sleep(0.3)
                continue
            try:
                ch.send("hello", {"rejoin": self.node_hex})
                tag, (welcome,) = ch.recv()
                assert tag == "welcome", tag
                check_protocol(welcome)
                if welcome["node_hex"] != self.node_hex:
                    raise ConnectionError("head did not honor rejoin hex")
                ready = dict(self.ready_payload)
                ready["replay"] = (self.node.replay_snapshot()
                                   if self.node is not None else {})
                ch.send("node_ready", ready)
                # replay reliable messages IN ORDER before the swap so
                # buffered results precede anything sent afterwards.
                # Peek-send-pop: a send failure mid-flush leaves the
                # message AT THE FRONT for the next reconnect attempt
                # (pop-first would silently drop it — the exact lost-seal
                # bug the outbox exists to prevent)
                with self._outbox_lock:
                    while self._outbox:
                        t, p = self._outbox[0]
                        ch.send(t, *p)
                        self._outbox.popleft()
                self.epoch = welcome.get("epoch", self.epoch + 1)
                self.channel = ch
                self.rpc.channel = ch
                # stragglers that failed into the outbox between the
                # flush and the swap drain on the next healthy _send
                # (opportunistic pre-send drain) — nothing is stranded
                # until "the next disconnect"
                from ray_tpu_torch.util import events as events_mod

                events_mod.emit(
                    "INFO", events_mod.SOURCE_NODE,
                    f"re-registered with restarted head "
                    f"(epoch {self.epoch})", entity_id=self.node_hex)
                return True
            except Exception:
                try:
                    ch.close()
                except Exception:
                    pass
                time.sleep(0.3)
        return False

    def _handle(self, tag: str, payload) -> None:
        try:
            if tag == "dispatch":
                self.node.dispatch(pickle.loads(payload[0]), payload[1])
            elif tag == "dispatch_worker":
                wid, spec_b = payload
                spec = pickle.loads(spec_b)
                if not self.node.dispatch_to_worker(wid, spec):
                    self._send("dispatch_worker_failed", spec.task_id,
                               spec.actor_id)
            elif tag == "kill_worker":
                self.node.kill_worker(payload[0])
            elif tag == "cancel":
                self.node.cancel_task(*payload)
            elif tag == "store_delete":
                # honors in-flight holder leases (deferred until release)
                self.node.delete_from_store(payload[0])
            elif tag == "push_object":
                # broadcast-tree root op from the head
                oid, targets = payload
                threading.Thread(
                    target=self.node.push_object_to, args=(oid, targets),
                    daemon=True, name="bcast-root").start()
            elif tag == "store_info":
                # head asks for this node's store dump (memory_table):
                # bounded, read-only, replied one-way
                self._send("store_info_rep", payload[0],
                           self.node.store.object_infos())
            elif tag == "ping":
                # health probe (reference: gcs_health_check_manager.h) —
                # answered from the handler pool, so a wedged daemon
                # genuinely misses probes
                # the wall-clock echo feeds the head's min-RTT clock
                # offset estimator (flight-recorder trace merge); old
                # heads ignore the extra element
                self._send("pong", payload[0], time.time())
            elif tag == "stack_dump":
                # cluster stack dump: sampling blocks for duration_ms,
                # so it runs off the handler — pings must keep flowing
                # while this daemon profiles itself and its workers
                threading.Thread(
                    target=self._stack_dump, args=(payload[0], payload[1]),
                    daemon=True, name="stack-dump").start()
            elif tag == "cluster_view":
                # syncer broadcast (reference: RaySyncer RESOURCE_VIEW
                # fan-out); versioned — drop stale reorderings
                version, view = payload
                if version > self.cluster_view_version:
                    self.cluster_view_version = version
                    self.cluster_view = view
        except Exception:
            pass  # node dying; the head recovers via channel EOF

    def _stack_dump(self, req_id: int, duration_ms: int) -> None:
        """Sample this daemon + its workers, reply one-way. Best-effort:
        a missing reply just leaves this node absent from the dump (the
        head's collector has its own deadline)."""
        from ray_tpu_torch.util import sampling_profiler

        stacks: dict = {}
        try:
            dur = max(0.0, duration_ms / 1000.0)
            stacks[f"{self.node.hex[:6]}:daemon"] = \
                sampling_profiler.collect_stacks(dur)
            stacks.update(self.node.collect_worker_stacks(dur))
        except Exception:
            pass  # partial dump beats none; reply what we have
        try:
            self._send("stack_rep", req_id, stacks)
        except Exception:
            pass  # node dying; the head's deadline covers it

    # ------------------------------------------- Head API consumed by Node

    def on_task_finished(self, node, task_id, err_name, spec, binding,
                         results, worker_id=None, attempt=None) -> None:
        self._send("task_finished", task_id, err_name,
                   pickle.dumps(spec) if spec is not None else None,
                   binding, results, worker_id, attempt)

    def on_object_sealed(self, oid: ObjectID, node_hex: str) -> None:
        self._send("sealed", oid)

    def publish_direct_events(self, node_hex: str, events) -> None:
        self._send("devents", events)

    def on_sealed_payload(self, oid: ObjectID, payload: bytes,
                          is_error: bool) -> None:
        self._send("sealed_payload", oid, payload, is_error)

    def on_stream_item(self, task_id, index: int) -> None:
        self._send("stream_item", task_id, index)

    def publish_oneway(self, channel: str, message) -> None:
        self._send("pub1", channel, message)

    def on_worker_metrics(self, source_id: str, snapshot: dict) -> None:
        self._send("worker_metrics", source_id, snapshot)

    def on_worker_spans(self, source_id: str, payload: dict) -> None:
        self._send("spans", source_id, payload)

    def record_cluster_events(self, events: list) -> None:
        self._send("cevents", events)

    def on_ref_report(self, source_id: str, table: dict) -> None:
        self._send("refs", source_id, table)

    def on_worker_log(self, node_hex: str, pid: int, text: str) -> None:
        self._send("worker_log", node_hex, pid, text)

    def on_worker_exit(self, node, w) -> None:
        self._send("worker_exit", w.worker_id, w.actor_id, w.pid)

    def on_worker_crashed(self, node, w, spec, binding, prev_state) -> None:
        self._send("worker_crashed", w.worker_id, w.actor_id, w.pid,
                   pickle.dumps(spec) if spec is not None else None,
                   binding, prev_state)

    def _bounded_rounds(self, make_req, done, timeout):
        """Re-issue a head request in <=2s rounds until ``done(result)`` or
        the deadline passes. An unbounded blocking request would pin one of
        the head's 16 daemon-request threads (pool starvation/deadlock)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            round_t = (2.0 if remaining is None
                       else max(0.0, min(remaining, 2.0)))
            result = self.rpc.call("req", *make_req(round_t),
                                   timeout=round_t + 30.0)
            if done(result) or (remaining is not None
                                and remaining <= round_t):
                return result

    def handle_worker_rpc(self, node, w, op: str, args):
        if op == "stream_next":
            task_id, index, timeout = args
            return self._bounded_rounds(
                lambda t: ("worker_rpc", ("stream_next", [task_id, index, t])),
                lambda rep: rep[0] != "wait", timeout)
        if op == "pg_ready":
            pg_id, timeout = args
            return self._bounded_rounds(
                lambda t: ("worker_rpc", ("pg_ready", [pg_id, t])),
                bool, timeout)
        return self.rpc.call("req", "worker_rpc", (op, list(args)))

    def wait_objects(self, oids, num_returns, timeout, fetch_local=False):
        if not fetch_local:
            return self._bounded_rounds(
                lambda t: ("wait_objects", (oids, num_returns, t)),
                lambda ready: len(ready) >= num_returns, timeout)
        # fetch_local on a daemon: ready = in THIS node's store; the wait
        # pulls cluster-available objects down as they appear. Small
        # objects arrive INLINE (never stored by the pull path), so track
        # them in a fetched set — store.contains alone would re-pull them
        # forever.
        deadline = None if timeout is None else time.monotonic() + timeout
        node = self.node
        fetched: set = set()
        while True:
            ready = [o for o in oids
                     if o in fetched or node.store.contains(o)]
            if len(ready) >= num_returns:
                return ready[:num_returns]
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                # budget exhausted: kick one ASYNC pull round for the
                # stragglers so a timeout=0 fetch_local wait still
                # STARTS transfers (the head-side wait spawns pulls the
                # same way; iterator prefetch relies on the side effect)
                self._spawn_prefetch([o for o in oids if o not in ready])
                return ready
            round_t = (2.0 if remaining is None
                       else max(0.05, min(remaining, 2.0)))
            missing = [o for o in oids if o not in ready]
            avail = self.rpc.call(
                "req", "wait_objects", (missing, len(missing), round_t),
                timeout=round_t + 30.0)
            for oid in avail:
                if node.store.contains(oid):
                    continue
                # bounded pull; failures re-locate on the next round
                rep = self.get_object_for_node(node, oid, round_t)
                if rep[0] == "inline":
                    try:
                        node.store.put_inline(oid, rep[1], rep[2],
                                              transfer=True)
                    except Exception:
                        pass
                    fetched.add(oid)
                elif rep[0] == "arena":
                    fetched.add(oid)

    def _spawn_prefetch(self, oids) -> None:
        """Background locate+pull for a timeout=0 fetch_local wait —
        readiness was already answered; this only starts the transfers.
        One thread PER object (the window is small — prefetch_batches+1
        refs): a ref whose producing task hasn't finished must not
        head-of-line-block transfer of the refs behind it, and the
        cross-wait dedup below would otherwise pin the whole batch
        behind the straggler. Each thread gives its object a bounded
        locate budget, then clears its dedup entry so a later wait
        re-kicks it; failures are silent (the consumer's real get()
        re-locates)."""
        node = self.node
        if node is None or not oids:
            return
        with self._prefetch_lock:
            todo = [o for o in oids if o not in self._prefetching
                    and not node.store.contains(o)]
            self._prefetching.update(todo)

        def run(oid):
            try:
                if not node.store.contains(oid):
                    rep = self.get_object_for_node(node, oid, 5.0)
                    if rep and rep[0] == "inline":
                        node.store.put_inline(oid, rep[1], rep[2],
                                              transfer=True)
            except Exception:
                pass
            finally:
                with self._prefetch_lock:
                    self._prefetching.discard(oid)

        for oid in todo:
            threading.Thread(target=run, args=(oid,), daemon=True,
                             name="prefetch-pull").start()

    def get_object_for_node(self, node, oid: ObjectID, timeout,
                            hint: Optional[str] = None):
        """Local-store check, then head locate + direct pull from the source
        node's object server (reference: pull_manager.h chunked pull).

        ``hint`` (direct-path owner hint) short-circuits the head locate
        entirely: the daemon pulls straight from the hinted peer's object
        server found in the syncer-broadcast cluster view."""
        from .object_transfer import pull_object, pull_object_striped

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if node.store.contains(oid):
                info = node.store.entry_info(oid)
                if info is None:
                    payload, is_err = node.store.get_payload(oid)
                    return ("inline", bytes(payload), is_err)
                off, size, is_err = info
                return ("arena", off, size, is_err)
            if hint and hint != node.hex:
                addr = next((tuple(e["addr"]) for e in self.cluster_view
                             if e.get("hex") == hint and e.get("addr")),
                            None)
                hint = None  # one shot: failure falls to the locate loop
                if addr is not None:
                    res = pull_object(addr, self.cluster_key, oid,
                                      dest_store=node.store)
                    if res is not None:
                        body, is_err = res
                        if isinstance(body, tuple):
                            _, off, size = body
                            self.on_object_sealed(oid, node.hex)
                            return ("arena", off, size, is_err)
                        return ("inline", body, is_err)
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return ("timeout",)
            round_t = 2.0 if remaining is None else max(0.05, min(remaining, 2.0))
            try:
                rep = self.rpc.call("req", "locate", (oid, round_t),
                                    timeout=round_t + 30.0)
            except Exception:
                if self.stopped.is_set():
                    raise ObjectLostError(oid, "head link lost")
                continue
            if rep[0] == "inline":
                return ("inline", rep[1], rep[2])
            if rep[0] == "locs":
                if len(rep[1]) >= 2:
                    # multi-holder: striped parallel pull with per-stripe
                    # failover (falls back to serial pulls internally, so
                    # a None covers every holder). Peers that failed —
                    # even when failover succeeded — get their stale
                    # locations dropped so locate stops handing them out.
                    addr_to_hex = {tuple(a): h for h, a in rep[1]}
                    failed: list = []
                    res = pull_object_striped(
                        [addr for _h, addr in rep[1]], self.cluster_key,
                        oid, node.store, on_peer_failed=failed.append)
                    for a in failed:
                        src_hex = addr_to_hex.get(tuple(a))
                        if src_hex is None:
                            continue
                        try:
                            self.rpc.call("req", "drop_location",
                                          (oid, src_hex), timeout=10.0)
                        except Exception:
                            pass
                    if res is not None:
                        body, is_err = res
                        if isinstance(body, tuple):
                            _, off, size = body
                            self.on_object_sealed(oid, node.hex)
                            return ("arena", off, size, is_err)
                        return ("inline", body, is_err)
                    time.sleep(0.05)  # all holders failed: re-locate
                    continue
                all_stale = True
                for src_hex, addr in rep[1]:
                    res = pull_object(addr, self.cluster_key, oid,
                                      dest_store=node.store)
                    if res is None:
                        # evicted/source died: invalidate so locate doesn't
                        # return the same stale address forever
                        try:
                            self.rpc.call("req", "drop_location",
                                          (oid, src_hex), timeout=10.0)
                        except Exception:
                            pass
                        continue
                    all_stale = False
                    body, is_err = res
                    if isinstance(body, tuple):
                        _, off, size = body
                        self.on_object_sealed(oid, node.hex)
                        return ("arena", off, size, is_err)
                    return ("inline", body, is_err)
                if all_stale:
                    time.sleep(0.05)  # let reconstruction/retry make progress
            # timeout / stale locations: loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ray_tpu_torch node daemon",
        description="Join a ray_tpu_torch head as a separate-process node")
    ap.add_argument("--address", required=True, help="head host:port")
    ap.add_argument("--key", required=True, help="cluster auth key (hex)")
    ap.add_argument("--num-cpus", type=float, default=None)
    ap.add_argument("--num-tpus", type=float, default=None)
    ap.add_argument("--resources", default="{}", help="JSON resource dict")
    ap.add_argument("--labels", default="{}", help="JSON label dict")
    ap.add_argument("--session-dir", default=None)
    ap.add_argument("--node-ip", default=None,
                    help="routable IP to advertise for this node (default: "
                    "RAY_TPU_NODE_IP env, else the interface that reaches "
                    "the head)")
    args = ap.parse_args(argv)

    from .accelerators import detect_resources

    key = bytes.fromhex(args.key)
    resources = detect_resources(
        num_cpus=int(args.num_cpus) if args.num_cpus is not None else None,
        num_tpus=int(args.num_tpus) if args.num_tpus is not None else None,
        extra=json.loads(args.resources))
    labels = json.loads(args.labels)

    channel = connect(parse_address(args.address), key)
    channel.send("hello", {})
    tag, (welcome,) = channel.recv()
    assert tag == "welcome", tag
    from .protocol import check_protocol

    check_protocol(welcome)
    # adopt the head's config so scheduler/store thresholds agree cluster-wide
    set_global_config(Config.from_json(welcome["config"]))

    head = RemoteHead(channel, welcome, key,
                      address=parse_address(args.address))
    # this process's cluster events flush over the head link (one-way)
    from ray_tpu_torch.util import events as events_mod

    cfg = global_config()
    events_mod.set_sink(head.record_cluster_events,
                        cfg.cluster_event_flush_ms / 1000.0)
    session_dir = args.session_dir or tempfile.mkdtemp(prefix="raytorch_node_")

    node_ip = args.node_ip or os.environ.get("RAY_TPU_NODE_IP")
    if not node_ip:
        from .protocol import infer_node_ip

        node_ip = infer_node_ip(parse_address(args.address)[0])

    from .node import Node

    node = Node(head, NodeID(bytes.fromhex(welcome["node_hex"])), resources,
                session_dir, labels, node_ip=node_ip)
    head.node = node
    server = node.start_object_server(key)
    # the per-node dashboard agent (ray_tpu/core/node_daemon.py:633) is
    # not ported (ROADMAP.md, queue 1, item 5.7): the node advertises no
    # agent address, which the head accepts (runtime.py, agent_addr).
    # The payload is retained on the proxy: re-registration after a head bounce resends
    # this payload (plus a replay snapshot) under the same node hex
    head.ready_payload = {
        "resources": resources,
        "labels": labels,
        "object_addr": list(server.address),
        "pid": os.getpid(),
        "agent_addr": None,
    }
    channel.send("node_ready", head.ready_payload)
    from .syncer import NodeSyncer

    syncer = NodeSyncer(head, node)
    # this daemon's own flight-recorder spans (net-ring waits run here)
    # drain to the head on the report cadence, one-way and droppable
    from ray_tpu_torch.util import flight_recorder as _fr

    _fr.adopt_config(cfg)
    _fr.set_process_label("daemon")
    _fr.set_dump_dir(session_dir)
    if _fr.enabled():
        def _span_report_loop():
            period = max(0.25,
                         cfg.flight_recorder_report_interval_ms / 1000.0)
            src = f"{node.hex[:6]}:daemon"
            while not head.stopped.is_set():
                time.sleep(period)
                try:
                    pl = _fr.drain()
                    if pl is not None:
                        head.on_worker_spans(
                            src, dict(pl, node_hex=node.hex))
                except Exception:
                    pass

        threading.Thread(target=_span_report_loop, daemon=True,
                         name="flightrec-report").start()
    if cfg.device_telemetry_enabled:
        # the port's compile events come from ops/_build.py and the
        # program observatory: there is no import hook to install
        from ray_tpu_torch.util.device_telemetry import start_device_telemetry

        start_device_telemetry(node_hex=node.hex)
    try:
        head.stopped.wait()
    except KeyboardInterrupt:
        pass
    syncer.stop()
    node.shutdown()
    head.close()
    from .object_transfer import close_pool

    close_pool()  # drop pooled transfer connections with the node
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

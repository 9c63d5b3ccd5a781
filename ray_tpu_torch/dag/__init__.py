"""Compiled graphs (aDAG): bind actor methods into a DAG, compile once,
execute repeatedly without per-call scheduling. A port of
``ray_tpu/dag/__init__.py``.

Analog of the reference's ray.dag (dag_node.py bind API +
compiled_dag_node.py:143 CompiledTask / do_exec_tasks resident loops):
each actor task in the compiled graph runs a resident executor thread fed
by shared-memory channels (experimental/channel.py), ONE CHANNEL PER
EDGE. The driver writes the input into every input edge and reads the
result from the output edge — the head, scheduler, and per-task
bookkeeping are out of the loop entirely.

Arbitrary DAGs are supported (the reference compiles arbitrary
graphs): multi-upstream nodes read one message per in-edge per
execution, multi-consumer nodes fan their result out to every out-edge.
Every edge is an N-slot ring channel sized by
``experimental_compile(max_inflight=N)``, so up to N executions overlap
in flight: a K-stage linear pipeline runs at stage-time-bound throughput
instead of sum-of-stages lockstep, with bounded backpressure (a full
ring blocks the producer, never wedges the graph). ``max_inflight=1``
recovers the original rendezvous semantics.

``experimental_compile(device_channels=True)`` switches inter-actor
edges to the typed tensor path (reference: the NCCL channel,
torch_tensor_nccl_channel.py:191): torch and numpy results move device
buffer -> shared slot -> consumer device with NO serialization layer —
a CUDA tensor leaves its card by one device-to-host copy into the slot
and lands on the consumer's card; the channel STATS expose the
accounting (serialized vs tensor bytes).

    with InputNode() as inp:
        a = worker_a.inc.bind(inp)
        b = worker_b.double.bind(inp)
        out = worker_c.add.bind(a, b)
    compiled = out.experimental_compile()
    value = compiled.execute(5).get()
    compiled.teardown()
"""

from __future__ import annotations

import collections
import threading
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.experimental.channel import (
    STREAM_F_ERROR,
    STREAM_F_FINAL,
    STREAM_F_RAW,
    TAG_BYTES,
    TAG_ERROR,
    TAG_STOP,
    ChannelClosed,
    ChannelTimeout,
    ShmChannel,
    channel_path,
    unpack_stream_frame,
)
from ray_tpu_torch.experimental.channel import is_arraylike as _is_arraylike
from ray_tpu_torch.util import flight_recorder as _fr
from ray_tpu_torch.util.metrics import Counter as _Counter

_m_executions = _Counter(
    "port_dag_executions_total",
    "Executions submitted to compiled graphs in this process")

_sp_execute = _fr.register_span("dag.execute")
_sp_read_result = _fr.register_span("dag.read_result")


class DAGNode:
    pass


class InputNode(DAGNode):
    """The driver-supplied per-execution input (reference: input_node.py)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method_name: str, args: tuple):
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args
        self.upstreams = [a for a in args if isinstance(a, DAGNode)]
        if not self.upstreams:
            raise ValueError(
                "a compiled-graph node needs at least one DAGNode arg "
                "(the InputNode or an upstream bind result)")
        # positional template: DAGNode args become ("edge", k) in upstream
        # order; constants are bound at compile time
        k = 0
        self.args_template = []
        for a in args:
            if isinstance(a, DAGNode):
                self.args_template.append(("edge", k))
                k += 1
            else:
                self.args_template.append(("const", a))
        # executor-loop scheduling priority on the hosting actor: loops
        # with a higher priority preempt lower ones for the actor's
        # exec slot when both have inputs ready (1F1B: backward > forward)
        self.priority = 0
        # ring-fed batch mode (serve continuous batching): the exec loop
        # drains up to batch_max ALREADY-QUEUED messages from this node's
        # single in-edge per round and calls the method ONCE with the
        # list, writing one reply per item in order. 0 = not a batch
        # method (the list-in/list-out contract applies even at size 1)
        self.batch_max = 0
        # direct call: the exec loop invokes the method on its own thread
        # with no pool handoff and no exec-lock, regardless of the
        # actor's concurrency mode — the method must be thread-safe
        # against the actor's eager calls (serve replicas are: their
        # eager plane already runs sync methods concurrently)
        self.direct_call = False
        # stream-reply mode (generative decode): the exec loop feeds the
        # method (corr, value) pairs and the method answers each request
        # with MANY TAG_STREAM frames over time (see with_stream_batching)
        self.stream_replies = False

    def with_priority(self, priority: int) -> "ClassMethodNode":
        self.priority = int(priority)
        return self

    def with_batching(self, batch_max: int) -> "ClassMethodNode":
        """Enable ring-fed batch mode on this node (requires exactly one
        in-edge). The method receives a LIST of up to ``batch_max``
        values — everything already queued in the ring when a round
        starts — and must return a list of the same length (items may be
        :class:`~ray_tpu_torch.experimental.channel.BatchItemError` to fail
        one request without failing its batch-mates)."""
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        if len(self.upstreams) != 1:
            raise ValueError(
                "ring-fed batching requires exactly one in-edge")
        self.batch_max = int(batch_max)
        return self

    def with_direct_call(self) -> "ClassMethodNode":
        self.direct_call = True
        return self

    def with_stream_batching(self, batch_max: int) -> "ClassMethodNode":
        """Enable stream-reply batch mode (iteration-level continuous
        batching): the exec loop drains newly-arrived requests from the
        single in-edge BETWEEN invocations and calls the method with a
        list of ``(corr, value)`` pairs (possibly empty while a batch is
        still RUNNING). The method returns ``(replies, active)`` where
        ``replies`` is a list of ``(corr, kind, payload)`` frames
        (kind: "chunk" | "final" | "error") written back as TAG_STREAM
        slots, and ``active`` asks the loop to call again immediately
        (decode in progress) instead of blocking for new input."""
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        if len(self.upstreams) != 1:
            raise ValueError(
                "stream batching requires exactly one in-edge")
        self.batch_max = int(batch_max)
        self.stream_replies = True
        return self

    def experimental_compile(self, buffer_size_bytes: int = 4 * 1024 * 1024,
                             device_channels: bool = False,
                             max_inflight: int = 4):
        """Compile the DAG. ``max_inflight`` sizes every edge's ring so
        that many executions overlap in flight (1 = the old lockstep
        rendezvous; a K-stage pipeline wants >= K to hide stage
        latency)."""
        return CompiledDAG(self, buffer_size_bytes, device_channels,
                           max_inflight)


def _bind(actor_method, *args):
    return ClassMethodNode(actor_method._handle, actor_method._name, args)


# Deferred teardown queue. ``CompiledDAG.__del__`` runs inside the garbage
# collector, which can fire on ANY allocation — including on a thread that
# holds runtime locks — and ``teardown()`` both acquires ``_submit_lock``
# and performs bounded channel round-trips (seconds of work).  Tearing
# down synchronously from __del__ is therefore the exact GC-reentrant
# deadlock shape of ObjectRef's GC-reentrancy fix.
# __del__ only enqueues; this reaper thread — started at compile time,
# never from within the GC — drains the queue on a stack of its own.
_teardown_queue: "collections.deque" = collections.deque()
_teardown_event = threading.Event()
_reaper_started = False
_reaper_lock = threading.Lock()


def _teardown_reaper_loop() -> None:
    while True:
        _teardown_event.wait()
        _teardown_event.clear()
        while True:
            try:
                fn = _teardown_queue.popleft()
            except IndexError:
                break
            try:
                fn()
            except Exception:
                pass  # channels already closed / interpreter shutdown


def _ensure_teardown_reaper() -> None:
    global _reaper_started
    if _reaper_started:
        return
    with _reaper_lock:
        if not _reaper_started:
            threading.Thread(target=_teardown_reaper_loop, daemon=True,
                             name="dag-teardown-reaper").start()
            _reaper_started = True


class CompiledDAGRef:
    """Result handle for one execute(); results must be consumed in
    submission order (single output channel — reference semantics).

    ``get()`` is idempotent: the first call drains the channel up to this
    seq and caches the outcome on the ref, so a second call returns the
    same value (or re-raises the same error) instead of wedging on
    output messages that will never come."""

    _UNSET = object()

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value = self._UNSET
        self._error: Optional[BaseException] = None

    def get(self, timeout: Optional[float] = 30.0):
        if self._error is not None:
            raise self._error
        if self._value is not self._UNSET:
            return self._value
        try:
            self._value = self._dag._read_result(self._seq, timeout)
        except ChannelTimeout:
            raise  # result may still arrive: stay uncached, retryable
        except Exception as e:
            # cache only real task/channel failures — KeyboardInterrupt
            # etc. must leave the ref retryable (the result may still be
            # sitting unread in the output ring)
            self._error = e
            raise
        return self._value


class CompiledStreamRef:
    """Handle for one execution on a stream-reply DAG: an iterator of
    reply frames. Frames for DIFFERENT executions interleave on the one
    output ring; the DAG demuxes them into per-seq buffers (whichever
    waiting reader can take the read lock pumps for everyone), so readers
    consume their own stream independently and in order.

    ``next()`` never wedges on a dead executor: pump rounds are bounded
    and probe the actor FSM, so a replica killed mid-stream surfaces as
    an attributed ActorDiedError on every open stream."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._finished = False
        self._error: Optional[BaseException] = None

    @property
    def seq(self) -> int:
        return self._seq

    @property
    def finished(self) -> bool:
        return self._finished

    def next(self, timeout: Optional[float] = 30.0):
        """Return the next ``(flags, body)`` frame for this execution.
        Raises StopIteration after the FINAL frame was returned,
        ChannelTimeout if no frame arrives in time (retryable), or the
        stream's terminal error (cached: re-raised on every later call)."""
        if self._error is not None:
            raise self._error
        if self._finished:
            raise StopIteration
        try:
            frame = self._dag._next_stream_frame(self._seq, timeout)
        except ChannelTimeout:
            raise  # frame may still arrive: stay retryable
        except Exception as e:
            self._error = e
            raise
        if frame is None:  # buffer drained after FINAL already consumed
            self._finished = True
            raise StopIteration
        flags, body = frame
        if flags & STREAM_F_FINAL:
            self._finished = True
        return flags, body

    def __del__(self):
        # GC-safe: only a lock-free deque append (see CompiledDAG.discard)
        try:
            if not self._finished and self._error is None:
                self._dag.discard_stream(self._seq)
        except Exception:
            pass


class CompiledDAG:
    def __init__(self, output_node: ClassMethodNode, buffer_size: int,
                 device_channels: bool = False, max_inflight: int = 4):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = max_inflight
        # reaper first: __del__ can fire on a HALF-built DAG (executor
        # install below may raise after channels exist), and starting
        # threads from inside the garbage collector is not safe
        _ensure_teardown_reaper()
        # topological order: DFS post-order from the output (dedup by id)
        nodes: List[ClassMethodNode] = []
        seen: set = set()
        input_ids: set = set()
        # iterative post-order DFS (deep pipelines must not hit the
        # interpreter recursion limit)
        stack: List[tuple] = [(output_node, False)]
        while stack:
            n, expanded = stack.pop()
            if isinstance(n, InputNode):
                input_ids.add(id(n))
                continue
            if expanded:
                nodes.append(n)
                continue
            if id(n) in seen:
                continue
            seen.add(id(n))
            stack.append((n, True))
            for u in reversed(n.upstreams):
                stack.append((u, False))
        if not input_ids:
            raise ValueError("compiled DAG must read from an InputNode")
        self._nodes = nodes
        self._output_node = output_node
        self._buffer_size = buffer_size
        self._device = device_channels
        # death-path state: the unique executor actors, the incarnation
        # (num_restarts) each was compiled against, and — once a death is
        # detected — the attributed error every outstanding and future
        # read raises. ``restarting=True`` on that error means the next
        # execute() may REBIND fresh ring channels to the restarted
        # incarnation instead of failing (graftlint death-path contract:
        # a killed executor never wedges execute()/get()).
        self._actors: Dict[Any, Any] = {}
        for n in nodes:
            aid = n.actor._actor_id
            self._actors.setdefault(aid, n.actor)
        self._incarnations: Dict[Any, int] = {}
        self._broken: Optional[BaseException] = None

        # split locks: a submitter blocked on a full pipeline must not
        # prevent a reader from draining results (that would deadlock)
        self._submit_lock = threading.Lock()
        self._read_lock = threading.Lock()
        self._next_seq = 0
        self._next_read = 0
        self._results: dict = {}
        # seqs whose result will never be collected (an abandoned serve
        # response): lock-free deque because discards arrive from
        # __del__ inside the GC — _read_result folds it into a set and
        # drops matching payloads instead of caching them forever
        self._discard_queue: "collections.deque" = collections.deque()
        self._discards: set = set()
        self._torn_down = False
        self._channels: List[ShmChannel] = []
        self._input_chans: List[ShmChannel] = []
        # stream-reply demux state (see CompiledStreamRef): per-seq frame
        # buffers + completion set, guarded by _stream_cv. Readers that
        # cannot take _read_lock (someone else is pumping) wait here.
        self._stream = bool(getattr(output_node, "stream_replies", False))
        self._stream_bufs: Dict[int, collections.deque] = {}
        self._stream_done: set = set()
        self._stream_completed = 0
        self._stream_discard_queue: "collections.deque" = collections.deque()
        self._stream_discards: set = set()
        self._stream_cv = threading.Condition()
        self._build()

    @staticmethod
    def _local_identity():
        """(node_hex, advertise_ip) of the calling (driver) process —
        the placement the shm-vs-net edge decision compares actors
        against. None hex = no resolver (client mode): every edge
        stays shm, the pre-cross-host behavior."""
        from ray_tpu_torch.core.runtime import get_current_runtime

        rt = get_current_runtime()
        node = getattr(getattr(rt, "head", None), "head_node", None)
        if node is not None:
            return node.hex, getattr(node, "node_ip", "127.0.0.1")
        return (getattr(rt, "node_hex", None),
                getattr(rt, "node_ip", "127.0.0.1"))

    def _resolve_locations(self, timeout: float = 30.0) -> Dict[Any, Optional[str]]:
        """Placement of every executor actor, for the shm-vs-net edge
        decision. An actor bound into a DAG right after ``.remote()``
        may not have a registered record yet — compiling against a
        guessed placement would silently lay a same-host shm ring under
        a cross-host edge — so this WAITS (bounded) for each record.
        Without a resolver (worker-process or client drivers) every
        location is None and all edges stay shm, the pre-cross-host
        behavior."""
        import time as _time

        from ray_tpu_torch.core.runtime import get_current_runtime

        rt = get_current_runtime()
        if getattr(rt, "head", None) is None:
            return {aid: None for aid in self._actors}
        locs: Dict[Any, Optional[str]] = {}
        deadline = _time.monotonic() + timeout
        for aid in self._actors:
            while True:
                info = self._actor_state(aid)
                node_hex = (info or {}).get("node_hex")
                if node_hex or _time.monotonic() > deadline:
                    locs[aid] = node_hex
                    break
                _time.sleep(0.02)
        return locs

    def _build(self) -> None:
        """Create the per-edge channels and install the resident
        executor loops (reference: do_exec_tasks). Called at compile time
        and again by a rebind after an executor restart — each build uses
        a fresh uid, so stale loops on old incarnations can never cross
        wires with the new rings, and placement is RE-resolved, so a
        restarted actor that came back on a different node gets net-ring
        (or shm) edges matching its NEW placement.

        Edge transport is resolved from actor placement: both endpoints
        on the same node share a /dev/shm ring; endpoints on different
        nodes get a NetRing (core/net_ring.py — the machine-checked
        ring-protocol-net transport) over the authenticated peer mesh.
        Net rings install in two phases because the READING process owns
        the receive ring: (A) ``__compiled_setup__`` creates the reader
        endpoints on each consuming actor and returns that process's
        ring-host address+key, (B) ``__compiled_exec__`` starts the
        loops with channel descriptors — shm paths, local ring ids, or
        dial-out targets."""
        nodes = self._nodes
        uid = uuid.uuid4().hex[:10]
        self._uid = uid
        node_idx = {id(n): i for i, n in enumerate(nodes)}

        drv_hex, drv_ip = self._local_identity()
        locs = self._resolve_locations()

        def actor_hex(n) -> Optional[str]:
            return locs.get(n.actor._actor_id)

        def is_net(prod_hex, cons_hex) -> bool:
            # shm ONLY when the driver shares the node with both
            # endpoints: the driver creates every shm segment in ITS
            # /dev/shm and is the death-path writer of last resort for
            # it — neither works for a segment that would have to live
            # on another host. Co-located actors on a REMOTE node get a
            # net ring too (loopback TCP there); remote-created shm for
            # that case is a roadmapped follow-up.
            if drv_hex is None or prod_hex is None or cons_hex is None:
                return False  # no resolver: pre-cross-host behavior
            return not (prod_hex == cons_hex == drv_hex)

        # one channel per edge: (producer id | "input") -> consumer slot
        self._channels = []
        self._input_chans = []
        self._net_actors = set()  # actor ids holding net endpoints

        def new_shm(name: str) -> ShmChannel:
            ch = ShmChannel(channel_path(f"{uid}_{name}"),
                            self._buffer_size, create=True,
                            n_slots=self.max_inflight)
            self._channels.append(ch)
            return ch

        # per-edge plan; net consumer descriptors resolve in Phase A
        in_descs: Dict[int, List] = {}
        out_descs: Dict[int, List] = {}
        setup_rings: Dict[Any, List[dict]] = {}   # aid -> reader specs
        net_writers: List[dict] = []  # producer-side dial targets to fix up
        driver_net_inputs: List[str] = []  # ring ids the driver dials

        for i, n in enumerate(nodes):
            in_descs[i] = []
            out_descs.setdefault(i, [])
            cons_hex = actor_hex(n)
            cons_aid = n.actor._actor_id
            for k, u in enumerate(n.upstreams):
                name = f"e{i}_{k}"
                prod_hex = drv_hex if isinstance(u, InputNode) \
                    else actor_hex(u)
                if not is_net(prod_hex, cons_hex):
                    ch = new_shm(name)
                    in_descs[i].append(("shm", ch.path))
                    if isinstance(u, InputNode):
                        self._input_chans.append(ch)
                    else:
                        out_descs.setdefault(node_idx[id(u)], []).append(
                            ("shm", ch.path))
                    continue
                ring_id = f"{uid}_{name}"
                setup_rings.setdefault(cons_aid, []).append(
                    {"ring": ring_id, "n_slots": self.max_inflight,
                     "capacity": self._buffer_size})
                self._net_actors.add(cons_aid)
                in_descs[i].append(("netr", ring_id))
                if isinstance(u, InputNode):
                    driver_net_inputs.append(ring_id)
                    net_writers.append({"ring": ring_id, "reader": cons_aid,
                                        "driver": True})
                else:
                    pi = node_idx[id(u)]
                    slot = len(out_descs.setdefault(pi, []))
                    out_descs[pi].append(None)  # fixed up after Phase A
                    net_writers.append({"ring": ring_id, "reader": cons_aid,
                                        "driver": False, "node": pi,
                                        "slot": slot})
                    self._net_actors.add(u.actor._actor_id)

        # output edge: last stage -> driver
        oi = node_idx[id(self._output_node)]
        out_hex = actor_hex(self._output_node)
        if is_net(out_hex, drv_hex):
            from ray_tpu_torch.core import net_ring

            ring_id = f"{uid}_out"
            reader = net_ring.create_reader(
                ring_id, self.max_inflight, self._buffer_size,
                advertise_ip=drv_ip)
            self._channels.append(reader)
            self._out = reader
            host = net_ring.ensure_host(drv_ip)
            out_descs[oi].append(("netw", host.address[0], host.address[1],
                                  host.authkey.hex(), ring_id,
                                  self.max_inflight))
            self._net_actors.add(self._output_node.actor._actor_id)
        else:
            out_ch = new_shm("out")
            self._out = out_ch
            out_descs[oi].append(("shm", out_ch.path))

        import ray_tpu_torch

        try:
            # Phase A: consuming actors create their net reader endpoints
            # and report their ring-host dial-in (address + session key)
            hosts: Dict[Any, dict] = {}
            if setup_rings:
                aids = list(setup_rings)
                acks = [self._actors[aid].__compiled_setup__.remote(
                            {"rings": setup_rings[aid]})
                        for aid in aids]
                for aid, rep in zip(aids, ray_tpu_torch.get(acks, timeout=60)):
                    hosts[aid] = rep

            def dial_desc(wspec) -> tuple:
                rep = hosts[wspec["reader"]]
                host, port = rep["addr"]
                return ("netw", host, port, rep["key"], wspec["ring"],
                        self.max_inflight)

            for wspec in net_writers:
                if wspec["driver"]:
                    continue
                out_descs[wspec["node"]][wspec["slot"]] = dial_desc(wspec)

            # driver-side net writers (input edges into remote stage 0s)
            from ray_tpu_torch.core import net_ring

            for wspec in net_writers:
                if not wspec["driver"]:
                    continue
                rep = hosts[wspec["reader"]]
                w = net_ring.NetRingWriter.connect(
                    tuple(rep["addr"]), bytes.fromhex(rep["key"]),
                    wspec["ring"], self.max_inflight, self._buffer_size)
                self._channels.append(w)
                self._input_chans.append(w)

            # Phase B: install the resident loops
            acks = []
            for i, task in enumerate(nodes):
                acks.append(task.actor.__compiled_exec__.remote({
                    "method": task.method_name,
                    "in_paths": in_descs[i],
                    "out_paths": out_descs[i],
                    "capacity": self._buffer_size,
                    "args_template": task.args_template,
                    "device": self._device,
                    "uid": uid,
                    "priority": getattr(task, "priority", 0),
                    "batch_max": getattr(task, "batch_max", 0),
                    "direct_call": getattr(task, "direct_call", False),
                    "stream_replies": getattr(task, "stream_replies",
                                              False),
                }))
            ray_tpu_torch.get(acks, timeout=60)
        except BaseException:
            # executor install failed: close + unlink every channel NOW
            # instead of leaking the shm segments until the GC happens to
            # enqueue a teardown for the half-built DAG (and that
            # teardown would block on sentinel round-trips to executors
            # that never came up)
            self._torn_down = True
            for ch in self._channels:
                try:
                    ch.close(unlink=True)
                except Exception:
                    pass
            raise
        for aid in self._actors:
            info = self._actor_state(aid)
            self._incarnations[aid] = \
                (info or {}).get("num_restarts", 0) or 0

    # ------------------------------------------------- executor death path

    @staticmethod
    def _resolve_actor(aid):
        from ray_tpu_torch.core.runtime import get_current_runtime

        rt = get_current_runtime()
        head = getattr(rt, "head", None)
        if head is None:
            return None
        try:
            return head.actor_location(aid)
        except Exception:
            return None

    def _actor_state(self, aid):
        return self._resolve_actor(aid)

    def _probe_dead(self):
        """Resolve every executor actor against the actor FSM. Returns
        (attributed_error | None, restart_possible)."""
        from ray_tpu_torch.core.exceptions import ActorDiedError

        for aid in self._actors:
            info = self._actor_state(aid)
            if info is None:
                continue  # no resolver (client mode): stay timeout-based
            state = info.get("state")
            cause = info.get("death_cause")
            if state == "DEAD":
                return ActorDiedError(
                    aid, f"compiled-graph executor died: "
                         f"{cause or 'actor is dead'}"), False
            if (info.get("num_restarts", 0) or 0) != \
                    self._incarnations.get(aid, 0) \
                    or state in ("RESTARTING", "PENDING_CREATION"):
                # the loop died with the old incarnation; the actor
                # itself is (or will be) back — a rebind can recover
                return ActorDiedError(
                    aid, f"compiled-graph executor incarnation died: "
                         f"{cause or 'worker process died'}",
                    restarting=True), True
        return None, False

    def _poison_all(self) -> None:
        """Best-effort STOP/poison into EVERY edge. After a mid-graph
        executor death, stages downstream of the corpse would otherwise
        park forever on rings nobody will write again. Shm edges: the
        driver holds (and created) every channel, and a dead stage's
        out-edges have no live writer, so it safely acts as the writer
        of last resort. Net edges: the driver poisons its own endpoints
        directly and broadcasts a fire-and-forget ``__compiled_poison__``
        so each surviving actor fails its local reader endpoints under
        this DAG's uid (the driver cannot reach a ring between two
        remote processes from here)."""
        for ch in self._channels:
            if isinstance(ch, ShmChannel):
                try:
                    ch.write(b"", tag=TAG_STOP, timeout=0.2)
                except Exception:
                    pass
            else:
                try:
                    ch.poison()
                except Exception:
                    pass
        for aid in getattr(self, "_net_actors", ()):
            try:
                # fire-and-forget: the dead actor's call bounces, the
                # survivors unpark; waiting here would block the death
                # path on the very processes being declared dead
                self._actors[aid].__compiled_poison__.remote(self._uid)
            except Exception:
                pass

    def _handle_executor_death(self, err, restartable: bool) -> None:
        """An executor is gone: every outstanding CompiledDAGRef fails
        with the attributed error (their in-flight rounds died inside
        the graph), surviving stage loops get poisoned out of their
        parked reads, and — for a permanent death — the rings tear down
        via the reaper. The DAG object stays; a restartable death lets
        the next execute() rebind."""
        _fr.dump(f"executor-death:{type(err).__name__}")
        self._broken = err
        # stream readers parked on the demux condition must observe the
        # death NOW, not after their wait times out
        with self._stream_cv:
            self._stream_cv.notify_all()
        self._poison_all()
        if not restartable:
            self._torn_down = True
            chans = list(self._channels)

            def reap():
                for ch in chans:
                    try:
                        ch.close(unlink=True)
                    except Exception:
                        pass

            _teardown_queue.append(reap)
            _teardown_event.set()

    def _try_rebind_locked(self) -> bool:
        """Under _submit_lock, after a restartable executor death: if
        every executor actor is ALIVE again, close the poisoned rings and
        build fresh ones against the new incarnations. Outstanding refs
        stay failed (their rounds died); new executes flow normally."""
        if self._torn_down or self._broken is None:
            return False
        if not getattr(self._broken, "restarting", False):
            return False
        for aid in self._actors:
            info = self._actor_state(aid)
            if info is None or info.get("state") != "ALIVE":
                return False
        with self._read_lock:
            old = list(self._channels)
            for ch in old:
                try:
                    ch.close(unlink=True)
                except Exception:
                    pass
            try:
                # deliberate: the rebind holds BOTH dag locks across the
                # executor re-install round-trip — it must be exclusive
                # against every submit/read, and the install rides the
                # actor plane, which never takes dag locks (no cycle)
                # graftlint: ignore[blocking-under-lock]
                self._build()
            except BaseException:
                self._torn_down = True
                raise
            # outstanding (unread) rounds died with the old rings: reads
            # for them keep raising via the per-seq check in _read_result
            self._dead_seqs = getattr(self, "_dead_seqs", {})
            for s in range(self._next_read, self._next_seq):
                if s not in self._results:
                    self._dead_seqs[s] = self._broken
            self._next_read = self._next_seq
            self._broken = None
        return True

    def execute(self, value: Any,
                timeout: Optional[float] = 60.0) -> CompiledDAGRef:
        """Submit one execution. Backpressure is bounded: when
        ``max_inflight`` rounds are already in the rings, this blocks up
        to ``timeout`` for a slot and raises ChannelTimeout with NOTHING
        written — input rounds are all-or-nothing (wait for a free slot
        on every edge first; the driver is the only writer, so observed
        free slots cannot vanish), so a timed-out execute leaves the DAG
        healthy and retryable instead of poisoned.

        Executor death never wedges this call: slot waits run in bounded
        rounds that probe the actor FSM, a detected death raises an
        attributed ActorDiedError, and a RESTARTED executor (the actor
        had max_restarts budget) gets fresh rings bound transparently
        before the next submission."""
        import time as _time

        _t0 = _fr.now()
        with self._submit_lock:
            if self._broken is not None and not self._torn_down:
                # deliberate: rebinding under _submit_lock blocks other
                # submitters for the install round-trip — exclusivity is
                # the point (see _try_rebind_locked)
                # graftlint: ignore[blocking-under-lock]
                self._try_rebind_locked()
            if self._torn_down:
                raise self._broken or \
                    RuntimeError("compiled DAG was torn down")
            if self._broken is not None:
                raise self._broken
            # one deadline across ALL edges — sequential full-timeout
            # waits would make the worst case num_edges x timeout
            deadline = None if timeout is None else \
                _time.monotonic() + timeout
            for ch in self._input_chans:
                while True:
                    remaining = (None if deadline is None
                                 else max(0.0, deadline - _time.monotonic()))
                    round_t = 1.0 if remaining is None \
                        else min(1.0, remaining)
                    try:
                        ch.wait_writable(round_t)
                        break
                    except ChannelTimeout:
                        err, restartable = self._probe_dead()
                        if err is not None:
                            self._handle_executor_death(err, restartable)
                            raise err
                        if remaining is not None and remaining <= round_t:
                            raise
            # dispatch fast path: bytes and typed arrays skip the
            # serializer entirely (driver-side mirror of the executor's
            # tensor-channel output path); everything else packs its
            # serialized segments straight into the ring slot with no
            # intermediate to_bytes() buffer.
            if type(value) is bytes:
                for ch in self._input_chans:
                    ch.write(value, tag=TAG_BYTES, timeout=timeout)
            elif _is_arraylike(value):
                for ch in self._input_chans:
                    ch.write_array(value, timeout=timeout)
            else:
                sobj = serialization.serialize(value)
                for ch in self._input_chans:
                    ch.write_serialized(sobj, timeout=timeout)
            seq = self._next_seq
            self._next_seq += 1
        _m_executions.inc()
        _sp_execute.end(_t0)
        return CompiledDAGRef(self, seq)

    @property
    def broken(self) -> Optional[BaseException]:
        """The attributed error a detected executor death left behind
        (None while healthy). ``restarting=True`` on it means the next
        execute() may rebind to the restarted incarnation."""
        return self._broken

    @property
    def torn_down(self) -> bool:
        return self._torn_down

    def inflight(self) -> int:
        """Executions submitted but not yet drained from the output ring
        — the per-DAG admission signal (rings + executor occupancy).
        Racy by nature (lock-free reads); callers treat it as a hint.
        Stream mode counts an execution in flight until its FINAL frame
        is demuxed (not merely until the first reply arrives)."""
        if self._stream:
            return self._next_seq - self._stream_completed
        return self._next_seq - self._next_read

    def input_writable(self) -> bool:
        """True when every input edge has a free slot right now — a
        non-blocking admission probe. The driver is the only writer, so
        an observed free slot cannot vanish before this thread writes
        (another submitter thread may take it: re-checked under
        _submit_lock by execute())."""
        if self._torn_down or self._broken is not None:
            return False
        try:
            return all(ch.writable() for ch in self._input_chans)
        except Exception:
            return False  # mapping closed (teardown race)

    def discard(self, seq: int) -> None:
        """Mark one execution's result as never-to-be-collected (the ref
        holder was dropped). GC-safe: only a lock-free deque append —
        the next _read_result drains the queue and drops the payload
        instead of caching it forever."""
        self._discard_queue.append(seq)

    # ------------------------------------------------------ stream replies

    def execute_stream(self, value: Any,
                       timeout: Optional[float] = 60.0) -> CompiledStreamRef:
        """Submit one execution on a stream-reply DAG and return the
        frame iterator for its replies. Same all-or-nothing input
        semantics as :meth:`execute`."""
        if not self._stream:
            raise ValueError("execute_stream requires a DAG compiled from "
                             "a with_stream_batching() node")
        ref = self.execute(value, timeout)
        with self._stream_cv:
            self._stream_bufs.setdefault(ref._seq, collections.deque())
        return CompiledStreamRef(self, ref._seq)

    def discard_stream(self, seq: int) -> None:
        """Abandon a stream mid-flight (ref holder dropped). GC-safe:
        lock-free append; the pump drops this seq's remaining frames and
        counts it complete when its FINAL frame passes through."""
        self._stream_discard_queue.append(seq)

    def _apply_stream_discards_cv(self) -> None:
        # caller holds _stream_cv
        while True:
            try:
                s = self._stream_discard_queue.popleft()
            except IndexError:
                break
            buf = self._stream_bufs.pop(s, None)
            if s in self._stream_done:
                self._stream_done.discard(s)
            elif buf is not None or s < self._next_seq:
                self._stream_discards.add(s)

    def _pump_stream_locked(self, round_t: float) -> None:
        """Read ONE message off the shared output ring (caller holds
        _read_lock) and demux it into the per-seq buffers. A timeout
        round probes the executor FSM so a killed replica attributes
        instead of wedging every reader."""
        try:
            tag, payload = self._out.read(round_t)
        except ChannelTimeout:
            err, restartable = self._probe_dead()
            if err is not None:
                self._handle_executor_death(err, restartable)
                raise err
            return  # caller re-checks its deadline
        except ChannelClosed:
            err, restartable = self._probe_dead()
            if err is not None:
                self._handle_executor_death(err, restartable)
                raise err
            raise
        corr, flags, body = unpack_stream_frame(payload)
        with self._stream_cv:
            self._apply_stream_discards_cv()
            final = bool(flags & STREAM_F_FINAL)
            if corr in self._stream_discards:
                if final:
                    self._stream_discards.discard(corr)
                    self._stream_completed += 1
            else:
                self._stream_bufs.setdefault(
                    corr, collections.deque()).append((flags, body))
                if final:
                    self._stream_done.add(corr)
                    self._stream_completed += 1
            self._stream_cv.notify_all()

    def _next_stream_frame(self, seq: int, timeout: Optional[float]):
        """Next buffered frame for ``seq`` (None = stream already fully
        consumed). Whichever reader finds its buffer empty and can take
        _read_lock pumps the shared ring for everyone; readers that lose
        the lock race wait on the condition instead of contending."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            with self._stream_cv:
                self._apply_stream_discards_cv()
                buf = self._stream_bufs.get(seq)
                if buf:
                    frame = buf.popleft()
                    if not buf and seq in self._stream_done:
                        del self._stream_bufs[seq]
                        self._stream_done.discard(seq)
                    return frame
                if seq in self._stream_done:
                    self._stream_bufs.pop(seq, None)
                    self._stream_done.discard(seq)
                    return None
                if self._broken is not None:
                    raise self._broken
                if self._torn_down:
                    raise RuntimeError("compiled DAG was torn down")
            remaining = (None if deadline is None
                         else deadline - _time.monotonic())
            if remaining is not None and remaining <= 0:
                raise ChannelTimeout(
                    f"no stream frame for execution #{seq} "
                    f"within {timeout}s")
            round_t = 1.0 if remaining is None else min(1.0, remaining)
            # deliberate: the winning reader performs one bounded ring
            # read under _read_lock on behalf of every stream — the ring
            # is single-consumer, so the read MUST be exclusive
            # graftlint: ignore[blocking-under-lock]
            if self._read_lock.acquire(timeout=0.05):
                try:
                    self._pump_stream_locked(round_t)
                finally:
                    self._read_lock.release()
            else:
                # someone else is pumping: wait for their demux notify
                with self._stream_cv:
                    if not self._stream_bufs.get(seq) \
                            and seq not in self._stream_done \
                            and self._broken is None:
                        self._stream_cv.wait(timeout=min(0.2, round_t))

    _MISS = object()

    def _apply_discards_locked(self) -> None:
        while True:
            try:
                s = self._discard_queue.popleft()
            except IndexError:
                break
            if self._results.pop(s, self._MISS) is self._MISS \
                    and s >= self._next_read:
                self._discards.add(s)

    def _read_result(self, seq: int, timeout: Optional[float]):
        import time as _time

        from ray_tpu_torch.experimental.channel import TAG_TENSOR

        _t0 = _fr.now()
        with self._read_lock:
            self._apply_discards_locked()
            dead = getattr(self, "_dead_seqs", None)
            if dead and seq in dead:
                raise dead.pop(seq)  # round died in a rebound ring
            if self._torn_down and seq not in self._results:
                # a reader arriving after teardown started must not
                # touch rings teardown is draining/closing
                raise self._broken or RuntimeError(
                    "compiled DAG was torn down")
            if seq < self._next_read and seq not in self._results:
                raise ValueError(
                    f"result for execution #{seq} was already consumed "
                    "(CompiledDAGRef.get() caches it on the ref — hold "
                    "onto the ref instead of re-deriving the seq)")
            # bounded rounds, never an unbounded park: each timeout round
            # probes the executor actors, so a killed stage surfaces as
            # an attributed ActorDiedError instead of a wedged get()
            deadline = None if timeout is None else \
                _time.monotonic() + timeout
            while self._next_read <= seq:
                if self._broken is not None and seq not in self._results:
                    raise self._broken
                remaining = (None if deadline is None
                             else deadline - _time.monotonic())
                round_t = 1.0 if remaining is None \
                    else min(1.0, max(0.0, remaining))
                try:
                    tag, payload = self._out.read(round_t)
                except ChannelTimeout:
                    err, restartable = self._probe_dead()
                    if err is not None:
                        self._handle_executor_death(err, restartable)
                        raise err
                    if remaining is not None and remaining <= round_t:
                        raise
                    continue
                except ChannelClosed:
                    # torn slot (writer crashed mid-publish) or poisoned
                    # ring: attribute it if an executor is down
                    err, restartable = self._probe_dead()
                    if err is not None:
                        self._handle_executor_death(err, restartable)
                        raise err
                    raise
                if self._next_read in self._discards:
                    self._discards.discard(self._next_read)
                else:
                    self._results[self._next_read] = (tag, payload)
                self._next_read += 1
            tag, payload = self._results.pop(seq)
        _sp_read_result.end(_t0)
        if tag == TAG_TENSOR or tag == TAG_BYTES:
            return payload  # typed array / raw bytes: no serializer
        value = serialization.deserialize(payload)
        if tag == TAG_ERROR:
            raise value
        return value

    def teardown_async(self) -> None:
        """Enqueue teardown on the reaper thread (non-blocking). For
        callers that must not pay the bounded sentinel round-trips on
        their own thread (serve lane retirement on a refresh callback)."""
        _ensure_teardown_reaper()
        _teardown_queue.append(self.teardown)
        _teardown_event.set()

    def teardown(self) -> None:
        with self._submit_lock:
            if self._torn_down:
                return
            self._torn_down = True
        # push stop sentinels into every input edge, then drain the output
        # until the sentinel comes out the far end; every step is bounded.
        # The drain holds _read_lock: the output ring is single-consumer,
        # and a caller still blocked in _read_result (a serve lane being
        # retired with requests in flight) must finish its read before
        # teardown touches the same slots — two concurrent readers would
        # double-ack and cross-wire results
        stop_sent = 0
        with self._read_lock:
            for _ in range(self._next_seq + len(self._nodes) + 2):
                while stop_sent < len(self._input_chans):
                    try:
                        self._input_chans[stop_sent].write(
                            b"", tag=TAG_STOP, timeout=0.5)
                        stop_sent += 1
                    except ChannelTimeout:
                        break  # slot full: drain below, retry
                    except Exception:
                        stop_sent += 1
                try:
                    self._out.read(timeout=2.0)
                except ChannelClosed:
                    break  # sentinel arrived: all loops exited
                except Exception:
                    if stop_sent >= len(self._input_chans):
                        break
            for ch in self._channels:
                ch.close(unlink=True)

    def __del__(self):
        # NEVER tear down synchronously: __del__ runs inside the GC, which
        # can fire on a thread holding runtime locks, and teardown() takes
        # _submit_lock + does channel round-trips — hand the work to the
        # reaper thread instead (see _teardown_queue above).
        try:
            if not self._torn_down:
                _teardown_queue.append(self.teardown)
                _teardown_event.set()
        except Exception:  # interpreter shutdown
            pass

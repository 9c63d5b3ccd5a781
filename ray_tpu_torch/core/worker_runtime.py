"""Worker process runtime + executor.

Analog of the reference's CoreWorker in WORKER mode plus the Python worker
shell (``python/ray/_private/workers/default_worker.py`` +
``core_worker/transport/task_receiver.cc``): connects to its node over a unix
socket, registers, then serves ``exec`` messages. Holds actor instances,
enforces actor ordering / max_concurrency / asyncio execution (reference:
actor_scheduling_queue.cc, concurrency groups), performs ``get``/``put``
against the node store (zero-copy arena reads), and forwards nested task
submissions to the head (workers are full API clients — reference: workers own
submitted tasks; here the head tracks ownership for them).
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import os
import pickle
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from . import fault_injection
from . import object_ref as object_ref_mod
from . import ref_tracker, serialization
from .config import Config, set_global_config, global_config
from .exceptions import ObjectLostError, TaskCancelledError, TaskError, GetTimeoutError
from .ids import ActorID, JobID, ObjectID, TaskID
from .object_ref import ObjectRef
from .object_store import ArenaClient
from .protocol import Channel, RpcClient, connect
from .task_spec import TaskSpec

from ray_tpu_torch.experimental.channel import is_arraylike as _is_arraylike
from ray_tpu_torch.util import flight_recorder as _fr

_sp_dag_exec = _fr.register_span("dag.exec", tag_keys=("method",))
_sp_batch_drain = _fr.register_span("dag.batch_drain", tag_keys=("method",))


class _BatchErrPayload:
    """Pre-serialized TAG_ERROR payload standing in a batch result slot
    (the whole batch call failed: every item ships the same error)."""

    __slots__ = ("payload",)

    def __init__(self, payload: bytes):
        self.payload = payload


class _ActorState:
    def __init__(self, instance, max_concurrency: int, is_async: bool):
        self.instance = instance
        self.is_async = is_async
        if is_async:
            self.loop = asyncio.new_event_loop()
            self.loop_thread = threading.Thread(
                target=self.loop.run_forever, daemon=True, name="actor-asyncio"
            )
            self.loop_thread.start()
            # sync methods (generators included) run on up to
            # max_concurrency threads, as on a threaded actor. The JAX
            # package's runtime gives them one thread: a serve replica
            # (async: its unary entry is a coroutine) then runs every
            # stream's generator, each a whole request, one after
            # another, and queues its health ping behind them
            self.pool = ThreadPoolExecutor(max_workers=max_concurrency)
        else:
            self.loop = None
            self.pool = ThreadPoolExecutor(max_workers=max_concurrency)
        # serial actors (sync, max_concurrency=1): compiled-graph executor
        # loops call the method DIRECTLY under this lock instead of paying
        # the pool submit/result thread handoff per hop; eager
        # method bodies take the same lock on their pool thread, so the
        # one-method-at-a-time actor contract holds across both planes
        self.exec_lock = (threading.Lock()
                          if not is_async and max_concurrency == 1 else None)
        # compiled-exec scheduling: tokens from higher-priority loops
        # holding the actor (1F1B backward-over-forward); deque for
        # thread-safe append/pop, condition for the low-priority loops
        # to park on instead of polling while a backward runs
        self.prio_waiting: deque = deque()
        self.prio_cv = threading.Condition()

    def stop(self) -> None:
        """Release the actor's execution machinery (worker exit path;
        os._exit would reap the threads anyway, but pending work gets a
        chance to settle and the lifecycle is explicit)."""
        self.pool.shutdown(wait=False)
        if self.loop is not None:
            try:
                self.loop.call_soon_threadsafe(self.loop.stop)
            except RuntimeError:
                pass  # loop already closed
            self.loop_thread.join(timeout=1.0)


class WorkerRuntime:
    """Runtime installed as the process-global API backend inside workers."""

    def __init__(self, channel: Channel, init_info: dict):
        self.channel = channel
        self.rpc = RpcClient(channel)
        self.worker_id: bytes = init_info["worker_id"]
        self.node_hex: str = init_info["node_hex"]
        self.node_ip: str = init_info.get("node_ip", "127.0.0.1")
        self.job_id = JobID(init_info["job_id"])
        # the node's session dir: workers hosting serve replicas write
        # their access logs under <session_dir>/logs/serve/
        self.session_dir: str = init_info.get("session_dir", "")
        set_global_config(Config.from_json(init_info["config"]))
        _fr.adopt_config(global_config())
        _fr.set_process_label(f"worker:{os.getpid()}")
        if self.session_dir:
            _fr.set_dump_dir(self.session_dir)
        # adopt the node's extra import roots (driver-side sys.path inserts)
        # so by-reference pickles of driver-loaded modules resolve here
        for p in init_info.get("sys_path", []):
            if p not in sys.path:
                sys.path.append(p)
        self.arena = ArenaClient(init_info["arena_path"], init_info["arena_capacity"])
        self._fn_cache: Dict[str, Any] = {}
        self._actors: Dict[ActorID, _ActorState] = {}
        # ONE thread: plain tasks execute strictly one-at-a-time per worker
        # process (the ray semantic user code relies on for process-global
        # state, e.g. jax). Staged (pipelined) tasks queue behind the
        # running one and can be handed back via "unstage".
        self._task_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="exec")
        self._staged: Dict[object, Any] = {}  # task_id -> pending Future
        self._put_counter = 0
        self._put_lock = threading.Lock()
        self._current_task = threading.local()
        self._cancelled: set = set()
        self._shutdown = threading.Event()
        self.accelerator_binding: Dict[str, List[int]] = {}
        # the cards this worker may bind from (inherited from its node)
        from .accelerators import visible_devices

        self._inherited_gpus = visible_devices()
        # direct (head-bypass) path: this worker OWNS its eligible nested
        # submissions (reference: submitter-side TaskManager + memory
        # store). Arg pins are owner-side (the manager's pin table) plus
        # holder leases the executing node takes from spec.pinned_args —
        # no pin traffic leaves this process.
        from .direct import DirectTaskManager

        self.direct = DirectTaskManager(
            self._direct_submit,
            ext_wait=self._ext_wait_objects)
        # direct actor calls (resolve runs on the submitter's own resolver
        # thread, so a blocking RPC there is safe)
        from .direct import DirectActorSubmitter

        self.direct_actors = DirectActorSubmitter(
            self.direct, self._direct_submit,
            lambda aid: self.rpc.call("rpc", "actor_location", aid))

    def _ext_wait_objects(self, oids, timeout):
        """One availability round against the cluster object directory
        (dependency resolver's external-object wait)."""
        return self.rpc.call("store", "wait", list(oids), len(oids),
                             timeout, timeout=None)

    # ------------------------------------------------------------------ API
    # (same surface the driver runtime exposes; public api dispatches here)

    def is_initialized(self) -> bool:
        return True

    @property
    def mode(self) -> str:
        return "WORKER"

    def put(self, value: Any, _owner=None) -> ObjectRef:
        with self._put_lock:
            self._put_counter += 1
            idx = self._put_counter
        tid = getattr(self._current_task, "task_id", None)
        if tid is not None:
            oid = ObjectID.for_put(tid, idx)
        else:
            oid = ObjectID.from_random()  # put outside a task context
        sobj = serialization.serialize(value)
        self._store_object(oid, sobj, is_error=False)
        self.rpc.call("rpc", "register_owned_object", oid)
        ref = ObjectRef(oid)
        ref_tracker.annotate(
            oid, ref_tracker.KIND_PUT, size=sobj.total_bytes,
            creator=getattr(self._current_task, "name", None) or "worker")
        return ref

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            # owner_node doubles as a location hint (stream items carry
            # the executor node so the pull goes peer-to-peer)
            hint = r.owner_node if isinstance(r.owner_node, str) else None
            out.append(self._get_one(r.id, remaining, hint))
        return out

    def _get_one(self, oid: ObjectID, timeout: Optional[float],
                 hint: Optional[str] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        # owned direct results resolve in-process (blocks until the
        # executor's reply lands; no node round-trip)
        local = self.direct.get_local(oid, timeout)
        owned_store = False
        if local is not None:
            payload, is_error = local
            if payload is not None:
                value = serialization.deserialize(payload)
                if is_error:
                    raise value
                return value
            # large result: sealed in a node store — fall through, with
            # the sealing node as a pull hint
            owned_store = self.direct.owns_lineage(oid)
            hint = hint or self.direct.result_node(oid)
        if owned_store:
            # bounded first round: if the sealing node died, this owner is
            # the only process that can resubmit the creating task (owner
            # lineage — reference object_recovery_manager.h:90). The 2 s
            # grace absorbs location-report lag before declaring loss.
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            probe_t = 2.0 if remaining is None else min(remaining, 2.0)
            rep = self.rpc.call("store", "get", oid, probe_t, hint,
                                timeout=None)
            if rep[0] == "timeout":
                located = self.rpc.call("store", "wait", [oid], 1, 0.0,
                                        timeout=None)
                if not located and self.direct.recover(oid):
                    remaining = (None if deadline is None
                                 else max(0.0, deadline - time.monotonic()))
                    return self._get_one(oid, remaining)
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                rep = self.rpc.call("store", "get", oid, remaining, hint,
                                    timeout=None)
        else:
            rep = self.rpc.call("store", "get", oid, timeout, hint,
                                timeout=None)
        kind = rep[0]
        if kind == "timeout":
            raise GetTimeoutError(f"get timed out on {oid.hex()}")
        if kind == "inline":
            _, payload, is_error = rep
            value = serialization.deserialize(payload)
        else:
            _, offset, size, is_error = rep
            view = self.arena.view(offset, size)
            value = serialization.deserialize(view)
        if is_error:
            raise value
        return value

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        oids = [r.id for r in refs]
        owned_pending = self.direct.pending_oids(oids)
        if not owned_pending:
            ready_set = set(self.direct.ready_subset(oids))
            rest = [o for o in oids if o not in ready_set]
            if rest and len(ready_set) < num_returns:
                ready_set |= set(self.rpc.call(
                    "store", "wait", rest,
                    num_returns - len(ready_set), timeout, fetch_local,
                    timeout=None))
        else:
            # some requested oids are still-running direct tasks this
            # worker owns: event-driven rounds over both sources (direct
            # completions set the event; cluster seals covered by the
            # bounded head round)
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            ev = threading.Event()
            self.direct.add_waiter(ev)
            try:
                while True:
                    ready_set = set(self.direct.ready_subset(oids))
                    pending = self.direct.pending_oids(oids)
                    rest = [o for o in oids if o not in ready_set
                            and o not in pending]
                    if rest and len(ready_set) < num_returns:
                        ready_set |= set(self.rpc.call(
                            "store", "wait", rest,
                            num_returns - len(ready_set), 0.0, fetch_local,
                            timeout=None))
                    if len(ready_set) >= num_returns:
                        break
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        break
                    ev.wait(0.2 if remaining is None
                            else min(0.2, remaining))
                    ev.clear()
            finally:
                self.direct.remove_waiter(ev)
        ready = [r for r in refs if r.id in ready_set][:num_returns]
        chosen = {r.id for r in ready}
        not_ready = [r for r in refs if r.id not in chosen]
        return ready, not_ready

    def _direct_submit(self, spec: TaskSpec) -> None:
        self.channel.send("dsubmit", pickle.dumps(spec))

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        from .direct import direct_eligible

        if global_config().direct_task_enabled and direct_eligible(spec):
            spec.owner_is_driver = False
            ready = self.direct.register(spec)
            if ready is not None:  # else: dep resolver submits it later
                self._direct_submit(ready)
        else:
            self.rpc.call("rpc", "submit_task", pickle.dumps(spec))
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        ref_tracker.annotate_many(
            spec.return_ids(),
            ref_tracker.KIND_ACTOR_RETURN if spec.actor_id is not None
            else ref_tracker.KIND_TASK_RETURN,
            creator=spec.function_name)
        return refs

    def register_function(self, function_id: str, payload: bytes) -> None:
        self.rpc.call("rpc", "register_function", function_id, payload)

    def get_function(self, function_id: str):
        if function_id not in self._fn_cache:
            payload = self.rpc.call("rpc", "get_function", function_id)
            if payload is None:
                raise RuntimeError(f"function {function_id} not found in GCS")
            self._fn_cache[function_id] = pickle.loads(payload)
        return self._fn_cache[function_id]

    def get_actor_info(self, name: str, namespace: str):
        return self.rpc.call("rpc", "get_named_actor", name, namespace)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.rpc.call("rpc", "kill_actor", actor_id, no_restart)

    def cancel_task(self, oid: ObjectID, force: bool = False):
        if self.direct.cancel(oid):
            # owner-side mark + node-side dequeue/interrupt
            self.channel.send("dcancel", oid.task_id(), force)
            return
        self.rpc.call("rpc", "cancel_task", oid, force)

    def kv(self, op: str, *args):
        return self.rpc.call("rpc", "kv", op, *args)

    def object_locations(self, oids: List[ObjectID]) -> List[List[str]]:
        """Per-object holder node hexes (head directory + owned results)."""
        out = self.rpc.call("rpc", "object_locations", list(oids))
        self.direct.fill_result_locations(oids, out)
        return out

    def next_task_id(self) -> TaskID:
        return TaskID.from_random()

    # reference counting: workers batch releases to the owner (head);
    # the local ref tracker still counts live handles so this process's
    # local/borrow table exports to the cluster memory view
    def add_local_ref(self, oid: ObjectID) -> None:
        ref_tracker.incref(oid)

    def remove_local_ref(self, oid: ObjectID) -> None:
        ref_tracker.decref(oid)
        self.direct.drop(oid)

    def add_borrow_ref(self, oid: ObjectID) -> None:
        pass

    def runtime_context(self) -> dict:
        tid = getattr(self._current_task, "task_id", None)
        aid = getattr(self._current_task, "actor_id", None)
        return {
            "job_id": self.job_id,
            "node_id": self.node_hex,
            "node_ip": self.node_ip,
            "worker_id": self.worker_id,
            "task_id": tid,
            "actor_id": aid,
            "accelerator_ids": dict(self.accelerator_binding),
            "mode": "WORKER",
        }

    def available_resources(self):
        return self.rpc.call("rpc", "available_resources")

    def cluster_resources(self):
        return self.rpc.call("rpc", "cluster_resources")

    def nodes(self):
        return self.rpc.call("rpc", "nodes")

    def actor_method_call(self, spec: TaskSpec) -> List[ObjectRef]:
        cfg = global_config()
        if (cfg.direct_task_enabled and cfg.direct_actor_enabled
                and self.direct_actors.try_submit(spec)):
            refs = [ObjectRef(oid) for oid in spec.return_ids()]
            ref_tracker.annotate_many(spec.return_ids(),
                                      ref_tracker.KIND_ACTOR_RETURN,
                                      creator=spec.function_name)
            return refs
        # direct path disabled by config (a whole-session toggle, so
        # every call to every actor takes the same path and per-caller
        # ordering is structural): head path
        return self.submit_task(spec)

    def create_placement_group(self, bundles, strategy, name=""):
        return self.rpc.call("rpc", "create_placement_group", bundles, strategy, name)

    def placement_group_op(self, op, *args):
        return self.rpc.call("rpc", "pg_" + op, *args)

    # --------------------------------------------------------------- storage

    def _store_object(self, oid: ObjectID, sobj: serialization.SerializedObject,
                      is_error: bool) -> None:
        cfg = global_config()
        size = sobj.total_bytes
        if size <= cfg.max_direct_call_object_size:
            self.rpc.call("store", "put_inline", oid, sobj.to_bytes(), is_error)
        else:
            offset = self.rpc.call("store", "create", oid, size)
            view = self.arena.view(offset, size)
            # writev-style: source buffers pack straight into shared memory
            sobj.write_into_view(view)
            self.rpc.call("store", "seal", oid, is_error)

    # --------------------------------------------------------------- serve

    def serve_forever(self) -> None:
        try:
            while not self._shutdown.is_set():
                try:
                    tag, payload = self.channel.recv()
                except (EOFError, OSError):
                    break
                if tag == "rep":
                    self.rpc.handle_reply(*payload)
                elif tag == "ddone":
                    # direct-task completion (may resubmit a retry inline)
                    task_id, err_name, results, exec_hex = payload
                    self.direct.complete(task_id, err_name, results,
                                         exec_hex)
                elif tag == "dstream":
                    # stream-item announcement for a direct task this
                    # worker owns (FIFO with its ddone on this channel)
                    task_id, index, data, exec_hex = payload
                    self.direct.on_stream_item(task_id, index, data,
                                               exec_hex)
                elif tag == "ssub":
                    # a remote consumer subscribed to a stream this worker
                    # owns. Steady state (item already buffered) answers
                    # INLINE — a zero-timeout probe off the reader thread
                    # costs one lock hop; only a round that would PARK
                    # (next item not produced yet) gets its own thread.
                    req_id, task_id, index, sub_t = payload
                    try:
                        rep = self.direct.stream_next_remote(
                            task_id, index, 0)
                    except Exception:
                        rep = None
                    if rep is not None and rep[0] != "wait":
                        self.channel.send("srep", req_id, rep)
                    elif rep is None:
                        self.channel.send(
                            "srep", req_id,
                            ("gone", "not the stream owner"))
                    else:
                        threading.Thread(
                            target=self._serve_stream_sub, args=payload,
                            daemon=True, name="ssub").start()
                elif tag == "exec":
                    spec: TaskSpec = pickle.loads(payload[0])
                    binding = payload[1]
                    self._dispatch_exec(spec, binding)
                elif tag == "cancel":
                    self._cancelled.add(payload[0])
                elif tag == "stack":
                    # cluster stack dump: sampling blocks for the dump
                    # duration, so it runs off the reader thread and
                    # replies one-way (the node's collector has a
                    # deadline; a dead worker's slot is failed there)
                    threading.Thread(
                        target=self._reply_stacks, args=payload,
                        daemon=True, name="stack-dump").start()
                elif tag == "node_ip":
                    # node learned its routable IP after this worker
                    # registered (head-node prestart race)
                    self.node_ip = payload[0]
                elif tag == "unstage":
                    # node reclaims a staged-but-unstarted task (another
                    # worker went idle); only possible pre-execution, so
                    # requeueing it elsewhere never duplicates side effects
                    tid = payload[0]
                    fut = self._staged.get(tid)
                    if fut is not None and fut.cancel():
                        self._staged.pop(tid, None)
                        self.channel.send("unstaged", tid)
                elif tag == "shutdown":
                    break
        finally:
            self._shutdown.set()
            # explicit resource teardown (os._exit skips everything):
            # actor pools/loops first, then the shared task pool
            for st in list(self._actors.values()):
                try:
                    st.stop()
                except Exception:
                    pass
            self._task_pool.shutdown(wait=False)
            dump = getattr(self, "_profile_dump", None)
            if dump is not None:
                dump()  # os._exit skips atexit
            # buffered observability (span batches, deferred serve
            # bookkeeping) flushes from daemon threads that os._exit
            # kills — drain what's queued so a replica's final requests
            # keep their spans and access-log lines. Only if the modules
            # are already loaded; never import on the exit path.
            try:
                tr = sys.modules.get("ray_tpu_torch.util.tracing")
                if tr is not None:
                    tr._flush_spans()
                so = sys.modules.get("ray_tpu_torch.serve.observability")
                if so is not None:
                    so.flush_all()
                # final flight-recorder drain: the periodic span report
                # thread dies with os._exit, so push the tail now
                pl = _fr.drain()
                if pl is not None:
                    self.channel.send("spans", pl)
            except Exception:
                pass
            os._exit(0)

    def _dispatch_exec(self, spec: TaskSpec, binding: Dict[str, List[int]]) -> None:
        if spec.actor_id is not None and not spec.is_actor_creation:
            st = self._actors.get(spec.actor_id)
            if st is None:
                self._send_error(spec, RuntimeError("actor instance not found"))
                return
            fn_name = spec.function_name.rsplit(".", 1)[-1]
            method = getattr(type(st.instance), fn_name, None)
            if st.is_async and method is not None and asyncio.iscoroutinefunction(method):
                fut = asyncio.run_coroutine_threadsafe(
                    self._execute_async(spec, st), st.loop
                )
                fut.add_done_callback(lambda f: f.exception())
            else:
                st.pool.submit(self._execute, spec, binding)
        else:
            fut = self._task_pool.submit(self._execute, spec, binding)
            self._staged[spec.task_id] = fut
            fut.add_done_callback(
                lambda _f, tid=spec.task_id: self._staged.pop(tid, None))

    async def _execute_async(self, spec: TaskSpec, st: _ActorState) -> None:
        span_cm = None
        try:
            if spec.task_id in self._cancelled:
                raise TaskCancelledError(f"task {spec.task_id.hex()} cancelled")
            if spec.trace_ctx is not None:
                from ray_tpu_torch.util.tracing import task_span

                span_cm = task_span(spec)
                if span_cm is not None:
                    span_cm.__enter__()
            args, kwargs = self._resolve_args(spec)
            fn_name = spec.function_name.rsplit(".", 1)[-1]
            method = getattr(st.instance, fn_name)
            self._current_task.task_id = spec.task_id
            self._current_task.actor_id = spec.actor_id
            self._current_task.name = spec.function_name
            result = await method(*args, **kwargs)
            self._finish(spec, result)
        except Exception as e:  # noqa: BLE001
            self._send_error(spec, e)
        finally:
            if span_cm is not None:
                span_cm.__exit__(None, None, None)
            self._current_task.task_id = None
            self._current_task.actor_id = None
            self._current_task.name = None

    def _compiled_setup(self, desc: dict) -> dict:
        """Phase A of a cross-node compiled-graph install: create the
        NetRing reader endpoints this process owns (the READING side
        holds the receive ring) and return the dial-in for this
        process's ring host so producing processes can connect."""
        from ray_tpu_torch.core import net_ring

        for spec in desc.get("rings", ()):
            net_ring.create_reader(spec["ring"], spec["n_slots"],
                                   spec["capacity"],
                                   advertise_ip=self.node_ip)
        host = net_ring.ensure_host(self.node_ip)
        return {"addr": list(host.address), "key": host.authkey.hex()}

    def _open_compiled_chan(self, d, capacity: int):
        """Open one compiled-graph edge from its descriptor: a /dev/shm
        ring path, a locally-created net reader (Phase A), or a net
        writer dialing a remote ring host."""
        from ray_tpu_torch.core import net_ring
        from ray_tpu_torch.experimental.channel import ShmChannel

        if isinstance(d, str):
            return ShmChannel(d, capacity)
        kind = d[0]
        if kind == "shm":
            return ShmChannel(d[1], capacity)
        if kind == "netr":
            reader = net_ring.ensure_host(self.node_ip).get(d[1])
            if reader is None:
                raise RuntimeError(
                    f"net ring {d[1]} was not set up in this process")
            return reader
        if kind == "netw":
            _, host, port, key, ring_id, n_slots = d
            return net_ring.NetRingWriter.connect(
                (host, port), bytes.fromhex(key), ring_id, n_slots,
                capacity)
        raise ValueError(f"unknown channel descriptor {d!r}")

    def _start_compiled_exec(self, st: _ActorState, desc: dict) -> None:
        ins = [self._open_compiled_chan(p, desc["capacity"])
               for p in desc["in_paths"]]
        outs = [self._open_compiled_chan(p, desc["capacity"])
                for p in desc["out_paths"]]
        method = getattr(st.instance, desc["method"])
        template = list(desc.get("args_template") or [("edge", 0)])
        device = bool(desc.get("device"))
        priority = int(desc.get("priority") or 0)
        batch_max = int(desc.get("batch_max") or 0)
        direct_call = bool(desc.get("direct_call"))
        stream_replies = bool(desc.get("stream_replies"))
        # backlog visibility hook (serve replicas): the instance can see
        # its own in-edge occupancy, so queued-in-ring requests count in
        # load signals (autoscaling) the same way eager in-flight does
        hook = getattr(st.instance, "__compiled_channels_hook__", None)
        if hook is not None:
            try:
                hook(desc["uid"], ins)
            except Exception:
                hook = None

        from ray_tpu_torch.experimental.channel import TAG_STOP

        def close_all():
            if hook is not None:
                try:
                    hook(desc["uid"], None)
                except Exception:
                    pass
            for ch in ins + outs:
                ch.close()

        def propagate(tag, payload=b""):
            # STOP is best-effort/bounded (teardown); ERROR must NEVER be
            # dropped — a missing message desyncs the downstream join's
            # lockstep rounds forever
            for ch in outs:
                try:
                    ch.write(payload, tag=tag,
                             timeout=10.0 if tag == TAG_STOP else None)
                except Exception:
                    pass

        def loop():
            try:
                self._compiled_exec_loop(ins, outs, propagate, st, method,
                                         template, device, priority,
                                         batch_max, direct_call,
                                         stream_replies)
            finally:
                close_all()

        threading.Thread(target=loop, daemon=True,
                         name=f"compiled-exec-{desc['method']}").start()

    def _compiled_exec_loop(self, ins, outs, propagate, st, method,
                            template, device, priority=0, batch_max=0,
                            direct_call=False, stream_replies=False) -> None:
        from ray_tpu_torch.experimental.channel import (
            TAG_BYTES,
            TAG_ERROR,
            TAG_STOP,
            TAG_TENSOR,
            BatchItemError,
            ChannelClosed,
        )

        method_name = getattr(method, "__name__", "compiled")

        def invoke(args):
            """One method call on the right execution surface. The
            ``dag.exec[.<fn>]`` chaos point fires first (crash = the
            replica-death drill for the compiled serve plane)."""
            fault_injection.fire("dag.exec", method_name)
            _t0 = _fr.now()
            try:
                return _invoke_inner(args)
            finally:
                _sp_dag_exec.end(_t0, method_name)

        def _invoke_inner(args):
            if direct_call:
                # opt-in per node: no pool handoff, no exec lock — the
                # method declares itself safe against the actor's eager
                # plane (serve replicas run sync methods concurrently
                # on the eager plane already)
                return method(*args)
            # run on the actor's executor so compiled executions
            # serialize with eager .remote() calls on the same
            # instance (the single-threaded actor contract);
            # async methods go through the actor's event loop
            if st.is_async and asyncio.iscoroutinefunction(method):
                return asyncio.run_coroutine_threadsafe(
                    method(*args), st.loop).result()
            if st.exec_lock is not None:
                # serial-actor fast path: direct call on this loop's
                # thread, mutually excluded with eager calls. The
                # contract is one-method-at-a-time, NOT
                # one-thread-forever: compiled executions run here,
                # not on the pool thread (reference: do_exec_tasks
                # loops own their thread too).
                # Priority (the 1F1B scheduling rule): when a
                # higher-priority loop on this actor has an input
                # ready (backward microbatch), lower-priority loops
                # (forward) yield the actor to it instead of racing
                # for the lock — backward-over-forward is what keeps
                # the pipeline's activation window at K instead of
                # growing with the microbatch count.
                if priority > 0:
                    st.prio_waiting.append(1)
                    try:
                        with st.exec_lock:
                            return method(*args)
                    finally:
                        st.prio_waiting.pop()
                        with st.prio_cv:
                            st.prio_cv.notify_all()
                # park (never poll) while a backward holds the
                # actor; bounded waits make a missed notify
                # harmless. Advisory ordering: the re-check
                # races a backward arriving right after, which
                # only costs one forward running first.
                while st.prio_waiting:
                    with st.prio_cv:
                        if st.prio_waiting:
                            st.prio_cv.wait(0.05)
                with st.exec_lock:
                    return method(*args)
            return st.pool.submit(method, *args).result()

        def write_value(result):
            if device and _is_arraylike(result):
                for ch in outs:
                    ch.write_array(result)
            elif type(result) is bytes:
                # raw-bytes results skip the serializer both ways
                for ch in outs:
                    ch.write(result, tag=TAG_BYTES)
            else:
                sobj = serialization.serialize(result)
                for ch in outs:
                    ch.write_serialized(sobj)

        def error_payload(exc) -> bytes:
            err = TaskError.from_exception(method_name, exc)
            return serialization.serialize(err).to_bytes()

        # stream-reply mode (with_stream_batching): iteration-level
        # continuous batching with many TAG_STREAM frames per request
        if stream_replies and len(ins) == 1:
            self._compiled_stream_loop(ins[0], outs, propagate, invoke,
                                       error_payload, max(1, batch_max),
                                       device, method_name)
            return

        # batch_max >= 1 means the node DECLARED the list-in/list-out
        # contract (with_batching) — it applies even at window 1
        if batch_max >= 1 and len(ins) == 1:
            self._compiled_batch_loop(ins[0], propagate, invoke,
                                      write_value, error_payload,
                                      batch_max, device, BatchItemError,
                                      method_name)
            return

        while True:
            # one message per in-edge per execution (per-round joins;
            # reference: per-execution index across CompiledTasks). With
            # ring channels up to max_inflight rounds queue per edge, so
            # this loop pipelines against its up/downstream stages.
            edge_vals = []
            failed = None
            for ch in ins:
                try:
                    tag, payload = ch.read(timeout=None)
                except ChannelClosed:
                    propagate(TAG_STOP)
                    return
                except Exception:
                    return  # channel unlinked (teardown race)
                if tag == TAG_ERROR:
                    failed = payload  # upstream error passes through
                elif tag == TAG_TENSOR or tag == TAG_BYTES:
                    edge_vals.append(payload)  # typed/raw: no serializer
                else:
                    edge_vals.append(serialization.deserialize(payload))
            if failed is not None:
                propagate(TAG_ERROR, failed)
                continue
            try:
                args = [edge_vals[t[1]] if t[0] == "edge" else t[1]
                        for t in template]
                write_value(invoke(args))
            except Exception as e:  # noqa: BLE001 — ship to consumer
                propagate(TAG_ERROR, error_payload(e))

    def _compiled_batch_loop(self, ch, propagate, invoke, write_value,
                             error_payload, batch_max, device,
                             BatchItemError, method_name="batch") -> None:
        """Ring-fed batch rounds (serve continuous batching): block for
        the first message, then admit everything ALREADY queued in the
        ring — up to ``batch_max`` — into the same method call. Requests
        that arrive while a batch executes are queued by the ring and
        form the next batch, so under load batches fill with zero added
        wait and when idle a single request runs immediately: the
        admission window replaces the ``max_batch_wait`` timer. One
        reply per item, in order; a BatchItemError result fails one
        item without failing its batch-mates."""
        from ray_tpu_torch.experimental.channel import (
            TAG_BYTES,
            TAG_ERROR,
            TAG_STOP,
            TAG_TENSOR,
            ChannelClosed,
        )

        while True:
            entries = []  # ("val", value) | ("err", payload passthrough)
            stop = False
            _t0 = 0.0  # span starts at the FIRST admitted message: idle
            #            park time before a round is not drain time
            while len(entries) < batch_max:
                if entries:
                    try:
                        if not ch.readable():
                            break  # batch = exactly the queued backlog
                    except Exception:
                        return  # channel closed (teardown race)
                try:
                    tag, payload = ch.read(timeout=None)
                except ChannelClosed:
                    stop = True
                    break
                except Exception:
                    return  # channel unlinked (teardown race)
                if not _t0:
                    _t0 = _fr.now()
                if tag == TAG_ERROR:
                    entries.append(("err", payload))
                elif tag == TAG_TENSOR or tag == TAG_BYTES:
                    entries.append(("val", payload))
                else:
                    entries.append(("val",
                                    serialization.deserialize(payload)))
            vals = [v for kind, v in entries if kind == "val"]
            results = []
            if vals:
                try:
                    results = invoke([vals])
                    if not isinstance(results, (list, tuple)) \
                            or len(results) != len(vals):
                        raise TypeError(
                            f"batch method returned "
                            f"{type(results).__name__} of length "
                            f"{len(results) if isinstance(results, (list, tuple)) else 'n/a'} "
                            f"for {len(vals)} inputs")
                except Exception as e:  # noqa: BLE001 — fail every item
                    pl = error_payload(e)
                    results = [_BatchErrPayload(pl)] * len(vals)
            # replies in arrival order: upstream-error passthroughs keep
            # their slot, values take the next computed result
            vi = 0
            for kind, v in entries:
                if kind == "err":
                    propagate(TAG_ERROR, v)
                    continue
                r = results[vi]
                vi += 1
                if isinstance(r, _BatchErrPayload):
                    propagate(TAG_ERROR, r.payload)
                elif isinstance(r, BatchItemError):
                    propagate(TAG_ERROR, error_payload(r.error))
                else:
                    try:
                        write_value(r)
                    except Exception as e:  # unserializable result etc.
                        propagate(TAG_ERROR, error_payload(e))
            _sp_batch_drain.end(_t0, method_name)
            if stop:
                propagate(TAG_STOP)
                return

    def _compiled_stream_loop(self, ch, outs, propagate, invoke,
                              error_payload, batch_max, device,
                              method_name="stream") -> None:
        """Iteration-level continuous batching (the Orca/vLLM admission
        model): the method owns a RUNNING batch of multi-step requests.
        Each round drains newly-arrived requests from the ring backlog —
        BETWEEN model steps, not at batch boundaries — and calls the
        method once with the new ``(corr, value)`` pairs (possibly none
        while a batch is still decoding). The method returns
        ``(replies, active)``: replies are ``(corr, kind, payload)``
        frames shipped back as TAG_STREAM slots (kind "chunk" | "final"
        | "error" — one request answers with MANY frames over its
        lifetime), and ``active`` asks for an immediate re-invoke (a
        decode step is pending) instead of parking for input.

        Correlation needs no input framing: the lane in-edge is SPSC and
        the driver assigns execution seqs in ring-write order under its
        submit lock, so the arrival counter here IS the driver seq."""
        from ray_tpu_torch.experimental.channel import (
            STREAM_F_ERROR,
            STREAM_F_FINAL,
            STREAM_F_RAW,
            TAG_BYTES,
            TAG_ERROR,
            TAG_STOP,
            TAG_STREAM,
            TAG_TENSOR,
            ChannelClosed,
            pack_stream_frame,
        )

        def send(corr, flags, payload: bytes) -> None:
            frame = pack_stream_frame(corr, flags, payload)
            for out in outs:
                try:
                    out.write(frame, tag=TAG_STREAM)
                except Exception:
                    pass  # ring closed (teardown race)

        corr_counter = 0
        active = False
        while True:
            entries = []      # (corr, value) newly admitted this round
            stop = False
            while len(entries) < batch_max:
                if entries or active:
                    # a batch is running (or this round already admitted
                    # work): take only what is ALREADY queued — never
                    # stall a pending decode step waiting for arrivals
                    try:
                        if not ch.readable():
                            break
                    except Exception:
                        return  # channel closed (teardown race)
                try:
                    tag, payload = ch.read(timeout=None)
                except ChannelClosed:
                    stop = True
                    break
                except Exception:
                    return  # channel unlinked (teardown race)
                corr = corr_counter
                corr_counter += 1
                if tag == TAG_ERROR:
                    # upstream error passthrough: the request dies before
                    # admission, but its stream must still complete
                    send(corr, STREAM_F_FINAL | STREAM_F_ERROR, payload)
                elif tag == TAG_TENSOR or tag == TAG_BYTES:
                    entries.append((corr, payload))
                else:
                    entries.append((corr,
                                    serialization.deserialize(payload)))
            if stop and not active and not entries:
                propagate(TAG_STOP)
                return
            try:
                replies, active = invoke([entries])
            except Exception as e:  # noqa: BLE001 — ship to consumers
                # scheduler-step failure: fail the requests admitted THIS
                # round (the method owns bookkeeping for older ones, and
                # a dead process is handled by the driver's FSM probe)
                pl = error_payload(e)
                for corr, _ in entries:
                    send(corr, STREAM_F_FINAL | STREAM_F_ERROR, pl)
                replies, active = [], False
            for corr, kind, payload in replies:
                if kind == "error":
                    send(corr, STREAM_F_FINAL | STREAM_F_ERROR,
                         error_payload(payload))
                    continue
                flags = STREAM_F_FINAL if kind == "final" else 0
                if type(payload) is bytes:
                    flags |= STREAM_F_RAW
                else:
                    payload = serialization.serialize(payload).to_bytes()
                send(corr, flags, payload)
            if stop:
                propagate(TAG_STOP)
                return

    def _resolve_args(self, spec: TaskSpec):
        hints = spec.arg_hints or {}

        def resolve(v):
            kind, payload = v
            if kind == "ref":
                hint = hints.get(payload)
                if hint is not None and hint[0] == "inline":
                    # owner shipped the (small) arg bytes with the spec —
                    # no store round-trip at all
                    value = serialization.deserialize(hint[1])
                    if hint[2]:
                        raise value
                    return value
                node_hint = hint[1] if hint is not None else None
                return self._get_one(payload, None, node_hint)
            return serialization.deserialize(payload)

        args = [resolve(a) for a in spec.args]
        kwargs = {k: resolve(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    def _execute(self, spec: TaskSpec, binding: Dict[str, List[int]]) -> None:
        restore_env = lambda: None  # noqa: E731
        span_cm = None
        try:
            if spec.task_id in self._cancelled:
                raise TaskCancelledError(f"task {spec.task_id.hex()} cancelled")
            # chaos point: "worker.exec[.<fn>]=crash@N" hard-kills this
            # worker before user code runs; raise/delay surface inline
            fault_injection.fire("worker.exec",
                                 spec.function_name.rsplit(".", 1)[-1])
            if spec.trace_ctx is not None:
                # child span joins the caller's trace (reference:
                # tracing_helper.py context propagation)
                from ray_tpu_torch.util.tracing import task_span

                span_cm = task_span(spec)
                if span_cm is not None:
                    span_cm.__enter__()
            if binding:
                self._apply_accelerator_binding(binding)
            if spec.runtime_env:
                from .runtime_env import apply_runtime_env

                restore = apply_runtime_env(spec.runtime_env, self)
                # actor-creation envs persist for the actor's lifetime
                # (the worker is dedicated) — but only once the creation
                # SUCCEEDS; a failed creation returns this worker to the
                # shared pool, so its env must roll back. Plain-task envs
                # always restore.
                restore_env = restore
            args, kwargs = self._resolve_args(spec)
            self._current_task.task_id = spec.task_id
            self._current_task.actor_id = spec.actor_id
            self._current_task.name = spec.function_name
            if spec.is_actor_creation:
                cls = self.get_function(spec.function_id)
                instance = cls(*args, **kwargs)
                self._actors[spec.actor_id] = _ActorState(
                    instance, spec.actor_max_concurrency, spec.actor_is_async
                )
                restore_env = lambda: None  # noqa: E731 — creation OK:
                # the env persists for the actor's lifetime
                self._finish(spec, None)
            elif spec.actor_id is not None:
                st = self._actors[spec.actor_id]
                fn_name = spec.function_name.rsplit(".", 1)[-1]
                if fn_name == "__ray_terminate__":
                    self._finish(spec, None)
                    self.channel.send("exit")
                    time.sleep(0.2)
                    os._exit(0)
                if fn_name == "__compiled_exec__":
                    # install a resident compiled-graph executor thread
                    # (reference: compiled_dag_node.py do_exec_tasks :92)
                    self._start_compiled_exec(st, args[0])
                    self._finish(spec, None)
                    return
                if fn_name == "__compiled_setup__":
                    # Phase A of a cross-node compile: create this
                    # process's net-ring reader endpoints, return the
                    # ring-host dial-in for the producing processes
                    self._finish(spec, self._compiled_setup(args[0]))
                    return
                if fn_name == "__compiled_poison__":
                    # death-path broadcast: fail the local net readers
                    # under the DAG uid so loops parked on a dead peer's
                    # ring pop with ChannelClosed
                    from ray_tpu_torch.core import net_ring

                    self._finish(spec, net_ring.poison_rings(args[0]))
                    return
                if fn_name == "__collective_init__":
                    # runtime-level hook so any actor can join a collective
                    # group without declaring a method (reference:
                    # create_collective_group's declarative setup)
                    from ray_tpu_torch.collective import init_collective_group

                    init_collective_group(*args, **kwargs)
                    self._finish(spec, None)
                    return
                method = getattr(st.instance, fn_name)
                if st.exec_lock is not None:
                    # serialize with compiled-graph direct calls (the
                    # pool alone no longer owns all method executions)
                    with st.exec_lock:
                        result = method(*args, **kwargs)
                else:
                    result = method(*args, **kwargs)
                self._finish(spec, result)
            else:
                fn = self.get_function(spec.function_id)
                result = fn(*args, **kwargs)
                self._finish(spec, result)
        except Exception as e:  # noqa: BLE001
            self._send_error(spec, e)
        finally:
            if span_cm is not None:
                span_cm.__exit__(None, None, None)
            restore_env()
            self._current_task.task_id = None
            self._current_task.actor_id = None
            self._current_task.name = None

    def _apply_accelerator_binding(self, binding: Dict[str, List[int]]) -> None:
        """Set accelerator visibility env vars before user code opens a card.

        Reference: accelerators/tpu.py:155-195 sets TPU_VISIBLE_CHIPS etc;
        nvidia_gpu.py sets CUDA_VISIBLE_DEVICES. The GPU binding ASSIGNS
        the variable, each slot mapped through the list this worker
        inherited (a driver started under CUDA_VISIBLE_DEVICES=0,1,2,3
        hands its list to every worker; keeping it would put every rank
        on card 0). A process that already holds a CUDA context cannot
        move to other cards, so such a rebinding raises.
        """
        self.accelerator_binding = binding
        if "TPU" in binding and "jax" not in sys.modules:
            chips = ",".join(str(i) for i in binding["TPU"])
            os.environ.setdefault("TPU_VISIBLE_CHIPS", chips)
        if "GPU" in binding:
            from .accelerators import bind_gpus, cuda_initialized

            cards = bind_gpus(binding["GPU"], self._inherited_gpus)
            if cuda_initialized() \
                    and os.environ.get("CUDA_VISIBLE_DEVICES") != cards:
                raise RuntimeError(
                    f"this worker already opened CUDA_VISIBLE_DEVICES="
                    f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r} and cannot "
                    f"move to {cards!r}")
            os.environ["CUDA_VISIBLE_DEVICES"] = cards

    def _finish(self, spec: TaskSpec, result: Any) -> None:
        if spec.streaming:
            self._finish_streaming(spec, result)
            return
        rids = spec.return_ids()
        if spec.num_returns == 1:
            values = [result]
        elif spec.num_returns == 0:
            values = []
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                self._send_error(
                    spec,
                    ValueError(
                        f"task returned {len(values)} values, expected {spec.num_returns}"
                    ),
                )
                return
        results = []
        cfg = global_config()
        for oid, val in zip(rids, values):
            sobj = serialization.serialize(val)
            if sobj.total_bytes <= cfg.max_direct_call_object_size:
                results.append((oid, sobj.to_bytes(), False))
            else:
                offset = self.rpc.call("store", "create", oid, sobj.total_bytes)
                view = self.arena.view(offset, sobj.total_bytes)
                sobj.write_into_view(view)
                self.rpc.call("store", "seal", oid, False)
                results.append((oid, None, False))
        self.channel.send("done", spec.task_id, results, None)

    def _finish_streaming(self, spec: TaskSpec, result: Any) -> None:
        """Iterate a generator task: each yield becomes one "stream" item
        announcement to the node, which routes it to the OWNER over the
        direct reply chain (or to the head for head-path tasks). Small
        items ride inline in the announcement; large ones seal into the
        store first (the blocking seal rpc returning before the send keeps
        store-before-announce ordering). The primary return carries the
        final item count (reference: streaming generators,
        _raylet.pyx:1074-1317)."""
        from .ids import ObjectID as _OID

        cfg = global_config()
        count = 0
        try:
            if result is not None and hasattr(result, "__iter__"):
                for item in result:
                    sobj = serialization.serialize(item)
                    if sobj.total_bytes <= cfg.max_direct_call_object_size:
                        self.channel.send("stream", spec.task_id, count,
                                          sobj.to_bytes())
                    else:
                        oid = _OID.for_stream(spec.task_id, count)
                        self._store_object(oid, sobj, is_error=False)
                        self.channel.send("stream", spec.task_id, count,
                                          None)
                    count += 1
        except Exception as e:  # mid-stream user error
            self._send_error(spec, e)
            return
        spec.streaming = False  # primary return is a normal value now
        self._finish(spec, count)

    def stream_next(self, task_id, index: int, timeout=None, owner=None):
        # owner-side stream buffer first (direct-path streams this worker
        # owns); then the stream's owner route (subscribe straight to the
        # owning process over the node/peer reply channels); the head
        # only serves streams it actually records (head-path tasks)
        rep = self.direct.stream_next(task_id, index, timeout)
        if rep is not None:
            return rep
        if owner is not None:
            return self._stream_sub_rounds(owner, task_id, index, timeout)
        return self.rpc.call("rpc", "stream_next", task_id, index, timeout)

    def _stream_sub_rounds(self, owner, task_id, index: int,
                           timeout: Optional[float]):
        from .direct import bounded_sub_rounds

        return bounded_sub_rounds(
            lambda t: self.rpc.call("rpc", "stream_sub", owner, task_id,
                                    index, t, timeout=None), timeout)

    def stream_owner_route(self):
        """This process's stream-owner address, stamped into serialized
        generator handles so consumers subscribe here directly."""
        return ("w", self.node_hex, self.worker_id)

    def publish_stream(self, task_id) -> bool:
        # generator handle serialized out of this process (object_ref):
        # True = we own it and will serve subscribers
        return self.direct.publish_stream(task_id)

    def _serve_stream_sub(self, req_id: int, task_id, index: int,
                          timeout) -> None:
        """Owner side of one stream_sub round: read from this worker's
        own stream table and reply over the node channel ("srep")."""
        try:
            rep = self.direct.stream_next_remote(task_id, index, timeout)
        except Exception:
            rep = None
        if rep is None:
            rep = ("gone", "not the stream owner")
        try:
            self.channel.send("srep", req_id, rep)
        except (OSError, EOFError):
            pass  # node gone: the subscriber's round times out

    def _reply_stacks(self, req_id: int, duration_ms: int) -> None:
        """One bounded self-sample for the cluster stack dump, replied
        one-way over the node channel ("stack_rep")."""
        from ray_tpu_torch.util import sampling_profiler

        try:
            text = sampling_profiler.collect_stacks(
                max(0.0, duration_ms / 1000.0))
        except Exception:
            text = ""  # sampler failure still replies (empty dump)
        try:
            self.channel.send("stack_rep", req_id, text)
        except (OSError, EOFError):
            pass  # node gone: the collector's deadline covers it

    def _send_error(self, spec: TaskSpec, exc: Exception) -> None:
        if isinstance(exc, TaskError):
            err = exc
        else:
            err = TaskError.from_exception(spec.function_name, exc)
        payload = serialization.serialize(err).to_bytes()
        results = [(oid, payload, True) for oid in spec.return_ids()]
        self.channel.send("done", spec.task_id, results,
                          type(exc).__name__)


def worker_main(argv=None) -> None:
    # SIGUSR1 -> all-thread dump to stderr (lands in the worker log file);
    # the debugging hook for wedged workers (reference: ray stack)
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)
    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True)
    parser.add_argument("--authkey", required=True)
    args = parser.parse_args(argv)
    # Transient refusals are normal when prestarted workers race the
    # node's accept handshake — retry with backoff before giving up. A
    # MISSING socket means the node is gone: exit quietly at once.
    channel = None
    deadline = time.monotonic() + 15.0
    delay = 0.05
    while True:
        try:
            channel = connect(args.address, bytes.fromhex(args.authkey))
            break
        except FileNotFoundError:
            sys.exit(0)  # node shut down before we started
        except (OSError, EOFError, Exception) as e:
            retriable = isinstance(e, (ConnectionError, EOFError, OSError))
            if retriable and time.monotonic() < deadline:
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
                continue
            if "Authentication" in type(e).__name__ or retriable:
                sys.exit(0)  # node gone / cluster key rotated
            raise
    channel.send("register", os.getpid())
    tag, payload = channel.recv()
    assert tag == "init", tag
    runtime = WorkerRuntime(channel, payload[0])
    object_ref_mod.set_runtime(runtime)
    from . import runtime as runtime_mod

    runtime_mod.set_current_runtime(runtime)
    from ray_tpu_torch.util.metrics import start_report_thread

    start_report_thread(
        lambda snap: channel.send("metrics", snap),
        global_config().metrics_report_interval_ms / 1000.0)
    # flight-recorder spans ride the worker channel one-way ("spans");
    # the node stamps this worker's source id and forwards to the head
    if _fr.enabled():

        def _span_report_loop():
            period = max(
                0.25,
                global_config().flight_recorder_report_interval_ms / 1000.0)
            while True:
                time.sleep(period)
                try:
                    pl = _fr.drain()
                    if pl is not None:
                        channel.send("spans", pl)
                except Exception:
                    pass  # node gone: serve_forever exits us shortly

        threading.Thread(target=_span_report_loop, daemon=True,
                         name="flightrec-report").start()
    # ref-table reports ride the same worker channel one-way ("refs");
    # the node stamps this worker's source id and forwards to the head
    ref_tracker.start_report(
        lambda table: channel.send("refs", table),
        global_config().ref_report_interval_ms / 1000.0)
    # cluster events ride the worker channel one-way ("cevents"), same
    # shape as the metrics report; the node forwards them to the head
    from ray_tpu_torch.util import events as events_mod

    events_mod.set_sink(
        lambda evs: channel.send("cevents", evs),
        global_config().cluster_event_flush_ms / 1000.0)
    if global_config().device_telemetry_enabled:
        # the port's compile events come from ops/_build.py and the
        # program observatory: there is no import hook to install
        from ray_tpu_torch.util.device_telemetry import start_device_telemetry

        start_device_telemetry(node_hex=runtime.node_hex)
    from ray_tpu_torch.util.sampling_profiler import start_from_env

    _dump_profile = start_from_env()  # RAY_TPU_SAMPLER=<prefix> to enable
    if _dump_profile is not None:
        runtime._profile_dump = _dump_profile
    runtime.serve_forever()


if __name__ == "__main__":
    worker_main()

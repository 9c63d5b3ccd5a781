"""Compiled-graph serve dispatch plane: microsecond proxy→replica hops.
A port of ``ray_tpu/serve/compiled_dispatch.py``.

The eager handle path pays a ``remote()`` dispatch per request
(scheduler round-trip + reply channel) while the compiled-graph rings
underneath move a message with two mmap writes and at most one
doorbell. This module puts unary inference on
those rings: per replica, ONE long-lived compiled DAG ("lane") —
``InputNode -> replica.handle_request_compiled_batch -> driver`` — whose
edges are placement-resolved ring channels (shm co-located, NetRing
cross-node) compiled once at (re)configure time and reused for every
request.

Structural backpressure instead of queueing:

* ``max_inflight`` ring slots per lane are the per-replica ADMISSION
  WINDOW — a request is admitted by writing into a free slot; a full
  window is observable (``writable()``) before any work is done, so
  excess load overflows to the eager path (the bounded fallback queue)
  instead of piling into an unbounded mailbox.
* A per-deployment CONCURRENCY BUDGET caps everything this process has
  in flight (compiled + eager overflow). Once the budget is exhausted
  AND every replica window is full, new requests shed immediately with
  a typed, attributed :class:`BackPressureError` — load shedding at the
  proxy, before any replica work.

Continuous batching rides the same substrate: the replica's exec loop
drains whatever is ALREADY queued in its in-ring into one method call
(ring-fed batch mode, dag/__init__.py ``with_batching``), so under load
batches fill with zero assembly wait — the admission window replaces the
``max_batch_wait`` timer — and new requests join at the next batch
boundary instead of waiting out a timer.

Replica death never wedges a lane: the DAG's bounded reads probe the
actor FSM and fail every outstanding request with an attributed
``ActorDiedError``; a replica restarted in place
(max_restarts budget) gets fresh rings rebound transparently on the next
dispatch, and controller-replaced replicas get fresh lanes on the next
router refresh.

The eager handle path remains the fallback for: streaming requests,
handles in processes that cannot resolve placement (replica composition
inside workers, client mode), payloads larger than a ring slot, and any
lane build failure (a cooldown retries later).
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import global_config
from ray_tpu_torch.core.exceptions import ActorDiedError, RayTpuError
from ray_tpu_torch.experimental.channel import ChannelTimeout
from ray_tpu_torch.util import flight_recorder as _fr

_sp_dispatch = _fr.register_span("serve.dispatch",
                                 tag_keys=("deployment",))

logger = logging.getLogger("ray_tpu_torch.serve")


class BackPressureError(RayTpuError):
    """Request shed at the dispatching process: the deployment's
    concurrency budget is exhausted and every replica admission window
    is full. Attributed: carries the deployment, the observed in-flight
    count, the budget, and the replica window state so the caller (and
    the 503 body) can see exactly why it was refused."""

    def __init__(self, deployment: str, outstanding: int, budget: int,
                 replicas: int, window: int):
        self.deployment = deployment
        self.outstanding = outstanding
        self.budget = budget
        self.replicas = replicas
        self.window = window
        super().__init__(
            f"deployment {deployment!r} shed request: {outstanding} "
            f"in flight >= concurrency budget {budget} and all "
            f"{replicas} replica admission window(s) (max_inflight="
            f"{window}) are full")

    def __reduce__(self):
        return (type(self), (self.deployment, self.outstanding,
                             self.budget, self.replicas, self.window))


def available() -> bool:
    """Compiled dispatch needs the global switch on AND a process that
    can resolve actor placement (an in-process head — the driver). A
    worker-hosted handle (deployment composition) or a client-mode
    driver cannot lay placement-correct ring edges, so it stays on the
    eager path."""
    if not global_config().serve_compiled_dispatch:
        return False
    try:
        from ray_tpu_torch.core.runtime import get_current_runtime

        rt = get_current_runtime()
        return rt is not None and getattr(rt, "head", None) is not None
    except Exception:
        return False


def _actor_alive(actor) -> bool:
    """Quick placement probe so a lane build never parks waiting for an
    actor record (the DAG's own resolver would wait up to 30 s)."""
    try:
        from ray_tpu_torch.core.runtime import get_current_runtime

        head = get_current_runtime().head
        info = head.actor_location(actor._actor_id)
        return bool(info and info.get("state") == "ALIVE"
                    and info.get("node_hex"))
    except Exception:
        return False


class _ReplicaLane:
    """One replica's long-lived dispatch lane: a single-node compiled
    DAG with ``max_inflight`` ring slots as the admission window."""

    def __init__(self, replica, key: str, deployment: str, window: int,
                 slot_bytes: int):
        from ray_tpu_torch.dag import InputNode

        self.replica = replica
        self.key = key
        self.deployment = deployment
        self.window = window
        with InputNode() as inp:
            node = replica.handle_request_compiled_batch.bind(inp)
        # ring-fed continuous batching up to the window; direct call —
        # the serve replica's dispatch method is thread-safe against its
        # eager plane, so the pool thread handoff is pure tax
        node.with_batching(window).with_direct_call()
        self.dag = node.experimental_compile(
            buffer_size_bytes=slot_bytes, max_inflight=window)

    def can_admit(self) -> bool:
        return (self.dag.broken is None and not self.dag.torn_down
                and self.dag.inflight() < self.window
                and self.dag.input_writable())

    def try_dispatch(self, payload):
        """Admit one request: returns the CompiledDAGRef, or None when
        the window is full / the lane is (possibly transiently) broken —
        the caller then overflows to the eager path. A lane broken by a
        RESTARTABLE death still attempts execute(): that is the rebind
        path (fresh rings to the restarted incarnation)."""
        dag = self.dag
        if dag.torn_down:
            return None
        if dag.broken is None and not self.can_admit():
            return None
        try:
            # the write grace only needs to absorb a submitter race on
            # the last slot (a ring op is a few mmap accesses); anything longer turns
            # "window full" into a blocking wait at exec-time scale,
            # which is exactly what overflow-to-eager exists to avoid
            return dag.execute(payload, timeout=0.01)
        except ChannelTimeout:
            return None  # raced another submitter to the last slot
        except ValueError:
            return None  # payload exceeds the ring slot: eager carries it
        except Exception:
            return None  # dead/restarting executor: eager until rebound

    def close(self, wait: bool = False) -> None:
        if wait:
            try:
                self.dag.teardown()
            except Exception:
                pass
        else:
            self.dag.teardown_async()


class _DecodeLane:
    """One replica's generative-decode lane: a stream-reply compiled DAG
    (``with_stream_batching``) over ``handle_request_decode``. The
    replica's exec loop drains new requests from this lane's in-ring
    BETWEEN decode iterations and ships every token back as its own
    TAG_STREAM frame — iteration-level continuous batching with
    ring-lane token streaming, no per-token RPCs."""

    def __init__(self, replica, key: str, deployment: str, window: int,
                 slot_bytes: int):
        from ray_tpu_torch.dag import InputNode

        self.replica = replica
        self.key = key
        self.deployment = deployment
        self.window = window
        with InputNode() as inp:
            node = replica.handle_request_decode.bind(inp)
        node.with_stream_batching(window).with_direct_call()
        self.dag = node.experimental_compile(
            buffer_size_bytes=slot_bytes, max_inflight=window)

    def can_admit(self) -> bool:
        return (self.dag.broken is None and not self.dag.torn_down
                and self.dag.inflight() < self.window
                and self.dag.input_writable())

    def try_dispatch(self, payload):
        """Admit one decode request: returns a CompiledStreamRef, or
        None (window full / lane transiently broken) — the caller then
        falls back to the eager decode generator."""
        dag = self.dag
        if dag.torn_down:
            return None
        if dag.broken is None and not self.can_admit():
            return None
        try:
            return dag.execute_stream(payload, timeout=0.25)
        except ChannelTimeout:
            return None  # raced another submitter to the last slot
        except ValueError:
            return None  # payload exceeds the ring slot: eager carries it
        except Exception:
            return None  # dead/restarting executor: eager until rebound

    def close(self, wait: bool = False) -> None:
        if wait:
            try:
                self.dag.teardown()
            except Exception:
                pass
        else:
            self.dag.teardown_async()


class CompiledStreamResponse:
    """Iterator over one decode request's token frames on a stream lane.
    Each item is the JSON dict the replica emitted (``{"token": t, "i":
    n}`` chunks, then the ``{"done": True, ...}`` summary). A replica
    killed mid-stream surfaces as the DAG's attributed ActorDiedError
    from the iterator — there is NO mid-stream redispatch (streamed
    tokens cannot be un-sent); callers retry the whole request, and a
    retried prefill lands on a survivor's prefix cache."""

    def __init__(self, router: "CompiledRouter", lane: _DecodeLane, ref,
                 meta: Optional[dict], deployment: str,
                 item_timeout_s: Optional[float] = None):
        self._router = router
        self._lane = lane
        self._ref = ref
        self._meta = meta
        self._deployment = deployment
        self._item_timeout_s = item_timeout_s
        self._released = False
        self._recorded = False
        self.plane = "compiled_stream"

    def _release(self) -> None:
        # idempotent and lock-free (reached from generator finalization
        # in the GC — same contract as CompiledServeResponse)
        if not self._released:
            self._released = True
            self._router._release_slot()

    def _record(self, status: str) -> None:
        meta = self._meta
        if meta is None or self._recorded:
            return
        self._recorded = True
        from . import observability as obs

        e2e = max(0.0, time.time() - meta.get("ingress_ts", time.time()))
        obs.defer(obs.record_request_outcome, self._deployment,
                  meta.get("ingress", "handle"), status, e2e,
                  meta.get("handle_queue_wait_s"))

    def __iter__(self):
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.experimental.channel import (STREAM_F_ERROR,
                                                  STREAM_F_RAW)

        timeout = self._item_timeout_s or 60.0
        status = "ok"
        try:
            while True:
                try:
                    flags, body = self._ref.next(timeout=timeout)
                except StopIteration:
                    break
                except ChannelTimeout:
                    raise TimeoutError(
                        f"decode stream from {self._deployment!r}: no "
                        f"frame within {timeout}s (request still in "
                        "flight)") from None
                if flags & STREAM_F_ERROR:
                    err = serialization.deserialize(bytes(body))
                    raise err if isinstance(err, BaseException) \
                        else RuntimeError(str(err))
                if flags & STREAM_F_RAW:
                    yield json.loads(bytes(body))
                else:
                    yield serialization.deserialize(bytes(body))
        except BaseException:
            status = "error"
            raise
        finally:
            self._release()
            self._record(status)

    def __del__(self):
        try:
            self._release()
        except Exception:
            pass


class CompiledServeResponse:
    """Future-like handle for a compiled-plane request — the
    DeploymentResponse analog. ``result()`` reads the lane's output ring
    directly (the channel's hybrid spin keeps the hot path in
    microseconds; there is no pump thread to hand off through), with the
    DAG's bounded rounds turning a dead replica into an attributed
    ActorDiedError instead of a wedge. On such a death the request
    redispatches (replica-failure retry, same single deadline as the
    eager path) when the deployment allows it."""

    def __init__(self, router: "CompiledRouter", lane: _ReplicaLane, ref,
                 meta: Optional[dict], deployment: str, redispatch=None):
        self._router = router
        self._lane = lane
        self._ref = ref
        self._seq = ref._seq
        self._meta = meta
        self._deployment = deployment
        self._redispatch = redispatch
        self._delegate = None  # response from a replica-failure retry
        self._released = False
        self._recorded = False
        self._timeout_counted = False
        self.plane = "compiled"  # dispatch-plane label for the metrics
        self.timings: Optional[Dict[str, float]] = None

    # -- bookkeeping ------------------------------------------------------
    def _release(self) -> None:
        # idempotent; also reached from __del__, so it must stay
        # lock-free (deque ops only) — never acquire a lock in the GC
        if not self._released:
            self._released = True
            self._router._release_slot()

    def _record(self, status: str, timed_out: bool = False) -> None:
        meta = self._meta
        if meta is None or self._recorded:
            return
        self._recorded = True
        from . import observability as obs

        e2e = max(0.0, time.time() - meta.get("ingress_ts", time.time()))
        if status == "ok":
            self.timings = {
                "handle_queue_wait_s": meta.get("handle_queue_wait_s",
                                                0.0),
                "e2e_s": e2e,
            }
        obs.defer(obs.record_request_outcome, self._deployment,
                  meta.get("ingress", "handle"), status, e2e,
                  meta.get("handle_queue_wait_s"), timed_out)

    # -- public API -------------------------------------------------------
    @staticmethod
    def _reply_too_large(exc: BaseException) -> bool:
        """An oversized REPLY bounced off the ring slot replica-side
        (the request fit; the result did not). Matched so the retry can
        go eager-only — re-admitting onto a lane would bounce again."""
        from ray_tpu_torch.core.exceptions import TaskError

        return (isinstance(exc, TaskError)
                and "exceeds channel slot capacity" in str(exc))

    def _delegate_retry(self, err: BaseException,
                        deadline: Optional[float],
                        eager_only: bool = False) -> Any:
        try:
            self._delegate = self._redispatch(eager_only=eager_only) \
                if eager_only else self._redispatch()
        except Exception:
            self._record("error")
            raise err from None
        # the retry response records the final outcome on this
        # request's meta; this one must stay silent
        self._recorded = True
        return self._delegate.result(
            None if deadline is None
            else max(0.0, deadline - time.time()))

    def result(self, timeout: Optional[float] = None) -> Any:
        if self._delegate is not None:
            return self._delegate.result(timeout)
        deadline = None if timeout is None else time.time() + timeout
        try:
            value = self._ref.get(timeout=timeout)
        except ChannelTimeout:
            # the result may still arrive: stay in flight, re-callable
            # (mirror of the eager path's polling semantics — count
            # the timeout signal once, leave the outcome open)
            if not self._timeout_counted and self._meta is not None:
                self._timeout_counted = True
                from . import observability as obs

                obs.defer(obs.record_timeout, self._deployment)
            raise TimeoutError(
                f"serve request to {self._deployment!r} not complete "
                f"within {timeout}s (still in flight)")
        except ActorDiedError as e:
            self._release()
            if self._redispatch is not None and (
                    deadline is None or time.time() < deadline):
                return self._delegate_retry(e, deadline)
            self._record("error")
            raise
        except BaseException as e:
            self._release()
            # an oversized reply retries on the eager path (which has no
            # slot bound) — user code re-executes, so it is gated on the
            # same retry_on_replica_failure consent as death retries
            if self._redispatch is not None and self._reply_too_large(e) \
                    and (deadline is None or time.time() < deadline):
                return self._delegate_retry(e, deadline, eager_only=True)
            self._record("error")
            raise
        self._release()
        self._record("ok")
        return value

    @property
    def ref(self):
        """Compiled-plane responses carry no ObjectRef — the result
        rides a ring, not the object store."""
        return None

    def __await__(self):
        # cooperative wait for async callers: poll readiness, then
        # collect (rarely used — composition inside replicas rides the
        # eager path, whose responses wrap real ObjectRefs)
        def gen():
            dag = self._lane.dag
            while self._delegate is None:
                try:
                    if self._seq < dag._next_read \
                            or dag._out.readable() \
                            or dag.broken is not None:
                        break
                except Exception:
                    break
                yield
            return self.result()

        return gen()

    def __del__(self):
        # abandoned without consuming: hand the seq back so the drain
        # path drops the payload instead of caching it forever. Runs in
        # the GC — deque appends only, no locks (the GC-reentrancy contract).
        try:
            if not self._released and self._delegate is None:
                self._lane.dag.discard(self._seq)
                self._release()
        except Exception:
            pass


# process-level router registry: ONE compiled router per (controller,
# deployment) however many handles exist — lanes are ring pairs per
# replica, and every duplicate would multiply the admission window
_routers: Dict[Tuple[str, str], "CompiledRouter"] = {}
_routers_lock = threading.Lock()


def get_router(controller, deployment: str) -> "CompiledRouter":
    key = (str(getattr(controller, "_actor_id", id(controller))),
           deployment)
    with _routers_lock:
        r = _routers.get(key)
        if r is None:
            r = _routers[key] = CompiledRouter(deployment)
        return r


def shutdown_all(wait: bool = True) -> None:
    """Close every compiled router's lanes (serve.shutdown(): runs while
    the replicas are still alive, so teardown sentinels flow through and
    the shm segments unlink deterministically)."""
    with _routers_lock:
        routers = list(_routers.values())
        _routers.clear()
    for r in routers:
        r.close(wait=wait)


class CompiledRouter:
    """Per-deployment lane set + admission control for one process."""

    _BUILD_COOLDOWN_S = 30.0

    def __init__(self, deployment: str):
        self._name = deployment
        self._lock = threading.Lock()       # lane-map / target mutations
        self._build_lock = threading.Lock()  # serializes lane compiles
        self._lanes: Dict[str, _ReplicaLane] = {}
        self._targets: List[Tuple[str, Any]] = []  # (key, actor handle)
        self._opts: Dict[str, Any] = {}
        # dispatch fast path: the live-lane list, valid while every
        # target has a lane (None = must re-derive / build)
        self._live_lanes: Optional[List[_ReplicaLane]] = None
        # in-flight slots this process admitted for the deployment
        # (compiled tickets + eager overflow grants). A deque used as a
        # counter: append/pop are GC-safe (response __del__ releases)
        self._slots: deque = deque()
        self._broken_until = 0.0
        self._build_warned = False
        # lane sets with a background build in flight (keyed by the
        # live-attr name): scale-out lane compiles run off the dispatch
        # path so no request ever blocks behind experimental_compile
        self._bg_builds: set = set()
        # multiplex stickiness: model id -> lane key (the replica whose
        # LRU cache holds the model) — survives replica-set refreshes
        self._model_affinity: Dict[str, str] = {}
        # decode plane: stream lanes (separate DAG instances — the unary
        # lane's batch contract and the stream lane's multi-reply
        # contract cannot share rings), plus cache-aware routing state
        self._decode_lanes: Dict[str, _DecodeLane] = {}
        self._live_decode: Optional[List[_DecodeLane]] = None
        # prompt-hash -> lane key: the replica whose prefix cache holds
        # this prompt's KV (bounded LRU — the router-side half of
        # cache-hit-aware routing)
        self._prefix_affinity: "OrderedDict[int, str]" = OrderedDict()
        # replica load signals (kv occupancy / hit rate) polled at <=1Hz,
        # fire-and-collect so dispatch never blocks on the RPC
        self._load_signals: Dict[str, dict] = {}
        self._signals_ts = 0.0
        self._signal_refs: Optional[List[Tuple[str, Any]]] = None

    # -- replica-set sync (driven by the eager Router's refresh) ---------
    def update_replicas(self, replicas: List[Any], key_fn,
                        opts: Dict[str, Any]) -> None:
        desired = [(key_fn(r), r) for r in replicas]
        with self._lock:
            self._targets = desired
            self._opts = dict(opts)
            keys = {k for k, _ in desired}
            dead = [k for k in self._lanes if k not in keys]
            closing = [self._lanes.pop(k) for k in dead]
            dead_d = [k for k in self._decode_lanes if k not in keys]
            closing += [self._decode_lanes.pop(k) for k in dead_d]
            self._live_lanes = None  # re-derive on next dispatch
            self._live_decode = None
        for lane in closing:
            lane.close()

    def _window(self) -> int:
        w = self._opts.get("max_inflight")
        if not w:
            w = global_config().serve_max_inflight
        return max(1, int(w))

    def _budget(self) -> int:
        b = self._opts.get("concurrency_budget")
        if b is None:
            b = global_config().serve_concurrency_budget
        return max(0, int(b))

    def _enabled(self) -> bool:
        e = self._opts.get("compiled_dispatch")
        return True if e is None else bool(e)

    def _ensure_lanes(self) -> List[_ReplicaLane]:
        lanes = self._live_lanes
        if lanes is not None:
            return lanes  # steady state: no locks on the hot path
        return self._build_lane_set(self._lanes, "_live_lanes",
                                    _ReplicaLane)

    def _ensure_decode_lanes(self) -> List[_DecodeLane]:
        lanes = self._live_decode
        if lanes is not None:
            return lanes
        return self._build_lane_set(self._decode_lanes, "_live_decode",
                                    _DecodeLane)

    def _build_lane_set(self, lane_map: Dict[str, Any], live_attr: str,
                        lane_cls) -> List[Any]:
        with self._lock:
            targets = list(self._targets)
            missing = [(k, a) for k, a in targets if k not in lane_map]
            have_live = any(k in lane_map for k, _ in targets)
        if missing and time.monotonic() >= self._broken_until:
            if have_live:
                # scale-out: existing lanes carry traffic while the new
                # replica's lane compiles in the BACKGROUND — a lane
                # build on the dispatch path would stall every request
                # behind experimental_compile (the old scale-out p99
                # tail)
                self._spawn_builder(lane_map, live_attr, lane_cls)
            else:
                # initial bring-up: nothing to route to yet, so the
                # first dispatch pays the build inline as before
                self._build_missing(lane_map, lane_cls)
        with self._lock:
            live = {k for k, _ in self._targets}
            lanes = [ln for k, ln in lane_map.items() if k in live]
            if live and len(lanes) == len(live):
                setattr(self, live_attr, lanes)  # complete: cache
            return lanes

    def _spawn_builder(self, lane_map: Dict[str, Any], live_attr: str,
                       lane_cls) -> None:
        """Kick off (at most one per lane set) a daemon thread building
        the missing lanes."""
        with self._lock:
            if live_attr in self._bg_builds:
                return
            self._bg_builds.add(live_attr)

        def run():
            try:
                self._build_missing(lane_map, lane_cls)
            finally:
                with self._lock:
                    self._bg_builds.discard(live_attr)

        threading.Thread(target=run, daemon=True,
                         name=f"serve-lane-build-{self._name}").start()

    def _build_missing(self, lane_map: Dict[str, Any], lane_cls) -> None:
        cfg = global_config()
        with self._lock:
            missing = [(k, a) for k, a in self._targets
                       if k not in lane_map]
        with self._build_lock:
            for key, actor in missing:
                with self._lock:
                    if key in lane_map:
                        continue
                if not _actor_alive(actor):
                    continue  # record not up yet: retry next dispatch
                try:
                    lane = lane_cls(actor, key, self._name,
                                    self._window(),
                                    cfg.serve_channel_slot_bytes)
                except Exception as e:  # noqa: BLE001
                    # lane build failure must never fail the request
                    # — eager carries it; retry after a cooldown
                    self._broken_until = (time.monotonic()
                                          + self._BUILD_COOLDOWN_S)
                    if not self._build_warned:
                        self._build_warned = True
                        logger.warning(
                            "compiled serve lane build failed for "
                            "%r (falling back to eager dispatch, "
                            "retrying in %.0fs): %r", self._name,
                            self._BUILD_COOLDOWN_S, e)
                    break
                with self._lock:
                    lane_map[key] = lane

    def warm_keys(self) -> set:
        """Keys of replicas with a built lane. Lane compile round-trips
        through the replica's mailbox (``__compiled_setup__``), so a
        built lane proves the replica finished ``__init__`` and is
        serving — the eager router prefers these during scale-out so an
        overflow request never queues behind a cold replica's init (the
        scale-out p99 tail)."""
        with self._lock:
            return set(self._lanes) | set(self._decode_lanes)

    # -- admission accounting --------------------------------------------
    def outstanding(self) -> int:
        return len(self._slots)

    def _take_slot(self) -> None:
        self._slots.append(None)

    def _release_slot(self) -> None:
        try:
            self._slots.pop()
        except IndexError:
            pass

    def admit_overflow(self):
        """Grant one eager-overflow slot (windows full / no lanes, budget
        has room). Returns the release callable the eager response calls
        on finish."""
        self._take_slot()
        released = [False]

        def release():
            if not released[0]:
                released[0] = True
                self._release_slot()

        return release

    # -- the dispatch hot path -------------------------------------------
    def dispatch(self, method: str, args, kwargs, model_id: str,
                 meta: Optional[dict], redispatch=None):
        """Try to admit one request onto a lane. Returns a
        CompiledServeResponse, or None when the caller should take the
        eager path (no lanes / every window full with budget room /
        deployment opted out), or raises BackPressureError when the
        budget AND every window are exhausted (the shed line)."""
        if not self._enabled():
            return None
        _t0 = _fr.now()
        lanes = self._ensure_lanes()
        # bytes fast lane: a raw-bytes __call__ rides TAG_BYTES end to
        # end (proxy -> ring -> replica) with the serializer skipped
        # entirely; the replica re-tuples it. The meta stays driver-side
        # (outcome metrics record here; no replica access-log line).
        raw_bytes = (method == "__call__" and len(args) == 1
                     and not kwargs and not model_id
                     and isinstance(args[0],
                                    (bytes, bytearray, memoryview)))
        payload = (bytes(args[0]) if raw_bytes
                   else (method, args, kwargs, model_id, meta))
        chosen: Optional[_ReplicaLane] = None
        if lanes:
            if model_id:
                # multiplex stickiness: the replica that served this
                # model last still holds it in its LRU cache
                want = self._model_affinity.get(model_id)
                if want is not None:
                    for ln in lanes:
                        if ln.key == want:
                            chosen = ln
                            break
            if chosen is None:
                if len(lanes) == 1:
                    chosen = lanes[0]
                else:
                    # pow-2 choices on per-lane in-flight, same policy
                    # as the eager router's replica pick
                    a, b = random.sample(lanes, 2)
                    chosen = a if a.dag.inflight() <= b.dag.inflight() \
                        else b
            order = [chosen] + [ln for ln in lanes if ln is not chosen]
            for lane in order:
                ref = lane.try_dispatch(payload)
                if ref is not None:
                    if model_id:
                        self._model_affinity[model_id] = lane.key
                    self._take_slot()
                    _sp_dispatch.end(_t0, self._name)
                    resp = CompiledServeResponse(
                        self, lane, ref, meta, self._name,
                        redispatch=redispatch)
                    resp.plane = ("compiled_bytes" if raw_bytes
                                  else "compiled")
                    return resp
        budget = self._budget()
        if budget > 0 and self.outstanding() >= budget:
            self._shed(meta, len(lanes))
        return None  # overflow: the eager path is the bounded queue

    # -- the decode stream path ------------------------------------------
    def dispatch_stream(self, value, meta: Optional[dict],
                        item_timeout_s: Optional[float] = None):
        """Admit one decode request onto a stream lane. Returns a
        CompiledStreamResponse (iterator of token dicts), or None when
        the caller should fall back to the eager decode generator, or
        raises BackPressureError on shed. Routing is cache-hit-aware:
        prefix affinity first (the lane whose replica's prefix cache
        holds this prompt's KV), then pow-2 on per-lane in-flight with
        the replicas' polled KV hit rate as the tiebreak."""
        if not self._enabled() or not self._opts.get("decode"):
            return None
        _t0 = _fr.now()
        lanes = self._ensure_decode_lanes()
        pkey = self._prompt_key(value)
        if lanes:
            self._refresh_load_signals(lanes)
            chosen: Optional[_DecodeLane] = None
            if pkey is not None:
                want = self._prefix_affinity.get(pkey)
                if want is not None:
                    for ln in lanes:
                        if ln.key == want:
                            chosen = ln
                            break
            if chosen is None:
                if len(lanes) == 1:
                    chosen = lanes[0]
                else:
                    a, b = random.sample(lanes, 2)
                    chosen = min((a, b), key=self._lane_load_key)
            order = [chosen] + [ln for ln in lanes if ln is not chosen]
            for lane in order:
                ref = lane.try_dispatch(value)
                if ref is not None:
                    if pkey is not None:
                        self._remember_prefix(pkey, lane.key)
                    self._take_slot()
                    _sp_dispatch.end(_t0, self._name)
                    return CompiledStreamResponse(
                        self, lane, ref, meta, self._name,
                        item_timeout_s=item_timeout_s)
        budget = self._budget()
        if budget > 0 and self.outstanding() >= budget:
            self._shed(meta, len(lanes))
        return None

    @staticmethod
    def _prompt_key(value) -> Optional[int]:
        """Stable hash of the request's prompt tokens (the prefix-cache
        key replica-side) — None when unparseable (the replica will
        reject it with an attributed error frame)."""
        try:
            if isinstance(value, (bytes, bytearray, memoryview)):
                value = json.loads(bytes(value))
            prompt = value.get("prompt")
            return hash(tuple(int(t) for t in prompt)) if prompt else None
        except Exception:
            return None

    def _remember_prefix(self, pkey: int, lane_key: str) -> None:
        aff = self._prefix_affinity
        aff[pkey] = lane_key
        aff.move_to_end(pkey)
        while len(aff) > 4096:
            aff.popitem(last=False)

    def _lane_load_key(self, lane: _DecodeLane) -> Tuple[int, float]:
        sig = self._load_signals.get(lane.key, {})
        return (lane.dag.inflight(),
                -float(sig.get("kv_hit_rate", 0.0) or 0.0))

    def _refresh_load_signals(self, lanes: List[_DecodeLane]) -> None:
        """Collect/launch get_load_signal polls at <=1Hz. Fire-and-
        collect: refs launched on one dispatch are harvested on a later
        one, so the dispatch path never blocks on the RPC."""
        import ray_tpu_torch

        refs = self._signal_refs
        if refs is not None:
            try:
                done, _ = ray_tpu_torch.wait([r for _, r in refs],
                                       num_returns=len(refs), timeout=0)
            except Exception:
                self._signal_refs = None
                return
            if len(done) == len(refs):
                self._signal_refs = None
                for key, ref in refs:
                    try:
                        sig = ray_tpu_torch.get(ref, timeout=0.5)
                        if isinstance(sig, dict):
                            self._load_signals[key] = sig
                    except Exception:
                        pass
        now = time.monotonic()
        if now - self._signals_ts >= 1.0 and self._signal_refs is None:
            self._signals_ts = now
            try:
                self._signal_refs = [
                    (ln.key, ln.replica.get_load_signal.remote())
                    for ln in lanes]
            except Exception:
                self._signal_refs = None

    def _shed(self, meta: Optional[dict], n_lanes: int) -> None:
        from . import observability as obs

        err = BackPressureError(self._name, self.outstanding(),
                                self._budget(), n_lanes, self._window())
        if obs.enabled():
            obs.defer(obs.record_shed, self._name)
            if meta is not None:
                e2e = max(0.0, time.time() - meta.get("ingress_ts",
                                                      time.time()))
                obs.defer(obs.record_request_outcome, self._name,
                          meta.get("ingress", "handle"), "shed", e2e)
        raise err

    def close(self, wait: bool = False) -> None:
        with self._lock:
            lanes = list(self._lanes.values()) \
                + list(self._decode_lanes.values())
            self._lanes = {}
            self._decode_lanes = {}
            self._targets = []
            self._live_lanes = None
            self._live_decode = None
        for lane in lanes:
            lane.close(wait=wait)

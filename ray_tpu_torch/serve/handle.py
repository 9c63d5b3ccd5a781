"""DeploymentHandle + Router with power-of-two-choices replica scheduling.

Port of ``ray_tpu/serve/handle.py``. A driver-side handle call rides the
compiled dispatch plane (``serve/compiled_dispatch.py``): a unary call rides
one replica's long-lived ring lane (plane ``compiled``), a decode
deployment's stream its compiled decode lane (``compiled_stream``). The
eager actor path (``handle_request``, ``handle_request_stream``, or on a
decode deployment ``handle_request_decode_stream``; plane ``eager``)
carries what the lanes do not: a full window within the budget, a
payload larger than a ring slot, a handle in a worker (the HTTP proxy
runs in one), a deployment with ``compiled_dispatch=False``.
``serve.status()[dep]["dispatch_planes"]`` counts each plane.

Reference: python/ray/serve/handle.py (DeploymentHandle,
DeploymentResponse) and _private/replica_scheduler/pow_2_scheduler.py:51.
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import ActorDiedError


class _LongPollClient:
    """ONE long-poll watcher per (process, controller): a single blocked
    wait_for_version call fans version changes out to every registered
    router/proxy callback (reference: long_poll.py LongPollClient). Without
    the sharing, each handle would park its own thread in one of the
    controller's max_concurrency slots and ~16 handles would wedge it."""

    def __init__(self, controller):
        self._controller = controller
        self._subs: List[weakref.ReferenceType] = []
        self._lock = threading.Lock()
        self.alive = True
        self._version = -1
        threading.Thread(target=self._loop, daemon=True,
                         name="serve-longpoll").start()

    def add(self, bound_method) -> None:
        with self._lock:
            self._subs.append(weakref.WeakMethod(bound_method))

    def _loop(self) -> None:
        while True:
            try:
                v = ray_tpu_torch.get(self._controller.wait_for_version.remote(
                    self._version, 25.0), timeout=35)
            except Exception:
                self.alive = False  # controller gone: fall back to polling
                return
            if v == self._version:
                continue
            self._version = v
            with self._lock:
                subs, dead = list(self._subs), []
            for ref in subs:
                cb = ref()
                if cb is None:
                    dead.append(ref)
                    continue
                try:
                    cb()
                except Exception:
                    pass  # one stale subscriber must not stall the rest
            if dead:
                with self._lock:
                    self._subs = [r for r in self._subs if r not in dead]


_longpoll_clients: Dict[str, _LongPollClient] = {}
_longpoll_lock = threading.Lock()


def get_longpoll_client(controller) -> _LongPollClient:
    key = str(getattr(controller, "_actor_id", id(controller)))
    with _longpoll_lock:
        c = _longpoll_clients.get(key)
        if c is None or not c.alive:
            c = _longpoll_clients[key] = _LongPollClient(controller)
        return c


class DeploymentResponse:
    """Future-like wrapper over the replica call's ObjectRef. With
    observability on it also records the end-to-end latency and the
    request/error/timeout counters on completion (once, however many
    times result() is called). ``.ref`` always resolves to the user's
    raw return value — stage breakdowns live replica-side (access log +
    slow-request events), never inside the result."""

    def __init__(self, ref, router: "Router", replica_key: str,
                 redispatch=None, request_meta: Optional[dict] = None,
                 deployment: str = "", on_finish=None):
        self._ref = ref
        self._router = router
        self._replica_key = replica_key
        self._done = False
        self._redispatch = redispatch
        self._request_meta = request_meta
        self._deployment = deployment
        # release hook for a compiled-router overflow grant: this eager
        # request occupies one unit of the deployment's concurrency
        # budget until it SETTLES — a timed-out poll is still in flight
        # (freeing its slot early would let load past the budget)
        self._on_finish = on_finish
        self._budget_released = False
        self._recorded = False
        self._timeout_counted = False
        # caller-side timings (handle queue wait + e2e); the replica-side
        # stage breakdown lives in the access log / slow-request events
        self.timings: Optional[Dict[str, float]] = None

    def result(self, timeout: Optional[float] = None) -> Any:
        # a replica killed mid-flight (rolling update, health replacement)
        # re-routes to a live one (reference: router retries on
        # ActorDiedError for idempotent-by-convention requests). ONE
        # deadline spans all attempts — the configured timeout must not
        # triple under retries.
        attempts = 3 if self._redispatch is not None else 1
        deadline = None if timeout is None else time.time() + timeout
        timed_out = False
        try:
            for attempt in range(attempts):
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.time()))
                try:
                    value = ray_tpu_torch.get(self._ref, timeout=remaining)
                    return self._complete_ok(value)
                except ActorDiedError:
                    if attempt == attempts - 1 or (
                            deadline is not None
                            and time.time() >= deadline):
                        raise
                    self._router._dec(self._replica_key)
                    self._router._refresh(force=True)
                    self._ref, self._replica_key = self._redispatch()
        except TimeoutError:
            # a timed-out poll is NOT the request failing — result() is
            # re-callable and a later call may succeed (then records ok).
            # Count the timeout signal once, but leave the outcome open;
            # marking error here would pin 100% error_rate on any caller
            # that polls with short timeouts.
            timed_out = True
            if not self._timeout_counted:
                self._timeout_counted = True
                self._count_timeout()
            raise
        except BaseException as e:
            self._record_failure(e)
            raise
        finally:
            self._finish(release_budget=not timed_out)

    def _count_timeout(self) -> None:
        if self._request_meta is None:
            return
        from . import observability as obs

        obs.defer(obs.record_timeout, self._deployment)

    def _complete_ok(self, value):
        meta = self._request_meta
        if meta is None or self._recorded:
            return value
        self._recorded = True  # result() is re-callable; record ONCE
        from . import observability as obs

        e2e = max(0.0, time.time() - meta.get("ingress_ts", time.time()))
        self.timings = {
            "handle_queue_wait_s": meta.get("handle_queue_wait_s", 0.0),
            "e2e_s": e2e,
        }
        obs.defer(obs.record_request_outcome, self._deployment,
                  meta.get("ingress", "handle"), "ok", e2e,
                  meta.get("handle_queue_wait_s"))
        return value

    def _record_failure(self, exc: BaseException) -> None:
        meta = self._request_meta
        if meta is None or self._recorded:
            return
        self._recorded = True
        from . import observability as obs

        ingress = meta.get("ingress", "handle")
        e2e = max(0.0, time.time() - meta.get("ingress_ts", time.time()))
        obs.defer(obs.record_request_outcome, self._deployment, ingress,
                  "error", e2e, meta.get("handle_queue_wait_s"))

    def _finish(self, release_budget: bool = True):
        if not self._done:
            self._done = True
            self._router._dec(self._replica_key)
        # the budget slot outlives a timed-out poll (the request is
        # still occupying a replica); it frees on the settling call
        if release_budget and self._on_finish is not None \
                and not self._budget_released:
            self._budget_released = True
            try:
                self._on_finish()
            except Exception:
                pass

    def __del__(self):
        # an abandoned overflow response must not pin its budget slot
        # forever. GC-safe: the release hook is deque ops only (no
        # locks — the gc-reentrancy contract)
        try:
            if self._on_finish is not None and not self._budget_released:
                self._budget_released = True
                self._on_finish()
        except Exception:
            pass

    @property
    def ref(self):
        return self._ref

    def __await__(self):
        # allow `await handle.remote(...)` inside async deployments
        def gen():
            while True:
                ready, _ = ray_tpu_torch.wait([self._ref], num_returns=1,
                                        timeout=0)
                if ready:
                    break
                yield
            return self.result()

        return gen()


class Router:
    """Client-side replica chooser: picks 2 random replicas, routes to the
    one with fewer locally-tracked in-flight requests (pow-2 choices)."""

    def __init__(self, controller, deployment_name: str):
        self._controller = controller
        self._name = deployment_name
        self._replicas: List[Any] = []
        self._inflight: Dict[str, int] = {}
        self._version = -1
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        self._poller_started = False
        self.retry_on_replica_failure = True  # updated on refresh
        # deployment serves generative decode (token streams ride the
        # compiled stream lanes; eager fallback is the decode generator)
        self.decode = False
        # None -> fall back to the global config default at emit time
        self.slow_request_threshold_s: Optional[float] = None
        # compiled dispatch plane: the process-shared lane router for
        # this deployment (serve/compiled_dispatch.py), fed the replica
        # set + options on every refresh; None until first use
        self._compiled = None
        self._compiled_opts: Dict[str, Any] = {}

    def _on_longpoll(self) -> None:
        self._refresh(force=True)

    def _ensure_poller(self) -> None:
        """Long-poll push: register with the process-wide shared watcher so
        replica-set changes reach this router in milliseconds; the timed
        poll in _refresh stays as the fallback if the watcher dies."""
        if self._poller_started:
            return
        self._poller_started = True
        get_longpoll_client(self._controller).add(self._on_longpoll)

    def _refresh(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last_refresh < 0.5 and self._replicas:
            return
        try:
            version = ray_tpu_torch.get(self._controller.get_version.remote(),
                                  timeout=5)
        except Exception:
            return
        if version != self._version or not self._replicas:
            rset = ray_tpu_torch.get(
                self._controller.get_replica_set.remote(self._name),
                timeout=5)
            replicas = rset["replicas"]
            with self._lock:
                self._replicas = replicas
                self._version = version
                self.retry_on_replica_failure = rset.get(
                    "retry_on_replica_failure", True)
                # resolve the global fallback HERE so the per-request
                # slow check compares against a concrete float
                thr = rset.get("slow_request_threshold_s")
                if thr is None:
                    from ray_tpu_torch.core.config import global_config

                    thr = global_config().serve_slow_request_threshold_s
                self.slow_request_threshold_s = thr
                self.decode = bool(rset.get("decode"))
                self._compiled_opts = {
                    "max_inflight": rset.get("max_inflight"),
                    "concurrency_budget": rset.get("concurrency_budget"),
                    "compiled_dispatch": rset.get("compiled_dispatch"),
                    "decode": rset.get("decode"),
                }
                keys = {self._key(r) for r in replicas}
                self._inflight = {k: v for k, v in self._inflight.items()
                                  if k in keys}
            # push the new set to the compiled lane router OUTSIDE the
            # lock (lane retirement enqueues teardowns)
            if self._compiled is not None:
                self._compiled.update_replicas(
                    replicas, self._key, self._compiled_opts)
        self._last_refresh = now

    def compiled_router(self):
        """The compiled dispatch plane for this deployment, or None when
        unavailable (switch off, worker/client process, deployment
        opt-out) — the caller then takes the eager path."""
        from . import compiled_dispatch as cd

        if not cd.available():
            return None
        self._refresh()
        if self._compiled_opts.get("compiled_dispatch") is False:
            return None
        if self._compiled is None:
            self._compiled = cd.get_router(self._controller, self._name)
            with self._lock:
                replicas = list(self._replicas)
                opts = dict(self._compiled_opts)
            self._compiled.update_replicas(replicas, self._key, opts)
        return self._compiled

    @staticmethod
    def _key(replica) -> str:
        return str(getattr(replica, "_actor_id", id(replica)))

    def _dec(self, key: str) -> None:
        with self._lock:
            if key in self._inflight:
                self._inflight[key] = max(0, self._inflight[key] - 1)

    def choose(self, model_id: str = ""):
        self._ensure_poller()
        deadline = time.time() + 30
        while True:
            self._refresh()
            with self._lock:
                replicas = list(self._replicas)
            if replicas:
                break
            if time.time() > deadline:
                raise RuntimeError(
                    f"no replicas available for deployment {self._name!r}")
            time.sleep(0.05)
            self._refresh(force=True)
        chosen = None
        if model_id:
            # multiplex-aware sticky routing: prefer the replica this
            # model id last landed on (its LRU cache holds the model) —
            # reference: multiplexed-model-aware replica scheduler
            with self._lock:
                sticky = getattr(self, "_model_affinity", None)
                if sticky is None:
                    sticky = self._model_affinity = {}
                want = sticky.get(model_id)
            if want is not None:
                for r in replicas:
                    if self._key(r) == want:
                        chosen = r
                        break
        if chosen is None:
            if len(replicas) > 1 and self._compiled is not None:
                # scale-out: prefer replicas with a built compiled lane —
                # a built lane proves the replica is past __init__, so
                # eager overflow never queues behind a cold replica's
                # init (the scale-out p99 tail). With no lanes yet
                # (initial bring-up / opt-out) the full set stands.
                warm = self._compiled.warm_keys()
                if warm:
                    warm_rs = [r for r in replicas
                               if self._key(r) in warm]
                    if warm_rs:
                        replicas = warm_rs
            if len(replicas) == 1:
                chosen = replicas[0]
            else:
                a, b = random.sample(replicas, 2)
                with self._lock:
                    la = self._inflight.get(self._key(a), 0)
                    lb = self._inflight.get(self._key(b), 0)
                chosen = a if la <= lb else b
        key = self._key(chosen)
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1
            if model_id:
                self._model_affinity[model_id] = key
        return chosen, key


class DeploymentHandle:
    def __init__(self, controller, deployment_name: str,
                 method_name: str = "__call__", stream: bool = False,
                 stream_item_timeout_s: Optional[float] = None,
                 multiplexed_model_id: str = ""):
        self._controller = controller
        self._name = deployment_name
        self._method = method_name
        self._stream = stream
        self._stream_item_timeout_s = stream_item_timeout_s
        self._model_id = multiplexed_model_id
        self._router = Router(controller, deployment_name)
        # per-call ingress metadata (proxy/gRPC set it via options();
        # never shared between handle instances, never serialized)
        self._pending_meta: Optional[dict] = None

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                stream_item_timeout_s: Optional[float] = None,
                multiplexed_model_id: Optional[str] = None,
                _request_meta: Optional[dict] = None
                ) -> "DeploymentHandle":
        h = DeploymentHandle(self._controller, self._name,
                             method_name or self._method,
                             self._stream if stream is None else stream,
                             stream_item_timeout_s
                             or self._stream_item_timeout_s,
                             self._model_id if multiplexed_model_id is None
                             else multiplexed_model_id)
        h._router = self._router  # share in-flight accounting
        h._pending_meta = _request_meta or self._pending_meta
        return h

    @property
    def method(self):
        return _MethodAccessor(self)

    def _build_request_meta(self) -> Optional[dict]:
        """The per-request record carried to the replica. Ingress-created
        meta (proxy/gRPC) arrives via options(_request_meta=); otherwise a
        fresh one is minted here — inheriting the enclosing request's id
        when this call composes deployments inside a replica, so one
        user request keeps ONE id across every hop."""
        from . import observability as obs

        if not obs.enabled():
            return None
        meta = self._pending_meta
        if meta is None:
            parent = obs.current_request()
            meta = obs.make_request_meta(
                deployment=self._name, ingress="handle",
                request_id=(parent.meta.get("request_id")
                            if parent is not None else None))
        else:
            meta = dict(meta)
        meta["deployment"] = self._name
        return meta

    def remote(self, *args, **kwargs):
        meta = self._build_request_meta()
        t0 = time.perf_counter()
        overflow_release = None
        if not self._stream:
            cr = self._router.compiled_router()
            if cr is not None:
                resp, overflow_release = self._try_compiled(
                    cr, args, kwargs, meta, t0)
                if resp is not None:
                    return resp
        else:
            # decode deployments stream tokens over the compiled plane
            # (TAG_STREAM ring frames); eager is the fallback, not the
            # rule — streaming no longer implies eager dispatch
            it = self._try_compiled_stream(args, kwargs, meta, t0)
            if it is not None:
                return it
        try:
            return self._eager_dispatch(args, kwargs, meta, t0,
                                        overflow_release)
        except BaseException:
            # a routing failure must not strand the budget slot the
            # compiled router granted for this overflow request
            if overflow_release is not None:
                overflow_release()
            raise

    def _try_compiled(self, cr, args, kwargs, meta, t0):
        """One admission attempt on the compiled dispatch plane.
        Returns ``(response, None)`` on admit, ``(None, release)`` on
        overflow-to-eager (the release hook frees the granted budget
        slot when the eager response settles), and raises
        BackPressureError on shed."""
        from ray_tpu_torch.util import tracing

        span = None
        if meta is not None:
            meta["dispatch_ts"] = time.time()
            meta["handle_queue_wait_s"] = time.perf_counter() - t0
            meta["slow_threshold_s"] = \
                self._router.slow_request_threshold_s
            parent_ctx = meta.get("trace_ctx") or tracing.current_context()
            if parent_ctx is not None:
                span = tracing.child_span(
                    f"serve.handle.{self._name}", parent=parent_ctx,
                    request_id=meta["request_id"])
                # the replica parents its span under the handle span via
                # the meta (there is no eager task span on this plane)
                meta["handle_span_ctx"] = span.context
        redispatch = (
            (lambda eager_only=False: self._redispatch_request(
                args, kwargs, meta, eager_only))
            if self._router.retry_on_replica_failure else None)
        try:
            resp = cr.dispatch(self._method, args, kwargs,
                               self._model_id, meta,
                               redispatch=redispatch)
        except BaseException:
            if span is not None:
                span.finish()
            raise
        if resp is not None:
            if span is not None:
                span.finish()
            if meta is not None:
                from . import observability as obs

                obs.defer(obs.record_dispatch, self._name,
                          time.perf_counter() - t0,
                          getattr(resp, "plane", "compiled"))
            return resp, None
        # overflow to eager: drop the unadmitted attempt's span
        # UNPUBLISHED (never finished) — the eager path opens the one
        # real handle span for this request
        if meta is not None:
            meta.pop("handle_span_ctx", None)
        return None, cr.admit_overflow()

    def _try_compiled_stream(self, args, kwargs, meta, t0):
        """One admission attempt on the compiled decode stream plane.
        Returns an iterator of token dicts, or None -> the eager decode
        generator carries it (not a decode deployment, no lanes, every
        window full); raises BackPressureError on shed."""
        if kwargs or len(args) != 1:
            return None
        self._router._refresh()
        if not self._router.decode:
            return None
        cr = self._router.compiled_router()
        if cr is None:
            return None
        if meta is not None:
            meta["dispatch_ts"] = time.time()
            meta["handle_queue_wait_s"] = time.perf_counter() - t0
        resp = cr.dispatch_stream(
            args[0], meta, item_timeout_s=self._stream_item_timeout_s)
        if resp is None:
            return None
        if meta is not None:
            from . import observability as obs

            obs.defer(obs.record_dispatch, self._name,
                      time.perf_counter() - t0, "compiled_stream")
        return iter(resp)

    def _redispatch_request(self, args, kwargs, meta, eager_only=False):
        """Replica-failure retry: re-dispatch the whole request (the
        router refreshed its set on the death) — compiled again if a
        lane admits, else the eager path. ``eager_only`` skips the
        compiled plane (an oversized REPLY just bounced off the ring
        slot; re-admitting would bounce it identically)."""
        if meta is not None:
            meta["dispatch_ts"] = time.time()
        if not eager_only:
            self._router._refresh(force=True)
            cr = self._router.compiled_router()
            if cr is not None:
                try:
                    resp = cr.dispatch(self._method, args, kwargs,
                                       self._model_id, meta,
                                       redispatch=None)
                except Exception:  # shed on retry: eager carries it
                    resp = None
                if resp is not None:
                    return resp
        return self._eager_dispatch(args, kwargs, meta,
                                    time.perf_counter(), None)

    def _eager_dispatch(self, args, kwargs, meta, t0, overflow_release):
        from ray_tpu_torch.util import tracing

        t_choose = time.perf_counter()
        try:
            replica, key = self._router.choose(model_id=self._model_id)
        except Exception:
            # routing failure (e.g. no live replicas): no response object
            # will ever exist, so the error must count HERE — a total
            # outage showing 0% error rate is the worst failure mode an
            # error metric can have
            if meta is not None:
                from . import observability as obs

                e2e = max(0.0, time.time() - meta.get("ingress_ts",
                                                      time.time()))
                obs.defer(obs.record_request_outcome, self._name,
                          meta.get("ingress", "handle"), "error", e2e)
            raise
        span = None
        if meta is not None:
            wait = time.perf_counter() - t_choose
            meta["handle_queue_wait_s"] = wait
            meta["dispatch_ts"] = time.time()
            # the replica emits the slow-request event (it owns the stage
            # breakdown); the deployment's threshold rides along
            meta["slow_threshold_s"] = \
                self._router.slow_request_threshold_s
            # the handle hop's span: parented under the ingress span when
            # one rides the meta (HTTP/gRPC), else under the ambient
            # context (a driver-side `with tracing.trace(...)` or replica
            # composition inside a traced request). Entering it makes the
            # replica's task span its child via spec.trace_ctx. With NO
            # parent at all the span is skipped — an orphan single-span
            # trace joins nothing, and span overhead off the ingress path
            # is pure cost (metrics still record).
            parent_ctx = meta.get("trace_ctx") or tracing.current_context()
            if parent_ctx is not None:
                span = tracing.child_span(
                    f"serve.handle.{self._name}", parent=parent_ctx,
                    request_id=meta["request_id"])
        if self._stream:
            # items stream incrementally (streaming generators); the
            # in-flight count drops when the generator is exhausted
            decode = (self._router.decode and len(args) == 1
                      and not kwargs)
            try:
                if span is not None:
                    span.__enter__()
                if decode:
                    # eager decode fallback: the replica-side generator
                    # drives the SAME scheduler as the compiled lane, so
                    # both planes continuous-batch together
                    gen = replica.handle_request_decode_stream.options(
                        num_returns="streaming").remote(
                        args[0], self._model_id, meta)
                else:
                    gen = replica.handle_request_stream.options(
                        num_returns="streaming").remote(
                        self._method, args, kwargs, self._model_id, meta)
            finally:
                if span is not None:
                    span.__exit__(None, None, None)
            item_timeout = self._stream_item_timeout_s
            stream_meta, name = meta, self._name
            if meta is not None:
                from . import observability as obs

                obs.defer(obs.record_dispatch, self._name,
                          time.perf_counter() - t0, "eager")

            def iterate():
                import json as _json

                status = "ok"
                timed_out = False
                try:
                    for ref in gen:
                        # bounded per-item wait: a hung replica must not
                        # pin the consumer (and its executor thread) forever
                        item = ray_tpu_torch.get(ref, timeout=item_timeout)
                        if decode:
                            # (kind, payload) frames -> the same dicts
                            # the compiled stream plane yields
                            item = _json.loads(bytes(item[1]))
                        yield item
                except BaseException as e:
                    status = "error"
                    timed_out = isinstance(e, TimeoutError)
                    raise
                finally:
                    self._router._dec(key)
                    if stream_meta is not None:
                        from . import observability as obs

                        e2e = max(0.0, time.time()
                                  - stream_meta.get("ingress_ts",
                                                    time.time()))
                        obs.defer(
                            obs.record_request_outcome, name,
                            stream_meta.get("ingress", "handle"), status,
                            e2e,
                            stream_meta.get("handle_queue_wait_s"),
                            timed_out)

            return iterate()
        try:
            if span is not None:
                span.__enter__()
            ref = replica.handle_request.remote(
                self._method, args, kwargs, self._model_id, meta)
        finally:
            if span is not None:
                span.__exit__(None, None, None)
        if meta is not None:
            obs_dt = time.perf_counter() - t0
            from . import observability as obs

            obs.defer(obs.record_dispatch, self._name, obs_dt, "eager")

        def redispatch():
            r2, k2 = self._router.choose(model_id=self._model_id)
            if meta is not None:
                meta["dispatch_ts"] = time.time()
            return r2.handle_request.remote(
                self._method, args, kwargs, self._model_id, meta), k2

        # flag rides the router's replica refresh — no extra RPC here
        return DeploymentResponse(
            ref, self._router, key,
            redispatch if self._router.retry_on_replica_failure else None,
            request_meta=meta, deployment=self._name,
            on_finish=overflow_release)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _BoundMethod(self, name)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._controller, self._name, self._method, self._stream,
                 self._stream_item_timeout_s, self._model_id))


class _BoundMethod:
    def __init__(self, handle: DeploymentHandle, method_name: str):
        self._handle = handle
        self._method_name = method_name

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle.options(
            method_name=self._method_name).remote(*args, **kwargs)


class _MethodAccessor:
    def __init__(self, handle: DeploymentHandle):
        self._handle = handle

    def __getattr__(self, name):
        return _BoundMethod(self._handle, name)

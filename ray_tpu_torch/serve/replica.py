"""ServeReplica — the actor hosting one copy of a deployment's callable.

Port of ``ray_tpu/serve/replica.py``: unary requests on the eager path
(``handle_request``) and on the compiled dispatch plane's ring lane
(``handle_request_compiled_batch``: the exec loop's drained backlog, run
in contiguous same-method groups, one reply per item), generator streams
(``handle_request_stream``), and the decode plane over one lazily built
``serve/decode.py:DecodeScheduler``, driven by the compiled decode lane
(``handle_request_decode``, one scheduling iteration a round) and by
eager streams (``handle_request_decode_stream``) together. Requests
queued in a lane's ring count in the ongoing load, as eager ones do.

A deployment that asks ``ray_actor_options={"num_gpus": 1}`` gets its
replica on a card: the runtime binds ``CUDA_VISIBLE_DEVICES`` before
``__init__`` runs, and the decode engine is built here, in the replica,
on that card.

Reference: python/ray/serve/_private/replica.py (user callable wrapper,
max_ongoing_requests accounting, health checks, per-request metrics +
access logging).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import inspect
import os
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util import flight_recorder as _fr

_sp_serve_batch = _fr.register_span("serve.batch_drain",
                                    tag_keys=("deployment",))


def _record_request(rc, deployment: str, replica_tag: str,
                    method_name: str, status: str,
                    exec_s, ongoing: int, ts: float) -> None:
    """Deferred per-request bookkeeping (runs on the observability drain
    thread, NOT the request path)."""
    from ray_tpu_torch.serve import observability as obs

    dep = deployment or rc.meta.get("deployment", "")
    obs.REPLICA_QUEUE_WAIT.observe(
        rc.timings.get("replica_queue_wait_s", 0.0),
        tag_key=obs.dep_key(dep))
    if exec_s is not None:
        obs.EXEC_TIME.observe(exec_s, tag_key=obs.dep_key(dep))
    obs.QUEUE_DEPTH.set(ongoing, tag_key=obs.replica_key(
        dep, replica_tag))
    obs.access_log(dep, replica_tag, {
        "ts": ts,
        "request_id": rc.meta.get("request_id", ""),
        "deployment": dep,
        "replica": replica_tag,
        "route": rc.meta.get("route", ""),
        "method": method_name,
        "ingress": rc.meta.get("ingress", ""),
        "status": status,
        "timings_ms": {k[:-1] + "ms": round(v * 1000.0, 3)
                       for k, v in rc.timings.items()},
    })
    # slow-request event from the replica (the process that OWNS the
    # stage breakdown — shipping timings back in a result envelope made
    # response.ref resolve to internal wrapping). e2e measured here
    # misses the reply's return hop, which is sub-ms against thresholds
    # of tens of ms; handle_queue_wait rides in via the meta.
    threshold = rc.meta.get("slow_threshold_s")
    ingress_ts = rc.meta.get("ingress_ts")
    if ingress_ts is not None:
        timings = dict(rc.timings)
        hq = rc.meta.get("handle_queue_wait_s")
        if hq is not None:
            timings["handle_queue_wait_s"] = hq
        e2e = max(0.0, ts - ingress_ts)
        timings["e2e_s"] = e2e
        obs.maybe_emit_slow_request(rc.meta, timings, e2e, threshold)


@ray_tpu_torch.remote
class ServeReplica:
    """Runs the user class/function; tracks ongoing-request count used by
    the router's power-of-two-choices and the autoscaler. With
    observability on, each request records stage histograms, appends one
    access-log JSONL line, and — when slower end-to-end than the
    threshold riding the request meta — emits the slow-request WARNING
    event with the stage breakdown (serve/observability.py)."""

    def __init__(self, serialized_callable, init_args, init_kwargs,
                 user_config=None, deployment_name: str = "",
                 replica_tag: str = ""):
        import cloudpickle

        target = cloudpickle.loads(serialized_callable)
        if inspect.isclass(target):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target
        self._ongoing = 0
        self._total = 0
        self._is_class = inspect.isclass(target)
        self._deployment = deployment_name
        self._replica_tag = replica_tag or f"pid{os.getpid()}"
        # compiled dispatch plane: in-ring channels per DAG uid (backlog
        # visibility for load signals) and a private event loop for
        # async user callables invoked from the compiled exec thread
        self._compiled_chans = {}
        self._compiled_loop = None
        self._compiled_loop_lock = threading.Lock()
        self._sync_pool = None  # lazy; see _run_sync_group
        # generative-decode plane: one scheduler per replica, built
        # lazily from the callable's engine factory (serve/decode.py)
        self._decode_sched = None
        self._decode_lock = threading.Lock()
        self._decode_eager_seq = 0
        if user_config is not None and hasattr(
                self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def _resolve_fn(self, method_name: str):
        if self._is_class:
            if method_name == "__call__":
                return self._callable
            return getattr(self._callable, method_name)
        return self._callable

    def _request_begin(self, request_meta, recv_ts: float):
        """Queue-wait accounting; returns the RequestContext (or None
        with observability off / an uninstrumented caller). Only the
        timestamp math runs inline — metric records defer to the
        observability drain thread."""
        from ray_tpu_torch.serve import observability as obs

        if request_meta is None or not obs.enabled():
            return None
        rc = obs.RequestContext(request_meta)
        # cross-process wall-clock delta (same host): clamp at 0 so minor
        # skew can't record negative waits
        wait = max(0.0, recv_ts - request_meta.get("dispatch_ts", recv_ts))
        rc.timings["replica_queue_wait_s"] = wait
        return rc

    def _request_end(self, rc, method_name: str, status: str,
                     exec_s: Optional[float]) -> None:
        """Queue the request's bookkeeping (stage histograms, queue-depth
        gauge, access-log line) for the drain thread; rc.timings is final
        by now (batching stamps batch_wait_s before the future resolves),
        so the deferred closure sees settled values."""
        from ray_tpu_torch.serve import observability as obs

        if exec_s is not None:
            rc.timings["exec_s"] = exec_s
        obs.defer(_record_request, rc, self._deployment,
                  self._replica_tag, method_name, status, exec_s,
                  self._ongoing, time.time())

    async def handle_request(self, method_name: str, args, kwargs,
                             multiplexed_model_id: str = "",
                             request_meta: Optional[dict] = None):
        from ray_tpu_torch.serve.multiplex import _set_request_model_id

        recv_ts = time.time()
        self._ongoing += 1
        self._total += 1
        token = _set_request_model_id(multiplexed_model_id)
        rc = self._request_begin(request_meta, recv_ts)
        rc_token = None
        if rc is not None:
            from ray_tpu_torch.serve import observability as obs

            rc_token = obs._set_request_ctx(rc)
        status, exec_s, t0 = "ok", None, None
        try:
            fn = self._resolve_fn(method_name)
            t0 = time.perf_counter()
            if inspect.iscoroutinefunction(fn) or (
                    not inspect.isfunction(fn) and not inspect.ismethod(fn)
                    and inspect.iscoroutinefunction(
                        getattr(fn, "__call__", None))):
                result = await fn(*args, **kwargs)
            else:
                # sync callables run in a thread pool so concurrent
                # requests overlap (reference: replica.py run_sync_in_
                # threadpool) — keeps the ongoing-count signal honest for
                # pow-2 routing and autoscaling. copy_context: the
                # multiplexed-model-id and request contextvars must be
                # visible in the executor thread
                import contextvars

                loop = asyncio.get_event_loop()
                ctx = contextvars.copy_context()
                result = await loop.run_in_executor(
                    None, lambda: ctx.run(fn, *args, **kwargs))
            if inspect.iscoroutine(result):
                result = await result
            exec_s = time.perf_counter() - t0
            return result
        except Exception:
            status = "error"
            if t0 is not None:
                exec_s = time.perf_counter() - t0
            raise
        finally:
            self._ongoing -= 1
            if rc is not None:
                from ray_tpu_torch.serve import observability as obs

                try:
                    self._request_end(rc, method_name, status, exec_s)
                finally:
                    obs._reset_request_ctx(rc_token)
            from ray_tpu_torch.serve.multiplex import _model_id_ctx

            _model_id_ctx.reset(token)

    def handle_request_stream(self, method_name: str, args, kwargs,
                              multiplexed_model_id: str = "",
                              request_meta: Optional[dict] = None):
        """Streaming requests: the user callable returns a generator whose
        items stream back via num_returns="streaming" actor-method calls
        (reference: replica streaming responses over generators). Items
        pass through unwrapped; the stage metrics and access-log line
        record when the generator is exhausted."""
        from ray_tpu_torch.serve.multiplex import _set_request_model_id, _model_id_ctx

        recv_ts = time.time()
        self._ongoing += 1
        self._total += 1
        token = _set_request_model_id(multiplexed_model_id)
        rc = self._request_begin(request_meta, recv_ts)
        rc_token = None
        if rc is not None:
            from ray_tpu_torch.serve import observability as obs

            rc_token = obs._set_request_ctx(rc)
        status, t0 = "ok", None
        try:
            fn = self._resolve_fn(method_name)
            t0 = time.perf_counter()
            for item in fn(*args, **kwargs):
                yield item
        except Exception:
            status = "error"
            raise
        finally:
            self._ongoing -= 1
            if rc is not None:
                from ray_tpu_torch.serve import observability as obs

                exec_s = (time.perf_counter() - t0
                          if t0 is not None else None)
                try:
                    self._request_end(rc, method_name, status, exec_s)
                finally:
                    obs._reset_request_ctx(rc_token)
            _model_id_ctx.reset(token)

    # ------------------------------------------------ compiled dispatch
    # The serve compiled-dispatch plane (serve/compiled_dispatch.py)
    # binds handle_request_compiled_batch into a long-lived compiled DAG
    # per replica: requests arrive as the ring backlog the exec loop
    # drained this round (ring-fed continuous batching — under load the
    # list fills with zero assembly wait; idle requests run alone,
    # immediately), and one reply per item ships back in order.

    def __compiled_channels_hook__(self, uid: str, chans) -> None:
        """Called by the worker's compiled-exec installer with this
        DAG's in-edge channels (None on loop exit): queued-in-ring
        requests then count in the load signal the router/autoscaler
        polls, exactly like eager in-flight requests do."""
        if chans is None:
            self._compiled_chans.pop(uid, None)
        else:
            self._compiled_chans[uid] = chans

    def _compiled_backlog(self) -> int:
        n = 0
        for chans in list(self._compiled_chans.values()):
            for ch in chans:
                try:
                    n += ch.occupancy()
                except Exception:
                    pass  # channel closed (rebind/teardown race)
        return n

    def _ensure_compiled_loop(self):
        """Private event loop for async user callables reached from the
        compiled exec thread — items of one batch gather CONCURRENTLY on
        it, so composition like `await self.batched(x)` still assembles
        real batches (the @serve.batch queue lives on this loop)."""
        if self._compiled_loop is None:
            with self._compiled_loop_lock:
                if self._compiled_loop is None:
                    loop = asyncio.new_event_loop()
                    t = threading.Thread(target=loop.run_forever,
                                         daemon=True,
                                         name="serve-compiled-async")
                    t.start()
                    self._compiled_loop = loop
        return self._compiled_loop

    @staticmethod
    def _is_async_callable(fn) -> bool:
        return inspect.iscoroutinefunction(fn) or (
            not inspect.isfunction(fn) and not inspect.ismethod(fn)
            and inspect.iscoroutinefunction(
                getattr(fn, "__call__", None)))

    def handle_request_compiled_batch(self, requests: List[tuple]):
        """One ring-fed batch round: ``requests`` is a list of
        ``(method, args, kwargs, model_id, meta)`` tuples in arrival
        order. Returns one result per item in order; per-item failures
        come back as BatchItemError so one bad request cannot fail its
        batch-mates."""
        recv_ts = time.time()
        _t0 = _fr.now()
        # TAG_BYTES fast lane: raw body bytes arrive un-tupled — they are
        # __call__(payload) requests by construction (proxy bytes_body)
        requests = [("__call__", (bytes(r),), {}, "", None)
                    if isinstance(r, (bytes, bytearray, memoryview))
                    else r for r in requests]
        out: List[Any] = []
        i, n = 0, len(requests)
        while i < n:
            method, model_id = requests[i][0], requests[i][3]
            j = i + 1
            # contiguous same-(method, model) runs execute as one group
            # — the order-preserving grouping rule
            while j < n and requests[j][0] == method \
                    and requests[j][3] == model_id:
                j += 1
            out.extend(self._compiled_group(method, model_id,
                                            requests[i:j], recv_ts))
            i = j
        _sp_serve_batch.end(_t0, self._deployment)
        return out

    def _compiled_group(self, method_name: str, model_id: str,
                        group: List[tuple], recv_ts: float) -> List[Any]:
        from ray_tpu_torch.experimental.channel import BatchItemError
        from ray_tpu_torch.serve.multiplex import (_model_id_ctx,
                                             _set_request_model_id)

        try:
            fn = self._resolve_fn(method_name)
        except AttributeError as e:
            return [BatchItemError(e)] * len(group)
        self._ongoing += len(group)
        self._total += len(group)
        rcs = [self._request_begin(req[4], recv_ts) for req in group]
        spans = self._compiled_spans(group)
        token = _set_request_model_id(model_id)
        t0 = time.perf_counter()
        try:
            try:
                raw = getattr(fn, "_serve_batch_fn", None)
                if raw is not None and all(
                        len(req[1]) == 1 and not req[2] for req in group):
                    results = self._run_ring_batches(
                        fn, raw, group, BatchItemError)
                elif self._is_async_callable(fn):
                    results = self._run_async_group(
                        fn, group, rcs, model_id, BatchItemError)
                else:
                    results = self._run_sync_group(fn, group, rcs,
                                                   BatchItemError)
            except Exception as e:  # noqa: BLE001 — never lose a reply
                results = [BatchItemError(e)] * len(group)
        finally:
            exec_s = time.perf_counter() - t0
            self._ongoing -= len(group)
            _model_id_ctx.reset(token)
            for span in spans:
                if span is not None:
                    span.finish()
        for rc, res in zip(rcs, results):
            if rc is None:
                continue
            status = "error" if isinstance(res, BatchItemError) else "ok"
            # per-item exec time is the group's wall time: items of one
            # continuous batch share the execution
            self._request_end(rc, method_name, status, exec_s)
        return results

    def _compiled_spans(self, group):
        """Replica-side spans joining the handle span (compiled dispatch
        has no eager task span to join the trace for it)."""
        from ray_tpu_torch.serve import observability as obs

        if not obs.enabled():
            return [None] * len(group)
        from ray_tpu_torch.util import tracing

        spans = []
        for req in group:
            meta = req[4]
            ctx = meta.get("handle_span_ctx") if meta else None
            if ctx is None:
                spans.append(None)
                continue
            try:
                spans.append(tracing.child_span(
                    "serve.replica.handle_request_compiled",
                    parent=ctx,
                    request_id=meta.get("request_id", "")))
            except Exception:
                spans.append(None)
        return spans

    def _run_ring_batches(self, fn, raw, group,
                          BatchItemError) -> List[Any]:
        """@serve.batch target dispatched on the compiled plane: the
        ring backlog IS the batch — the undecorated fn runs directly on
        the drained items (chunked to the decorator's max_batch_size)
        with no assembly timer at all."""
        from ray_tpu_torch.serve import observability as obs
        from ray_tpu_torch.serve.batching import _record_batch_metrics

        bmax = max(1, int(getattr(fn, "_serve_batch_max", len(group))))
        target = (functools.partial(raw, self._callable)
                  if self._is_class else raw)
        results: List[Any] = []
        for start in range(0, len(group), bmax):
            chunk = group[start:start + bmax]
            items = [req[1][0] for req in chunk]
            try:
                res = target(items)
                if asyncio.iscoroutine(res):
                    res = asyncio.run_coroutine_threadsafe(
                        res, self._ensure_compiled_loop()).result()
                if not isinstance(res, (list, tuple)) \
                        or len(res) != len(items):
                    raise ValueError(
                        f"batched fn returned "
                        f"{len(res) if isinstance(res, (list, tuple)) else type(res).__name__} "
                        f"results for {len(items)} inputs")
                results.extend(res)
            except Exception as e:  # noqa: BLE001 — fail this chunk only
                results.extend([BatchItemError(e)] * len(items))
            if obs.enabled():
                obs.defer(_record_batch_metrics, self._deployment, [],
                          len(chunk), bmax)
        return results

    def _run_async_group(self, fn, group, rcs, model_id,
                         BatchItemError) -> List[Any]:
        """Async callable: gather the whole group concurrently on the
        private loop — composition through @serve.batch inside the
        callable still forms real batches, and slow awaits overlap."""
        from ray_tpu_torch.serve import observability as obs
        from ray_tpu_torch.serve.multiplex import (_model_id_ctx,
                                             _set_request_model_id)

        async def one(req, rc):
            # each gather task runs in its own context copy: the model
            # id and request context stick to this item only
            token = _set_request_model_id(model_id)
            rc_token = obs._set_request_ctx(rc) if rc is not None else None
            try:
                return await fn(*req[1], **req[2])
            finally:
                if rc_token is not None:
                    obs._reset_request_ctx(rc_token)
                _model_id_ctx.reset(token)

        async def gather():
            return await asyncio.gather(
                *(one(req, rc) for req, rc in zip(group, rcs)),
                return_exceptions=True)

        res = asyncio.run_coroutine_threadsafe(
            gather(), self._ensure_compiled_loop()).result()
        return [BatchItemError(r) if isinstance(r, BaseException) else r
                for r in res]

    def _run_sync_group(self, fn, group, rcs, BatchItemError) -> List[Any]:
        from ray_tpu_torch.serve import observability as obs

        def one(req, rc):
            rc_token = obs._set_request_ctx(rc) if rc is not None else None
            try:
                return fn(*req[1], **req[2])
            except Exception as e:  # noqa: BLE001
                return BatchItemError(e)
            finally:
                if rc_token is not None:
                    obs._reset_request_ctx(rc_token)

        if len(group) == 1:
            return [one(group[0], rcs[0])]
        # items of one ring drain overlap in a thread pool, exactly like
        # the eager plane's run_in_executor path runs concurrent sync
        # requests — a serial loop here made every batch-mate wait out
        # the whole round (compiled-plane tail ≈ batch size × exec time
        # under load, which eager never exhibits). copy_context at
        # submit time: the group's model-id contextvar must be visible
        # in the pool threads. Replies keep arrival order.
        import contextvars

        if self._sync_pool is None:
            with self._compiled_loop_lock:
                if self._sync_pool is None:
                    self._sync_pool = \
                        concurrent.futures.ThreadPoolExecutor(
                            max_workers=16,
                            thread_name_prefix="serve-sync-batch")
        futs = [self._sync_pool.submit(
                    contextvars.copy_context().run, one, req, rc)
                for req, rc in zip(group, rcs)]
        return [f.result() for f in futs]

    # ----------------------------------------------------- decode plane
    # Generative decode (serve/decode.py): the compiled stream lane
    # binds handle_request_decode with with_stream_batching — the exec
    # loop drains new requests from the ring BETWEEN decode iterations
    # and calls back in while any sequence is running, which is exactly
    # the Orca iteration-level admission loop.

    def _decode_scheduler(self):
        """Lazily build the scheduler from the callable's engine factory
        (a deployment is decode-capable iff its callable defines
        ``create_decode_engine()``)."""
        sched = self._decode_sched
        if sched is None:
            with self._decode_lock:
                sched = self._decode_sched
                if sched is None:
                    from ray_tpu_torch.serve.decode import DecodeScheduler

                    factory = getattr(self._callable,
                                      "create_decode_engine", None)
                    if factory is None:
                        raise TypeError(
                            f"deployment {self._deployment!r} is not "
                            "decode-capable: its callable has no "
                            "create_decode_engine()")
                    sched = DecodeScheduler(
                        factory(), deployment=self._deployment,
                        max_batch=int(getattr(
                            self._callable, "decode_max_batch", 8)))
                    self._decode_sched = sched
        return sched

    def handle_request_decode(self, entries: List[tuple]):
        """One stream-exec round on the decode plane: submit this
        round's drained ring entries ``(corr, value)``, run ONE
        scheduling iteration, return ``(replies, active)`` — the
        worker's stream loop ships each reply as a TAG_STREAM frame and
        keeps calling back (without blocking on the ring) while
        ``active``."""
        sched = self._decode_scheduler()
        replies: List[tuple] = []
        for corr, value in entries:
            self._total += 1
            err = sched.submit(corr, value)
            if err is not None:
                replies.append(err)
        out, active = sched.step()
        replies.extend(out)
        return replies, active

    def handle_request_decode_stream(self, value,
                                     multiplexed_model_id: str = "",
                                     request_meta: Optional[dict] = None):
        """Eager fallback for decode: a generator driving the SAME
        scheduler (so eager and compiled sequences continuous-batch
        together), yielding ``(kind, payload)`` frames. Errors raise."""
        sched = self._decode_scheduler()
        with self._decode_lock:
            self._decode_eager_seq += 1
            corr = f"eager-{self._replica_tag}-{self._decode_eager_seq}"
        err = sched.submit(corr, value, eager=True)
        if err is not None:
            exc = err[2]
            raise exc if isinstance(exc, BaseException) \
                else RuntimeError(str(exc))
        self._ongoing += 1
        self._total += 1
        try:
            done = False
            while not done:
                # the compiled corrs' replies of this iteration stay in
                # the scheduler for the decode lane's next round
                sched.step(eager=True)
                frames = sched.drain_eager(corr)
                if not frames:
                    # pool pressure is holding admission back; don't spin
                    time.sleep(0.001)
                    continue
                for _corr, kind, payload in frames:
                    if kind == "error":
                        raise payload if isinstance(payload, BaseException) \
                            else RuntimeError(str(payload))
                    yield (kind, payload)
                    if kind == "final":
                        done = True
        finally:
            sched.forget_eager(corr)
            self._ongoing -= 1

    def get_load_signal(self) -> Dict[str, Any]:
        """Router-facing load: ongoing count plus — on decode-capable
        replicas — KV-cache occupancy and prefix hit rate, so the pow-2
        router can prefer the cache-warm replica."""
        sig: Dict[str, Any] = {
            "ongoing": self.get_num_ongoing_requests(),
            "replica_tag": self._replica_tag,
        }
        sched = self._decode_sched
        if sched is not None:
            sig.update(sched.stats())
        return sig

    def reconfigure(self, user_config) -> None:
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def get_num_ongoing_requests(self) -> int:
        # the compiled plane's queued-in-ring requests are in flight on
        # this replica just as much as eager ones: the pow-2 router and
        # the autoscaler both read this
        n = self._ongoing + self._compiled_backlog()
        sched = self._decode_sched
        if sched is not None:
            st = sched.stats()
            n += st["running"] + st["waiting"]
        return n

    def stats(self) -> Dict[str, Any]:
        return {"ongoing": self._ongoing, "total": self._total,
                "replica_tag": self._replica_tag,
                "deployment": self._deployment, "ts": time.time()}

    def check_health(self) -> bool:
        if hasattr(self._callable, "check_health"):
            res = self._callable.check_health()
            return bool(res) if res is not None else True
        return True

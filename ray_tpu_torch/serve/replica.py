"""ServeReplica — the actor hosting one copy of a deployment's callable.

Port of ``ray_tpu/serve/replica.py`` on the eager actor path: unary
requests (``handle_request``), generator streams
(``handle_request_stream``) and the decode plane's stream
(``handle_request_decode_stream`` over one lazily built
``serve/decode.py:DecodeScheduler``), with the load signal, reconfigure,
stats and health check. The compiled dispatch plane's methods (the ring
batch entry, its groups and spans, ``handle_request_decode``) come with
the compiled graph; until then no request is queued in a ring, so the
ongoing count is the eager requests' and the scheduler's.

A deployment that asks ``ray_actor_options={"num_gpus": 1}`` gets its
replica on a card: the runtime binds ``CUDA_VISIBLE_DEVICES`` before
``__init__`` runs, and the decode engine is built here, in the replica,
on that card.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import threading
import time
from typing import Any, Dict, Optional

import ray_tpu_torch


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

    # ----------------------------------------------------- decode plane
    # Generative decode (serve/decode.py): every eager stream's generator
    # drives the replica's one scheduler, so sequences of concurrent
    # streams continuous-batch together (admissions between decode
    # iterations: the Orca iteration-level admission loop).

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

    def handle_request_decode_stream(self, value,
                                     multiplexed_model_id: str = "",
                                     request_meta: Optional[dict] = None):
        """The decode stream: a generator driving the replica's
        scheduler, yielding ``(kind, payload)`` frames. Errors raise."""
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
                sched.step()
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
        # the pow-2 router and the autoscaler both read this
        n = self._ongoing
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

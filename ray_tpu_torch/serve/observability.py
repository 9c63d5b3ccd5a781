"""Serve request-path observability: request ids, stage timings, access
logs, slow-request events, and the decode plane's token metrics.

Port of ``ray_tpu/serve/observability.py``, whole: every request gets a
``request_id`` at ingress (HTTP proxy / gRPC ingress / the handle for
driver-originated calls); a small ``request_meta`` dict rides the
handle -> replica actor call and a contextvar exposes it to user code and
to ``@serve.batch``. Each stage records into per-deployment tagged
histograms in the port's registry (``util/metrics.py``), under the
port's ``port_`` names:

    port_serve_request_latency_seconds      e2e, ingress -> response
    port_serve_handle_queue_wait_seconds    waiting for a replica pick
    port_serve_replica_queue_wait_seconds   dispatch -> replica start
    port_serve_batch_wait_seconds           @serve.batch assembly wait
    port_serve_exec_seconds                 user-code execution
    port_serve_dispatch_seconds             handing a request to its plane
    port_serve_itl_seconds                  decode inter-token latency

plus gauges (replica queue depth, realized batch size / utilization) and
counters (requests, errors, timeouts, shed, tokens generated). Replicas
append one JSONL line per request under ``<session_dir>/logs/serve/``,
and requests slower end-to-end than the configured threshold emit a
WARNING cluster event carrying the stage breakdown.
``RAY_TPU_SERVE_OBSERVABILITY_ENABLED=0`` turns the whole layer off.

``record_dispatch`` counts each request under its dispatch plane:
``compiled`` (a unary call on a replica's ring lane), ``compiled_bytes``
(the raw-bytes fast lane), ``compiled_stream`` (a decode stream on its
compiled lane) or ``eager`` (the actor path); ``record_shed`` counts the
requests the compiled plane's load shedder refused.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from ray_tpu_torch.core.config import global_config
from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram,
                                  aggregate_histogram, aggregate_series,
                                  percentile_from_buckets, tags_key)
from ray_tpu_torch.util.tracing import random_hex_id

# request latencies span sub-ms handle calls to minute-long generations
_LATENCY_BUCKETS = [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0]
_WAIT_BUCKETS = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]

REQUEST_LATENCY = Histogram(
    "port_serve_request_latency_seconds",
    "End-to-end Serve request latency (ingress to response)",
    boundaries=_LATENCY_BUCKETS, tag_keys=("deployment", "ingress"))
HANDLE_QUEUE_WAIT = Histogram(
    "port_serve_handle_queue_wait_seconds",
    "Time waiting in the handle router for a replica assignment",
    boundaries=_WAIT_BUCKETS, tag_keys=("deployment",))
REPLICA_QUEUE_WAIT = Histogram(
    "port_serve_replica_queue_wait_seconds",
    "Time between handle dispatch and replica execution start",
    boundaries=_WAIT_BUCKETS, tag_keys=("deployment",))
BATCH_WAIT = Histogram(
    "port_serve_batch_wait_seconds",
    "Time a request waits in @serve.batch assembly before the flush",
    boundaries=_WAIT_BUCKETS, tag_keys=("deployment",))
EXEC_TIME = Histogram(
    "port_serve_exec_seconds",
    "User-code execution time inside the replica",
    boundaries=_LATENCY_BUCKETS, tag_keys=("deployment",))
QUEUE_DEPTH = Gauge(
    "port_serve_replica_queue_depth",
    "Ongoing requests on one replica (the pow-2 routing signal)",
    tag_keys=("deployment", "replica"))
BATCH_SIZE = Gauge(
    "port_serve_batch_size",
    "Realized @serve.batch size of the most recent flush",
    tag_keys=("deployment",))
BATCH_UTILIZATION = Gauge(
    "port_serve_batch_utilization",
    "Realized batch size / max_batch_size of the most recent flush",
    tag_keys=("deployment",))
# dispatch overhead spans ~30us compiled ring hops to ~ms eager remote()
_DISPATCH_BUCKETS = [0.00001, 0.000025, 0.00005, 0.0001, 0.00025,
                     0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05, 0.25, 1.0]

DISPATCH_TIME = Histogram(
    "port_serve_dispatch_seconds",
    "Time to hand a request to its transport (compiled ring write or "
    "eager remote() submit) — the dispatch-plane overhead, per plane",
    boundaries=_DISPATCH_BUCKETS, tag_keys=("deployment", "plane"))
ITL = Histogram(
    "port_serve_itl_seconds",
    "Inter-token latency: gap between consecutive token chunks "
    "streamed for one decode sequence",
    boundaries=_WAIT_BUCKETS, tag_keys=("deployment",))
TOKENS_GENERATED = Counter(
    "port_serve_tokens_generated_total",
    "Tokens emitted by the generative-decode plane",
    tag_keys=("deployment",))
SHED = Counter(
    "port_serve_shed_total",
    "Requests shed at the dispatching process: concurrency budget "
    "exhausted with every replica admission window full",
    tag_keys=("deployment",))
REQUESTS = Counter(
    "port_serve_requests_total",
    "Serve requests completed, by deployment/ingress/status",
    tag_keys=("deployment", "ingress", "status"))
ERRORS = Counter(
    "port_serve_errors_total",
    "Serve requests that raised (routing failures included)",
    tag_keys=("deployment",))
TIMEOUTS = Counter(
    "port_serve_timeouts_total",
    "Serve requests that hit the caller's timeout",
    tag_keys=("deployment",))

def enabled() -> bool:
    return bool(global_config().serve_observability_enabled)


# hot-path tag keys, memoized per tag-value tuple: building + sorting a
# tags dict per record costs more than the record itself at request rate
_key_cache: Dict[tuple, tuple] = {}


def dep_key(deployment: str) -> tuple:
    k = ("d", deployment)
    v = _key_cache.get(k)
    if v is None:
        v = _key_cache[k] = tags_key({"deployment": deployment})
    return v


def dep_ingress_key(deployment: str, ingress: str) -> tuple:
    k = ("di", deployment, ingress)
    v = _key_cache.get(k)
    if v is None:
        v = _key_cache[k] = tags_key(
            {"deployment": deployment, "ingress": ingress})
    return v


def request_status_key(deployment: str, ingress: str,
                       status: str) -> tuple:
    k = ("dis", deployment, ingress, status)
    v = _key_cache.get(k)
    if v is None:
        v = _key_cache[k] = tags_key(
            {"deployment": deployment, "ingress": ingress,
             "status": status})
    return v


def replica_key(deployment: str, replica: str) -> tuple:
    k = ("dr", deployment, replica)
    v = _key_cache.get(k)
    if v is None:
        v = _key_cache[k] = tags_key(
            {"deployment": deployment, "replica": replica})
    return v


def dep_plane_key(deployment: str, plane: str) -> tuple:
    k = ("dp", deployment, plane)
    v = _key_cache.get(k)
    if v is None:
        v = _key_cache[k] = tags_key(
            {"deployment": deployment, "plane": plane})
    return v


def new_request_id() -> str:
    # shared PRNG helper: os.urandom/uuid4 pay a getrandom syscall per
    # call (~100us on older kernels) — see util/tracing.py
    return random_hex_id(64)


def make_request_meta(deployment: str = "", route: str = "",
                      ingress: str = "handle",
                      request_id: Optional[str] = None,
                      trace_ctx: Optional[tuple] = None) -> Dict[str, Any]:
    """The per-request record that rides handle -> replica. ``ingress_ts``
    anchors the end-to-end latency; ``trace_ctx`` parents the handle span
    under the ingress span across the proxy's thread hops."""
    return {"request_id": request_id or new_request_id(),
            "deployment": deployment, "route": route, "ingress": ingress,
            "ingress_ts": time.time(), "trace_ctx": trace_ctx}


class RequestContext:
    """Replica-side view of the in-flight request (contextvar-held), with
    a mutable timings dict the stages write into (batching adds
    ``batch_wait_s`` from its flush task before resolving the future)."""

    __slots__ = ("meta", "timings")

    def __init__(self, meta: Dict[str, Any]):
        self.meta = meta
        self.timings: Dict[str, float] = {}


_request_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "port_serve_request_ctx", default=None)


def current_request() -> Optional[RequestContext]:
    """Inside a replica: the request being handled (None outside)."""
    return _request_ctx.get()


def get_request_id() -> str:
    """Inside a replica: the request id assigned at ingress ('' outside a
    serve request)."""
    rc = _request_ctx.get()
    return rc.meta.get("request_id", "") if rc is not None else ""


def _set_request_ctx(rc: Optional[RequestContext]):
    return _request_ctx.set(rc)


def _reset_request_ctx(token) -> None:
    _request_ctx.reset(token)


# --------------------------------------------------------------------------- #
# Deferred bookkeeping: the replica's per-request metric records and
# access-log lines drain on a daemon thread — the request path only pays
# a deque append (nanoseconds). On small hosts the difference between
# "~10 bookkeeping calls inline" and "one append" is measurable on every
# request (GIL handoffs amplify inline work well past its own cost).
# --------------------------------------------------------------------------- #

_DEFER_INTERVAL_S = 0.05
_deferred: deque = deque(maxlen=100_000)
_defer_thread: Optional[threading.Thread] = None
_defer_lock = threading.Lock()


def defer(fn, *args) -> None:
    """Run ``fn(*args)`` soon on the observability drain thread."""
    global _defer_thread
    _deferred.append((fn, args))
    if _defer_thread is None:
        with _defer_lock:
            if _defer_thread is None:
                _defer_thread = threading.Thread(
                    target=_defer_loop, daemon=True, name="serve-obs")
                _defer_thread.start()


def drain_deferred() -> None:
    """Process queued bookkeeping now (tests / shutdown hook)."""
    while _deferred:
        try:
            fn, args = _deferred.popleft()
        except IndexError:
            return
        try:
            fn(*args)
        except Exception:
            pass  # observability must never fail user requests


def _defer_loop() -> None:
    while True:
        time.sleep(_DEFER_INTERVAL_S)
        drain_deferred()


def flush_all() -> None:
    """Drain queued bookkeeping AND flush access-log file buffers now —
    the process-exit hook (the daemon flushers die with the process)."""
    drain_deferred()
    for w in list(_writers.values()):
        with w._lock:
            if not w._f.closed:
                try:
                    w._f.flush()
                except OSError:
                    pass


def record_request_outcome(deployment: str, ingress: str, status: str,
                           e2e_s: float,
                           handle_queue_wait_s: Optional[float] = None,
                           timed_out: bool = False) -> None:
    """Caller-side per-request records (e2e histogram + counters),
    invoked via :func:`defer` off the request path."""
    REQUEST_LATENCY.observe(e2e_s,
                            tag_key=dep_ingress_key(deployment, ingress))
    REQUESTS.inc(tag_key=request_status_key(deployment, ingress, status))
    if handle_queue_wait_s is not None:
        HANDLE_QUEUE_WAIT.observe(handle_queue_wait_s,
                                  tag_key=dep_key(deployment))
    if status != "ok":
        ERRORS.inc(tag_key=dep_key(deployment))
        if timed_out:
            TIMEOUTS.inc(tag_key=dep_key(deployment))


def record_dispatch(deployment: str, seconds: float, plane: str) -> None:
    """Dispatch-plane overhead sample (compiled ring write vs eager
    remote() submit), invoked via :func:`defer` off the request path."""
    DISPATCH_TIME.observe(seconds, tag_key=dep_plane_key(deployment,
                                                         plane))


def record_shed(deployment: str) -> None:
    """One request refused by the proxy-side load shedder."""
    SHED.inc(tag_key=dep_key(deployment))


def record_timeout(deployment: str) -> None:
    """A caller's result() wait timed out. Counted separately from the
    request outcome: the request may still complete (and then record
    ok), or the caller may abandon it — either way the timeout signal
    lands exactly once."""
    TIMEOUTS.inc(tag_key=dep_key(deployment))


# --------------------------------------------------------------------------- #
# Access log: one JSONL line per request, per replica process
# --------------------------------------------------------------------------- #


def _session_dir() -> Optional[str]:
    from ray_tpu_torch.core.runtime import get_current_runtime

    rt = get_current_runtime()
    if rt is None:
        return None
    head = getattr(rt, "head", None)
    if head is not None:
        return head.session_dir
    return getattr(rt, "session_dir", None) or None


class _AccessLogWriter:
    """Size-capped JSONL appender with one rotation generation (same
    policy as the cluster event log). The request path only appends to
    the userspace buffer; a daemon thread pays the flush syscall a few
    times per second — a per-line flush would tax every request."""

    _FLUSH_INTERVAL_S = 0.2

    def __init__(self, path: str, max_bytes: int):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")
        self._size = self._f.tell()
        self._dirty = False
        threading.Thread(target=self._flush_loop, daemon=True,
                         name="serve-access-log").start()

    def write(self, record: dict) -> None:
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line)
            self._dirty = True
            self._size += len(line)
            if self._size >= self.max_bytes:
                try:
                    self._f.close()
                    os.replace(self.path, self.path + ".1")
                    self._f = open(self.path, "a", encoding="utf-8")
                    self._size = 0
                except OSError:
                    if self._f.closed:
                        try:
                            self._f = open(self.path, "a", encoding="utf-8")
                            self._size = self._f.tell()
                        except OSError:
                            pass

    def _flush_loop(self) -> None:
        while True:
            time.sleep(self._FLUSH_INTERVAL_S)
            with self._lock:
                if self._f.closed:
                    return
                if self._dirty:
                    self._dirty = False
                    try:
                        self._f.flush()
                    except OSError:
                        pass


_writers: Dict[str, _AccessLogWriter] = {}
_writers_lock = threading.Lock()


def access_log(deployment: str, replica_tag: str,
               record: Dict[str, Any]) -> None:
    """Append one access-log line for this replica. Never raises; no-op
    when the access log is disabled or the session dir is unknown."""
    try:
        cfg = global_config()
        if not cfg.serve_access_log_enabled:
            return
        # the controller's replica tags are "<deployment>#<suffix>", so
        # the tag alone names the file unambiguously
        key = replica_tag or deployment
        w = _writers.get(key)
        if w is None:
            with _writers_lock:
                w = _writers.get(key)
                if w is None:
                    d = _session_dir()
                    if d is None:
                        return
                    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                                   for c in key) or "replica"
                    w = _writers[key] = _AccessLogWriter(
                        os.path.join(d, "logs", "serve",
                                     f"{safe}.jsonl"),
                        cfg.serve_access_log_max_bytes)
        w.write(record)
    except Exception:
        pass  # observability must never fail user requests


# --------------------------------------------------------------------------- #
# Slow-request events
# --------------------------------------------------------------------------- #


def maybe_emit_slow_request(meta: Dict[str, Any],
                            timings: Dict[str, float],
                            e2e_s: float,
                            threshold_s: Optional[float]) -> None:
    """WARNING cluster event with the stage breakdown when e2e latency
    crosses the deployment's threshold (<= 0 disables)."""
    if threshold_s is None:
        threshold_s = global_config().serve_slow_request_threshold_s
    if threshold_s is None or threshold_s <= 0 or e2e_s < threshold_s:
        return
    try:
        from ray_tpu_torch.util import events

        stages_ms = {k[:-1] + "ms": round(v * 1000.0, 3)
                     for k, v in timings.items() if k.endswith("_s")}
        events.emit(
            "WARNING", events.SOURCE_SERVE,
            f"slow request {meta.get('request_id', '')} to "
            f"{meta.get('deployment', '')!r}: "
            f"{e2e_s * 1000.0:.0f} ms end-to-end "
            f"(threshold {threshold_s * 1000.0:.0f} ms)",
            entity_id=meta.get("deployment", ""),
            request_id=meta.get("request_id", ""),
            route=meta.get("route", ""),
            ingress=meta.get("ingress", ""),
            e2e_ms=round(e2e_s * 1000.0, 3),
            threshold_ms=round(threshold_s * 1000.0, 3),
            stages=stages_ms)
    except Exception:
        pass


# --------------------------------------------------------------------------- #
# Head-side aggregation (serve.status())
# --------------------------------------------------------------------------- #


def serve_stats(percentiles=(0.5, 0.95, 0.99)) -> Dict[str, dict]:
    """Per-deployment aggregates from the head's merged registry:
    latency percentiles (ms), request/error/timeout counts, error rate,
    summed replica queue depth, and the last realized batch size /
    utilization. Runs on the head (the only process with every source
    merged)."""
    drain_deferred()  # settle this process's queued records first
    out: Dict[str, dict] = {}

    def ent(dep: str) -> dict:
        return out.setdefault(dep, {
            "latency_ms": {}, "dispatch_ms": {}, "itl_ms": {},
            "requests": 0, "errors": 0, "timeouts": 0, "shed": 0,
            "tokens_generated": 0, "error_rate": 0.0,
            "queue_depth": 0.0})

    # latency/dispatch percentiles: merge bucket counts across tags and
    # sources per deployment, THEN take quantiles (percentiles of merged
    # buckets, not averages of per-source percentiles)
    def merged_hist(name: str) -> Dict[str, dict]:
        merged: Dict[str, dict] = {}
        for tags, v in aggregate_histogram(name).items():
            dep = dict(tags).get("deployment", "")
            acc = merged.setdefault(dep,
                                    {"sum": 0.0, "count": 0, "le": {}})
            acc["sum"] += v["sum"]
            acc["count"] += v["count"]
            for b, c in v["le"].items():
                acc["le"][b] = acc["le"].get(b, 0) + c
        return merged

    def fill_percentiles(row_key: str, name: str) -> None:
        for dep, v in merged_hist(name).items():
            row = ent(dep)
            for q in percentiles:
                label = ("p%g" % (q * 100)).replace(".", "_")
                p = percentile_from_buckets(v["le"], v["count"], q)
                row[row_key][label] = (round(p * 1000.0, 3)
                                       if p is not None else None)
            if v["count"]:
                row[row_key]["avg"] = round(
                    v["sum"] / v["count"] * 1000.0, 3)

    fill_percentiles("latency_ms", "port_serve_request_latency_seconds")
    # dispatch-plane overhead (compiled ring write vs eager submit),
    # merged across planes; per-plane counts ride alongside
    fill_percentiles("dispatch_ms", "port_serve_dispatch_seconds")
    # generative-decode inter-token latency (p50/p99 are the numbers a
    # streaming SLO is written against)
    fill_percentiles("itl_ms", "port_serve_itl_seconds")
    for tags, v in aggregate_histogram(
            "port_serve_dispatch_seconds").items():
        t = dict(tags)
        dep, plane = t.get("deployment", ""), t.get("plane", "")
        if plane:
            ent(dep).setdefault("dispatch_planes", {})
            ent(dep)["dispatch_planes"][plane] = \
                ent(dep)["dispatch_planes"].get(plane, 0) + v["count"]

    from ray_tpu_torch.util.metrics import registry

    flat = aggregate_series(registry())
    for name, field in (("port_serve_requests_total", "requests"),
                        ("port_serve_errors_total", "errors"),
                        ("port_serve_timeouts_total", "timeouts"),
                        ("port_serve_shed_total", "shed"),
                        ("port_serve_tokens_generated_total",
                         "tokens_generated")):
        for tags, value in flat.get(name, []):
            dep = dict(tags).get("deployment", "")
            ent(dep)[field] += value
    for tags, value in flat.get("port_serve_replica_queue_depth", []):
        dep = dict(tags).get("deployment", "")
        ent(dep)["queue_depth"] += value
    for name, field in (("port_serve_batch_size", "batch_size"),
                        ("port_serve_batch_utilization",
                         "batch_utilization")):
        for tags, value in flat.get(name, []):
            dep = dict(tags).get("deployment", "")
            ent(dep)[field] = value
    for row in out.values():
        if row["requests"]:
            row["error_rate"] = round(row["errors"] / row["requests"], 4)
    return out

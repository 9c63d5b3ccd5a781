"""The port's serve request-path observability
(``ray_tpu_torch/serve/observability.py``) held to the cases of
``tests/test_serve_observability.py``: request ids, access logs, stage
histograms and the span tree proxy -> handle -> replica; slow-request
events; error aggregates in ``serve.status()``; polling timeouts not
counted as errors; batch metrics; and the disabled path. Metric names
carry the port's ``port_`` prefix. The latency dashboard endpoint
(``/api/serve/latency``) waits for the port's dashboard.

One runtime serves the module (the disabled case, last, starts its own);
the proxy binds a port found free by binding port 0. Nothing here
imports JAX.
"""

import json
import os
import socket
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.core import api
from ray_tpu_torch.util import state, tracing
from ray_tpu_torch.util.metrics import registry, render_prometheus

T = 60  # seconds any one blocking call may take


def free_port() -> int:
    """A port the OS reports free: bind port 0, read it back, close."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port():
    from ray_tpu_torch.core.config import global_config

    cfg = global_config()
    # replica metrics must land on the head fast enough to assert on
    # (the config snapshot ships to workers at init)
    old = cfg.metrics_report_interval_ms
    cfg.metrics_report_interval_ms = 300
    port = free_port()
    rt.init(num_cpus=4, num_gpus=0)
    try:
        serve.start(serve.HTTPOptions(port=port))
        yield port
    finally:
        serve.shutdown()
        rt.shutdown()
        cfg.metrics_report_interval_ms = old


@pytest.fixture
def serve_instance(port):
    yield port
    for name in list(serve.status()):
        serve.delete(name)


def run_routed(app, route):
    """``serve.run``, then wait until the HTTP proxy holds ``route``: the
    proxy learns the route table by long-poll push, a moment after the
    deploy, and a request that comes first finds the old table."""
    from ray_tpu_torch.serve import api as serve_api

    handle = serve.run(app, route_prefix=route)
    deadline = time.time() + T
    while route not in serve_api._proxy._routes_cache \
            and time.time() < deadline:
        time.sleep(0.02)
    return handle


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=T) as r:
        return r.status, r.read().decode(), r.headers


def _access_log_lines():
    d = os.path.join(api._get_head().session_dir, "logs", "serve")
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        with open(os.path.join(d, name)) as f:
            out.extend(json.loads(ln) for ln in f if ln.strip())
    return out


def _merged_latency_count(deployment):
    from ray_tpu_torch.serve import observability as obs
    from ray_tpu_torch.util.metrics import aggregate_histogram

    obs.drain_deferred()  # settle the driver's queued records
    total = 0
    for tags, v in aggregate_histogram(
            "port_serve_request_latency_seconds").items():
        if dict(tags).get("deployment") == deployment:
            total += v["count"]
    return total


def test_http_requests_yield_ids_logs_histograms_and_spans(serve_instance):
    """N HTTP requests produce N unique request ids (echoed in the
    x-request-id header), N access-log JSONL lines, e2e histogram
    _count == N, and a joined span tree proxy -> handle -> replica."""
    @serve.deployment
    class Greeter:
        def __call__(self, request):
            return {"hello": serve.get_request_id()}

    run_routed(Greeter.bind(), "/greet")
    # delta-based: the driver's registry outlives a deployment
    base_count = _merged_latency_count("Greeter")
    N = 8
    header_ids, body_ids = [], []
    for _ in range(N):
        status, body, headers = _get(serve_instance, "/greet")
        assert status == 200
        header_ids.append(headers.get("x-request-id"))
        body_ids.append(json.loads(body)["hello"])
    assert len(set(header_ids)) == N
    assert header_ids == body_ids

    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        lines = [ln for ln in _access_log_lines()
                 if ln["deployment"] == "Greeter"]
        if len(lines) >= N:
            break
        time.sleep(0.1)
    assert len(lines) == N
    assert {ln["request_id"] for ln in lines} == set(header_ids)
    for ln in lines:
        assert ln["status"] == "ok" and ln["route"] == "/greet"
        assert ln["replica"].startswith("Greeter#")
        assert "exec_ms" in ln["timings_ms"]
        assert "replica_queue_wait_ms" in ln["timings_ms"]

    assert _merged_latency_count("Greeter") - base_count == N

    # replica-side stage histograms flush over the worker channel
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        text = render_prometheus(registry())
        if "port_serve_exec_seconds_count" in text \
                and "port_serve_replica_queue_wait_seconds" in text:
            break
        time.sleep(0.2)
    from prom_parser import parse_exposition, parse_histograms

    parse_exposition(text)  # every line conformant
    hists = parse_histograms(text)
    for fam in ("port_serve_request_latency_seconds",
                "port_serve_handle_queue_wait_seconds",
                "port_serve_replica_queue_wait_seconds",
                "port_serve_exec_seconds"):
        assert fam in hists and hists[fam], fam

    # span tree: the root span carries the request id; the handle span
    # parents under it and the replica task span under the handle span
    rid = header_ids[0]
    spans = tracing.get_spans(timeout=10)
    mine = [s for s in spans
            if (s.get("attrs") or {}).get("request_id") == rid]
    assert mine, "no spans tagged with the request id"
    trace_id = mine[0]["trace_id"]
    tree = [s for s in spans if s["trace_id"] == trace_id]
    by_id = {s["span_id"]: s for s in tree}
    root = next(s for s in tree if s["parent_id"] is None)
    assert root["name"].startswith("serve.http")
    handle_span = next(s for s in tree
                       if s["name"] == "serve.handle.Greeter")
    assert handle_span["parent_id"] == root["span_id"]
    replica_span = next(s for s in tree if "handle_request" in s["name"])
    assert by_id[replica_span["parent_id"]] is handle_span


def test_slow_request_emits_warning_event_with_stages(serve_instance):
    @serve.deployment(slow_request_threshold_s=0.05)
    class Sleepy:
        def __call__(self, request):
            time.sleep(0.25)
            return "done"

    run_routed(Sleepy.bind(), "/sleepy")
    status, _, headers = _get(serve_instance, "/sleepy")
    assert status == 200
    rid = headers.get("x-request-id")

    deadline = time.monotonic() + 10
    slow = []
    while time.monotonic() < deadline and not slow:
        evs = state.list_cluster_events(source="SERVE",
                                        min_severity="WARNING")
        slow = [e for e in evs if e["attrs"].get("request_id") == rid]
        time.sleep(0.1)
    assert slow, "no slow-request WARNING event"
    ev = slow[0]
    assert ev["severity"] == "WARNING"
    assert ev["entity_id"] == "Sleepy"
    assert ev["attrs"]["e2e_ms"] >= 250
    stages = ev["attrs"]["stages"]
    assert stages["exec_ms"] >= 200
    assert "replica_queue_wait_ms" in stages
    assert "handle_queue_wait_ms" in stages


def test_errors_and_status_aggregates(serve_instance):
    @serve.deployment
    class Flaky:
        def __call__(self, request):
            if request.query_params.get("boom"):
                raise ValueError("boom")
            return "ok"

    run_routed(Flaky.bind(), "/flaky")
    for _ in range(4):
        assert _get(serve_instance, "/flaky")[0] == 200
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(serve_instance, "/flaky?boom=1")
    assert ei.value.code == 500

    st = serve.status()["Flaky"]
    assert st["requests"] == 5
    assert st["errors"] == 1
    assert st["error_rate"] == pytest.approx(0.2)
    assert st["latency_ms"]["p50"] is not None
    assert st["latency_ms"]["p99"] is not None
    # every request took the eager plane
    assert st["dispatch_planes"] == {"eager": 5}

    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        lines = [ln for ln in _access_log_lines()
                 if ln["deployment"] == "Flaky" and ln["status"] == "error"]
        if lines:
            break
        time.sleep(0.1)
    assert lines


def test_polling_result_timeout_not_recorded_as_error(serve_instance):
    """result() is future-like and re-callable: a caller polling with
    short timeouts must not pin the request as an error — the timeout
    signal counts once, and the eventual success records ok."""
    @serve.deployment
    class Slowish:
        def __call__(self, x):
            time.sleep(0.8)
            return "done"

    handle = serve.run(Slowish.bind(), route_prefix=None)
    r = handle.remote(None)
    timeouts = 0
    deadline = time.monotonic() + 30
    while True:
        try:
            v = r.result(timeout=0.1)
            break
        except TimeoutError:
            timeouts += 1
            assert time.monotonic() < deadline
    assert v == "done" and timeouts >= 1
    st = serve.status()["Slowish"]
    assert st["errors"] == 0
    assert st["requests"] == 1
    assert st["timeouts"] == 1  # once, however many polls timed out
    assert st["error_rate"] == 0.0


def test_batching_records_wait_and_size(serve_instance):
    @serve.deployment
    class Batcher:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def go(self, xs):
            return [x * 10 for x in xs]

        async def __call__(self, x):
            return await self.go(x)

    handle = serve.run(Batcher.bind(), route_prefix=None)
    rs = [handle.remote(i) for i in range(8)]
    assert sorted(r.result(timeout=T) for r in rs) == [
        i * 10 for i in range(8)]

    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        text = render_prometheus(registry())
        if "port_serve_batch_wait_seconds_count" in text:
            break
        time.sleep(0.2)
    assert "port_serve_batch_wait_seconds" in text
    assert "port_serve_batch_size" in text
    assert "port_serve_batch_utilization" in text
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        lines = [ln for ln in _access_log_lines()
                 if ln["deployment"] == "Batcher"]
        if any("batch_wait_ms" in ln["timings_ms"] for ln in lines):
            break
        time.sleep(0.1)
    assert any("batch_wait_ms" in ln["timings_ms"] for ln in lines)


def test_observability_disabled_is_clean(port, monkeypatch):
    """With serve observability off the request path runs
    uninstrumented: no serve histograms, no access logs. Needs a runtime
    of its own: the config snapshot ships to workers at init."""
    from ray_tpu_torch.core.config import global_config

    serve.shutdown()
    rt.shutdown()
    monkeypatch.setattr(global_config(),
                        "serve_observability_enabled", False)
    rt.init(num_cpus=2, num_gpus=0)
    try:
        serve.start(serve.HTTPOptions(port=free_port()))

        @serve.deployment
        def plain(x):
            return {"v": x}

        handle = serve.run(plain.bind(), route_prefix=None)
        assert handle.remote(3).result(timeout=T) == {"v": 3}
        d = os.path.join(api._get_head().session_dir, "logs", "serve")
        assert not os.path.isdir(d) or not os.listdir(d)
        assert _merged_latency_count("plain") == 0
    finally:
        serve.shutdown()

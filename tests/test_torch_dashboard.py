"""The port's dashboard (``ray_tpu_torch/dashboard/``), job submission
(``ray_tpu_torch/jobs/``) and CLI (``python -m ray_tpu_torch``), held to
the JAX package's own cases on the CPU:

- ``tests/test_client_jobs.py``: the dashboard's endpoints, a job's
  lifecycle (its driver joins the head and runs the port's code) and a
  job stopped;
- ``tests/test_serve_observability.py:286``: ``/api/serve/latency`` and
  the serve access logs through the node agent;
- the CLI uses of ``tests/test_memory_observability.py:180`` (``memory``
  renders ``/api/memory``), ``tests/test_goodput.py:458`` and
  ``tests/test_flight_recorder.py:595`` (``timeline --input``), and
  ``python -m ray_tpu_torch --help`` listing the commands.

Nothing here imports JAX.
"""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as rt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds any one blocking call may take


def _get(url, timeout=T):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture
def dashboard_cluster(tmp_path):
    from ray_tpu_torch.dashboard import start_dashboard

    rt.init(num_cpus=4, num_gpus=0)
    dash = start_dashboard(port=0)
    dash.job_manager._log_dir = str(tmp_path)
    base = f"http://{dash.address[0]}:{dash.address[1]}"
    yield base
    dash.stop()
    if dash.job_manager:
        dash.job_manager.shutdown()
    rt.shutdown()


def test_dashboard_endpoints(dashboard_cluster):
    base = dashboard_cluster
    cluster = _get(base + "/api/cluster")
    assert "total" in cluster and "available" in cluster
    nodes = _get(base + "/api/nodes")
    assert len(nodes) == 1 and nodes[0]["alive"]
    with urllib.request.urlopen(base + "/", timeout=T) as r:
        assert b"ray_tpu_torch dashboard" in r.read()
    with urllib.request.urlopen(base + "/metrics", timeout=T) as r:
        assert r.status == 200   # prometheus text (may be empty here)
    for path in ("/api/events", "/api/goodput", "/api/xla",
                 "/api/metrics/history", "/api/serve", "/api/timeline",
                 "/api/memory", "/api/stacks?duration_ms=50"):
        _get(base + path)
    assert _get(base + "/api/xla")["platform"] == "cpu"


def test_job_lifecycle(dashboard_cluster):
    from ray_tpu_torch.jobs import JobStatus, JobSubmissionClient

    client = JobSubmissionClient(dashboard_cluster)
    code = ("import sys, ray_tpu_torch as rt; rt.init(); "
            "f = rt.remote(lambda x: x + 1); "
            "print('JOBVAL', rt.get(f.remote(41)), "
            "'jax' in sys.modules); "
            "rt.shutdown()")
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"{code}\"",
        runtime_env={"env_vars": {"PYTHONPATH": REPO}},
        metadata={"who": "test"})
    deadline = time.time() + 120
    while time.time() < deadline:
        if client.get_job_status(sid) in JobStatus.TERMINAL:
            break
        time.sleep(0.5)
    assert client.get_job_status(sid) == JobStatus.SUCCEEDED, \
        client.get_job_logs(sid)
    # the driver joined the head and ran the port's code, without JAX
    assert "JOBVAL 42 False" in client.get_job_logs(sid)
    with urllib.request.urlopen(
            f"{dashboard_cluster}/api/jobs/{sid}/logs", timeout=T) as r:
        assert "JOBVAL 42" in r.read().decode()
    assert any(j["submission_id"] == sid for j in client.list_jobs())
    assert client.get_job_info(sid)["metadata"] == {"who": "test"}
    assert client.delete_job(sid)


def test_job_stop(dashboard_cluster):
    from ray_tpu_torch.jobs import JobStatus, JobSubmissionClient

    client = JobSubmissionClient(dashboard_cluster)
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
    time.sleep(0.5)
    assert client.stop_job(sid)
    deadline = time.time() + 15
    while time.time() < deadline:
        if client.get_job_status(sid) == JobStatus.STOPPED:
            break
        time.sleep(0.2)
    assert client.get_job_status(sid) == JobStatus.STOPPED


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_latency_dashboard_endpoint():
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.config import global_config
    from ray_tpu_torch.dashboard import start_dashboard

    cfg = global_config()
    saved = cfg.metrics_report_interval_ms
    cfg.metrics_report_interval_ms = 300
    port = _free_port()
    rt.init(num_cpus=4, num_gpus=0)
    dash = None
    try:
        serve.start(serve.HTTPOptions(port=port))

        @serve.deployment
        def hello(x):
            return "hi"

        serve.run(hello.bind(), route_prefix="/hello")
        dash = start_dashboard(port=0, with_jobs=False)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/hello",
                                    timeout=T) as r:
            assert r.status == 200
        base = f"http://127.0.0.1:{dash.address[1]}"
        deadline = time.monotonic() + T
        stats = {}
        while time.monotonic() < deadline:
            stats = _get(base + "/api/serve/latency")
            if stats.get("hello", {}).get("requests", 0) >= 1:
                break
            time.sleep(0.2)
        assert stats["hello"]["requests"] >= 1
        assert stats["hello"]["latency_ms"]["p50"] is not None
        # the serve access logs are browsable through the node agent
        node_hex = rt.nodes()[0]["NodeID"]
        deadline = time.monotonic() + 10
        serve_logs, logs = [], []
        while time.monotonic() < deadline and not serve_logs:
            logs = _get(f"{base}/api/nodes/{node_hex}/logs")
            serve_logs = [entry["name"] for entry in logs
                          if entry["name"].startswith("serve/")]
            time.sleep(0.1)
        assert serve_logs, logs
        deadline = time.monotonic() + 10
        tail = {"text": ""}
        while time.monotonic() < deadline \
                and "request_id" not in tail["text"]:
            tail = _get(f"{base}/api/nodes/{node_hex}/logs/{serve_logs[0]}")
            time.sleep(0.1)
        assert "request_id" in tail["text"]
    finally:
        if dash is not None:
            dash.stop()
        serve.shutdown()
        rt.shutdown()
        cfg.metrics_report_interval_ms = saved


@pytest.fixture
def record_sites(monkeypatch):
    """Callsite capture and fast ref reports for the test."""
    from ray_tpu_torch.core import ref_tracker
    from ray_tpu_torch.core.config import global_config

    cfg = global_config()
    monkeypatch.setattr(cfg, "record_ref_creation_sites", True)
    monkeypatch.setattr(cfg, "ref_report_interval_ms", 200)
    ref_tracker.refresh_flags()
    yield
    monkeypatch.undo()
    ref_tracker.refresh_flags()


def test_memory_cli_renders_the_api(record_sites):
    from ray_tpu_torch.__main__ import main as cli_main
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.util import state

    rt.init(num_cpus=2, num_gpus=0)
    dash = None
    try:
        refs = [rt.put(np.full(400_000, i, dtype=np.uint8))
                for i in range(3)]
        small = rt.put({"k": 1})
        summary = state.memory_summary(group_by="callsite")
        totals = summary["totals"]
        assert totals["objects"] >= 4 and totals["arena_bytes"] >= 1_200_000
        dash = start_dashboard(port=0, with_jobs=False)
        base = f"http://127.0.0.1:{dash.address[1]}"
        body = _get(base + "/api/memory?group_by=callsite")
        assert body["totals"] == totals
        assert body["groups"][0]["group"] == summary["groups"][0]["group"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli_main(["memory", "--address", base]) == 0
        out = buf.getvalue()
        m = re.search(r"total: (\d+) objects, (\d+) bytes "
                      r"\(inline (\d+), arena (\d+), spilled (\d+)\)", out)
        assert m, out
        assert int(m.group(1)) == totals["objects"]
        assert int(m.group(2)) == totals["bytes"]
        assert int(m.group(4)) == totals["arena_bytes"]
        assert "test_torch_dashboard" in out
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli_main(["list", "nodes", "--address", base]) == 0
        assert json.loads(buf.getvalue())[0]["alive"]
        del refs, small
    finally:
        if dash is not None:
            dash.stop()
        rt.shutdown()


def _ev(name, ts_s, dur_s):
    return {"name": name, "cat": "span", "ph": "X", "pid": "p",
            "tid": "t", "ts": ts_s * 1e6, "dur": dur_s * 1e6,
            "args": {"source": "p"}}


def test_timeline_cli_goodput_and_both_trace_shapes(tmp_path, capsys):
    from ray_tpu_torch.__main__ import main as cli_main

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps([_ev("spmd.compile", 0.0, 1.0),
                                 _ev("spmd.compute", 1.0, 3.0)]))
    assert cli_main(["timeline", "--input", str(trace), "--goodput"]) == 0
    out = capsys.readouterr().out
    assert "goodput" in out and "75.00%" in out

    ev = _ev("dag.exec", 0.001, 0.002)
    flat = tmp_path / "flat.json"
    flat.write_text(json.dumps([ev]))
    wrapped = tmp_path / "wrapped.json"
    wrapped.write_text(json.dumps({"traceEvents": [ev]}))
    for src in (flat, wrapped):
        out_json = tmp_path / (src.stem + "_out.json")
        assert cli_main(["timeline", "--input", str(src), "--perfetto",
                         str(out_json), "--attribute"]) == 0
        assert len(json.loads(out_json.read_text())) == 1


def test_cli_help_lists_the_commands():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"],
                         env=env, capture_output=True, text=True,
                         timeout=T)
    assert out.returncode == 0, out.stderr
    for cmd in ("head", "start", "submit", "job", "list", "memory",
                "timeline", "goodput", "xla", "stack", "up", "down",
                "cluster-status"):
        assert cmd in out.stdout, cmd
    assert "lint is not ported" in out.stdout
    head = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "head", "--help"],
        env=env, capture_output=True, text=True, timeout=T)
    assert "--num-gpus" in head.stdout and "--num-tpus" not in head.stdout

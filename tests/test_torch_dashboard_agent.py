"""The port's per-node dashboard agent (``ray_tpu_torch/dashboard/
agent.py``), held to the JAX package's case
(``tests/test_dashboard_agent.py``): a separate-process node daemon
starts its agent and advertises it; the head dashboard proxies
``/api/nodes/<hex>/*`` to it (logs, metrics with the node's cards, a
``torch.profiler`` capture), serves the in-process head node directly,
and answers 404 for an unknown node. Nothing here imports JAX."""

import json
import time
import urllib.error
import urllib.request

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.dashboard import start_dashboard


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post(url, body, timeout=90):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_node_agent_logs_metrics_profile_on_a_daemon():
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    daemon = cluster.add_node(num_cpus=1, separate_process=True,
                              resources={"far": 1})
    dash = None
    try:
        assert daemon.agent_addr is not None   # advertised at join

        @rt.remote(resources={"far": 1})
        def chatty(i):
            print(f"agent-test-line-{i}")
            return rt.get_runtime_context().get_node_id()

        assert set(rt.get([chatty.remote(i) for i in range(2)],
                          timeout=120)) == {daemon.hex}
        dash = start_dashboard(port=0, with_jobs=False)
        base = f"http://127.0.0.1:{dash.address[1]}"
        d = daemon.hex

        # --- log module: list + tail through the head proxy ---
        found, logs = False, []
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not found:
            logs = _get(f"{base}/api/nodes/{d}/logs")
            for entry in logs:
                body = _get(f"{base}/api/nodes/{d}/logs/"
                            f"{entry['name']}?offset=0")
                if "agent-test-line-" in body["text"]:
                    found = True
                    break
            if not found:
                time.sleep(0.5)
        assert found, f"worker stdout not visible via the agent: {logs}"
        tail = _get(f"{base}/api/nodes/{d}/logs/{logs[-1]['name']}"
                    "?offset=-50")
        assert tail["next_offset"] >= 0

        # --- reporter module: metrics snapshot with the node's cards ---
        m = _get(f"{base}/api/nodes/{d}/metrics")
        assert m["node_hex"] == d and m["max_workers"] >= 1
        assert isinstance(m["devices"], list)   # empty without a card
        assert isinstance(m["metrics"], dict)

        # --- profile trigger round trip (torch.profiler in the daemon) ---
        prof = _post(f"{base}/api/nodes/{d}/profile", {"duration_ms": 200})
        assert prof["files"] and prof["files"][0].endswith(".json")

        # --- the in-process head node, served without an HTTP hop ---
        head_hex = cluster.head.head_node.hex
        assert _get(f"{base}/api/nodes/{head_hex}/metrics")["node_hex"] \
            == head_hex

        # --- unknown node is a 404, not a hang ---
        try:
            _get(f"{base}/api/nodes/{'0' * 32}/metrics")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        if dash is not None:
            dash.stop()
        cluster.shutdown()


def test_query_cards_reads_nvidia_smi(monkeypatch, tmp_path):
    """The agent's card readings parse ``nvidia-smi``'s CSV and keep the
    cards ``CUDA_VISIBLE_DEVICES`` names."""
    from ray_tpu_torch.util import device_telemetry

    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\n"
                   "echo '0, NVIDIA H100 80GB HBM3, 1234, 81559, 37, "
                   "120.50, 700.00'\n"
                   "echo '1, NVIDIA H100 80GB HBM3, 1, 81559, 0, "
                   "[N/A], 700.00'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:/usr/bin:/bin")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert device_telemetry.query_cards() == [{
        "index": 1, "name": "NVIDIA H100 80GB HBM3",
        "memory_used_mib": 1.0, "memory_total_mib": 81559.0,
        "utilization_pct": 0.0, "power_draw_w": None,
        "power_limit_w": 700.0}]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    cards = device_telemetry.query_cards()
    assert [c["index"] for c in cards] == [0, 1]
    assert cards[0]["memory_used_mib"] == 1234.0

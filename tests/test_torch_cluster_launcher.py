"""The port's cluster launcher (``ray_tpu_torch/cluster_launcher.py``):
YAML -> head + autoscaler + dashboard, ``up``/``down`` from separate
processes, held to the JAX package's cases
(``tests/test_cluster_launcher.py``). Nothing here imports JAX."""

import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_yaml(tmp_path, name, min_workers=1, max_workers=2):
    cfg = textwrap.dedent(f"""
        cluster_name: {name}
        min_workers: {min_workers}
        max_workers: {max_workers}
        idle_timeout_s: 60
        provider:
          type: local
        head:
          num_cpus: 1
          num_gpus: 0
          dashboard_port: 0
        worker_nodes:
          num_cpus: 2
          num_gpus: 0
    """)
    path = tmp_path / "cluster.yaml"
    path.write_text(cfg)
    return str(path)


def test_config_validation(tmp_path):
    from ray_tpu_torch.cluster_launcher import load_cluster_config

    p = tmp_path / "bad.yaml"
    p.write_text("min_workers: 1\n")
    with pytest.raises(ValueError, match="cluster_name"):
        load_cluster_config(str(p))
    cfg = load_cluster_config(_write_yaml(tmp_path, "ok"))
    assert cfg["cluster_name"] == "ok"
    assert cfg["worker_nodes"]["num_cpus"] == 2
    bad = tmp_path / "tpu.yaml"
    bad.write_text("cluster_name: x\nprovider:\n  type: tpu_slice\n")
    from ray_tpu_torch.cluster_launcher import _make_provider

    with pytest.raises(ValueError, match="unknown provider"):
        _make_provider(load_cluster_config(str(bad)), head=None)


def test_up_status_down_cross_process(tmp_path):
    """`up` in a child process; status + a remote driver + `down` from
    this one — the full operator flow."""
    from ray_tpu_torch.cluster_launcher import read_cluster_state, status

    name = f"torch-launch-{os.getpid()}"
    yaml_path = _write_yaml(tmp_path, name, min_workers=1)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "up", yaml_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 120
        state = None
        while time.time() < deadline:
            state = read_cluster_state(name)
            if state:
                break
            time.sleep(0.5)
        assert state, "cluster state file never appeared"
        deadline = time.time() + 120
        nodes = []
        while time.time() < deadline:
            state = read_cluster_state(name) or state
            host, port = state["dashboard"]
            try:
                with urllib.request.urlopen(
                        f"http://{host}:{port}/api/nodes", timeout=5) as r:
                    nodes = json.loads(r.read().decode())
                if len([n for n in nodes if n["alive"]]) >= 2:
                    break  # head + min_workers=1
            except Exception:
                pass
            time.sleep(0.5)
        assert len([n for n in nodes if n["alive"]]) >= 2, nodes
        st = status(yaml_path)
        assert st["alive"] and len(st["nodes"]) >= 2

        # a remote driver connects through the launched cluster
        ch, cp = state["client_address"]
        code = ("import ray_tpu_torch as rt; rt.init(); "
                "f = rt.remote(lambda x: x * 7); "
                "print('UP', rt.get(f.remote(6))); "
                "rt.shutdown()")
        cenv = dict(env)
        cenv["RAY_TPU_ADDRESS"] = f"ray_tpu://{ch}:{cp}"
        cenv["RAY_TPU_CLUSTER_KEY"] = state["cluster_key"]
        out = subprocess.run([sys.executable, "-c", code], env=cenv,
                             capture_output=True, text=True, timeout=120)
        assert "UP 42" in out.stdout, (out.stdout, out.stderr)

        # down from a separate process, through the CLI
        rc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "down", yaml_path],
            env=env, capture_output=True, text=True, timeout=60)
        assert rc.returncode == 0, rc.stdout + rc.stderr
        deadline = time.time() + 30
        while time.time() < deadline and proc.poll() is None:
            time.sleep(0.3)
        assert proc.poll() is not None, "head process did not exit"
        assert status(yaml_path)["alive"] is False
    finally:
        if proc.poll() is None:
            proc.kill()

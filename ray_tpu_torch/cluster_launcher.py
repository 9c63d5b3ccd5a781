"""Cluster launcher: bring a whole cluster up from a YAML spec (port of
``ray_tpu/cluster_launcher.py``).

Reference: the ``ray up cluster.yaml`` launcher
(python/ray/scripts/scripts.py ``up``/``down`` + autoscaler/_private/
commands.py create_or_update_cluster; cluster YAML schema per
autoscaler/ray-schema.json). Same operator surface here:

    python -m ray_tpu_torch up cluster.yaml     # head + autoscaler + dashboard
    python -m ray_tpu_torch down cluster.yaml   # terminate workers, stop head
    python -m ray_tpu_torch cluster-status cluster.yaml

Schema (all keys optional except cluster_name)::

    cluster_name: demo
    min_workers: 1
    max_workers: 4
    idle_timeout_s: 60
    provider:
      type: local            # local | module:attr of a NodeProvider
                             # factory (e.g. a CallbackNodeProvider)
    head:
      num_cpus: 4
      num_gpus: 0            # default: the cards visible to the head
      dashboard_port: 8265
      host: 0.0.0.0
      storage: null          # durable GCS tables path
    worker_nodes:            # node_config handed to the provider
      num_cpus: 2
      num_gpus: 0            # cards each worker node takes

``up`` runs the head in the foreground (Ctrl-C = down) and records a
state file under ``<tmp>/ray_tpu_torch_clusters/<name>.json`` so
``down``/``status``
from another terminal can find it.
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
import time
from typing import Any, Dict, Optional

_STATE_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_clusters")


def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if not cfg.get("cluster_name"):
        raise ValueError("cluster YAML needs a cluster_name")
    cfg.setdefault("min_workers", 0)
    cfg.setdefault("max_workers", 2)
    cfg.setdefault("idle_timeout_s", 60.0)
    cfg.setdefault("provider", {"type": "local"})
    cfg.setdefault("head", {})
    cfg.setdefault("worker_nodes", {"num_cpus": 1})
    return cfg


def _state_path(name: str) -> str:
    os.makedirs(_STATE_DIR, exist_ok=True)
    return os.path.join(_STATE_DIR, f"{name}.json")


def _write_state(name: str, state: Dict[str, Any]) -> None:
    with open(_state_path(name), "w") as f:
        json.dump(state, f, indent=2)


def read_cluster_state(name: str) -> Optional[Dict[str, Any]]:
    try:
        with open(_state_path(name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _pid_is_our_head(pid: int) -> bool:
    """True iff ``pid`` is alive AND still a ray_tpu_torch head — guards a
    recycled PID from an uncleanly-died head's stale state file (sending
    SIGKILL to whatever now owns the number would be unforgivable)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return False  # someone else's process: certainly not our head
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = f.read()
        return b"ray_tpu_torch" in cmdline or b"cluster_launcher" in cmdline
    except OSError:
        # no /proc (non-Linux): alive + same-user is the best we can say
        return True


def _make_provider(cfg: Dict[str, Any], head):
    from ray_tpu_torch.autoscaler import LocalNodeProvider

    ptype = (cfg.get("provider") or {}).get("type", "local")
    if ptype == "local":
        addr = head.start_node_server(
            host=cfg.get("head", {}).get("host", "127.0.0.1"))
        return LocalNodeProvider(addr, head.cluster_key_hex)
    if ":" in ptype:  # custom factory "pkg.module:factory"
        import importlib

        mod_name, attr = ptype.split(":", 1)
        factory = getattr(importlib.import_module(mod_name), attr)
        return factory(cfg, head)
    raise ValueError(f"unknown provider type {ptype!r}")


def up(config_path: str, block: bool = True):
    """Start head + client server + dashboard + autoscaler per the YAML.

    Returns (head, autoscaler, dashboard) when ``block=False`` (tests);
    otherwise parks until Ctrl-C then tears the cluster down.
    """
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import Autoscaler, AutoscalerConfig
    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.dashboard import start_dashboard

    cfg = load_cluster_config(config_path)
    name = cfg["cluster_name"]
    head_cfg = cfg.get("head") or {}
    ray_tpu_torch.init(num_cpus=head_cfg.get("num_cpus"),
                       num_gpus=head_cfg.get("num_gpus"),
                       storage=head_cfg.get("storage"))
    head = _api._get_head()
    host = head_cfg.get("host", "127.0.0.1")
    addr, key = ray_tpu_torch.start_client_server(host=host)
    dash = start_dashboard(host=host,
                           port=int(head_cfg.get("dashboard_port", 8265)))
    provider = _make_provider(cfg, head)
    scaler = Autoscaler(head, provider, AutoscalerConfig(
        min_workers=int(cfg["min_workers"]),
        max_workers=int(cfg["max_workers"]),
        idle_timeout_s=float(cfg["idle_timeout_s"]),
        node_config=dict(cfg.get("worker_nodes") or {})))
    _write_state(name, {
        "cluster_name": name,
        "pid": os.getpid(),
        "client_address": list(addr),
        "cluster_key": key,
        "dashboard": list(dash.address),
        "started_at": time.time(),
        "config_path": os.path.abspath(config_path),
    })
    print(f"cluster {name!r} is up.")
    print(f"  client address : ray_tpu://{addr[0]}:{addr[1]}")
    print(f"  cluster key    : {key}")
    print(f"  dashboard      : http://{dash.address[0]}:{dash.address[1]}")
    if dash.auth_token:
        print(f"  job auth token : {dash.auth_token}")
    print(f"  workers        : min={cfg['min_workers']} "
          f"max={cfg['max_workers']} provider="
          f"{(cfg.get('provider') or {}).get('type')}", flush=True)
    if not block:
        return head, scaler, dash

    # `down` sends SIGINT then escalates to SIGTERM; a backgrounded head
    # (shell job control sets SIGINT to ignore) must still tear down
    def _terms(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _terms)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        print(f"tearing down cluster {name!r}...")
        scaler.stop(terminate_nodes=True)
        dash.stop()
        ray_tpu_torch.shutdown()
        try:
            os.remove(_state_path(name))
        except OSError:
            pass
    return None


def down(config_path: str, timeout: float = 15.0) -> bool:
    """Stop a cluster started by ``up`` (SIGINT to its head process)."""
    cfg = load_cluster_config(config_path)
    state = read_cluster_state(cfg["cluster_name"])
    if state is None:
        print(f"no state for cluster {cfg['cluster_name']!r}; nothing to do")
        return False
    pid = state["pid"]

    def _gone() -> bool:
        return not _pid_is_our_head(pid)

    if _gone():
        try:
            os.remove(_state_path(cfg["cluster_name"]))
        except OSError:
            pass
        print("head process already gone; state cleared")
        return True
    # SIGINT first (foreground Ctrl-C analog), then SIGTERM (backgrounded
    # heads ignore SIGINT under shell job control), then SIGKILL
    for sig, wait_s in ((signal.SIGINT, timeout / 2),
                        (signal.SIGTERM, timeout / 2)):
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            break
        deadline = time.time() + wait_s
        while time.time() < deadline:
            if _gone():
                print(f"cluster {cfg['cluster_name']!r} is down")
                return True
            time.sleep(0.2)
    if not _gone():
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        print(f"cluster {cfg['cluster_name']!r} force-killed")
    return True


def status(config_path: str) -> Dict[str, Any]:
    """Liveness + dashboard-reported cluster view for a launched cluster."""
    cfg = load_cluster_config(config_path)
    state = read_cluster_state(cfg["cluster_name"])
    if state is None:
        return {"cluster_name": cfg["cluster_name"], "alive": False}
    alive = _pid_is_our_head(state["pid"])
    out = {"cluster_name": cfg["cluster_name"], "alive": alive, **state}
    if alive:
        try:
            import urllib.request

            host, port = state["dashboard"]
            with urllib.request.urlopen(
                    f"http://{host}:{port}/api/nodes", timeout=5) as r:
                out["nodes"] = json.loads(r.read().decode())
        except Exception:
            pass
    return out

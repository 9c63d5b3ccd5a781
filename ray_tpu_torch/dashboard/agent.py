"""Per-node dashboard agent: logs, metrics, profiling for ONE node.

Analog of the reference's per-node dashboard agent
(python/ray/dashboard/agent.py:26) with its ``log`` and ``reporter``
modules (port of ``ray_tpu/dashboard/agent.py``): every node process —
separate-process daemons and the in-process head node alike — exposes
its own worker log files, a local metrics snapshot with the node's cards
(:func:`~ray_tpu_torch.util.device_telemetry.query_cards`), and an
on-demand ``torch.profiler`` trace trigger (util/timeline.profile_trace
-> Chrome trace JSON). The head dashboard
proxies ``/api/nodes/<hex>/...`` here (daemons over HTTP, local nodes by
direct call), so per-node debugging does not route log bytes through the
head's control channel.

Endpoints (agent HTTP server, also callable via NodeAgentCore):
    GET  /healthz
    GET  /api/logs                     list log files (name, size)
    GET  /api/logs/<name>?offset=&limit=   tail one file
    GET  /api/metrics                  node + process metrics snapshot,
                                       and the node's cards
    POST /api/profile {duration_ms}    capture a profiler trace
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional, Tuple


class NodeAgentCore:
    """The agent's functionality, HTTP-free (the head calls this directly
    for in-process nodes; the HTTP server wraps it for daemons)."""

    def __init__(self, node):
        self.node = node

    # ---- log module (reference: dashboard/modules/log) ------------------

    def _log_dir(self) -> str:
        return os.path.join(self.node.session_dir, "logs")

    def list_logs(self) -> list:
        """Top-level log files plus one level of subdirectories (the
        serve access logs live under ``logs/serve/``; events under
        ``logs/events/``) as ``sub/name`` entries."""
        d = self._log_dir()
        if not os.path.isdir(d):
            return []
        out = []

        def add(display: str, path: str) -> None:
            try:
                # rotating writers os.replace() files away between the
                # listdir and the stat — skip, don't 500 the listing
                out.append({"name": display,
                            "size": os.path.getsize(path)})
            except OSError:
                pass

        for name in sorted(os.listdir(d)):
            p = os.path.join(d, name)
            if os.path.isfile(p):
                add(name, p)
            elif os.path.isdir(p) and not name.startswith("."):
                for sub in sorted(os.listdir(p)):
                    sp = os.path.join(p, sub)
                    if os.path.isfile(sp):
                        add(f"{name}/{sub}", sp)
        return out

    def read_log(self, name: str, offset: int = 0,
                 limit: int = 64 * 1024) -> Tuple[str, int]:
        """(text, next_offset). ``name`` is a top-level file or a single
        ``sub/name`` path (no traversal outside the log dir)."""
        parts = name.split("/")
        if (len(parts) > 2 or not all(parts)
                or any(os.path.basename(s) != s or s.startswith(".")
                       for s in parts)):
            raise FileNotFoundError(name)
        p = os.path.join(self._log_dir(), *parts)
        if not os.path.isfile(p):
            raise FileNotFoundError(name)
        size = os.path.getsize(p)
        if offset < 0:  # negative offset = tail the last |offset| bytes
            offset = max(0, size + offset)
        with open(p, "rb") as f:
            f.seek(offset)
            data = f.read(max(0, min(limit, 4 * 1024 * 1024)))
        return data.decode("utf-8", "replace"), offset + len(data)

    # ---- reporter module (reference: dashboard/modules/reporter) --------

    def metrics(self) -> dict:
        from ray_tpu_torch.util.device_telemetry import query_cards
        from ray_tpu_torch.util.metrics import registry

        node = self.node
        with node._lock:
            queue_depth = len(node._local_queue)
            workers = len(node._workers)
        store = getattr(node, "store", None)
        store_stats = {}
        if store is not None:
            store_stats = {
                "capacity": getattr(store, "capacity", None),
                "num_objects": len(getattr(store, "_entries", ()) or ()),
            }
        # tag keys are tuples of (k, v) pairs internally: flatten to the
        # prometheus-style "k=v,k2=v2" string so the snapshot is JSON
        snap = {}
        for name, m in registry().snapshot().items():
            snap[name] = dict(m, values={
                ",".join(f"{k}={v}" for k, v in key) if key else "": val
                for key, val in m["values"].items()})
        return {
            "node_hex": node.hex,
            "pid": os.getpid(),
            "queue_depth": queue_depth,
            "num_workers": workers,
            "max_workers": node.max_workers,
            "store": store_stats,
            "metrics": snap,
            # the cards this node's workers are bound to, read without a
            # CUDA context (a daemon never opens one)
            "devices": query_cards(),
        }

    # ---- profile trigger (reference: reporter's profiling endpoints; here
    # the capture is torch.profiler -> a Chrome trace) --------------------

    def profile(self, duration_ms: int = 500,
                log_dir: Optional[str] = None) -> dict:
        from ray_tpu_torch.util.timeline import profile_trace

        duration_ms = max(1, min(int(duration_ms), 60_000))
        out_dir = log_dir or os.path.join(
            self.node.session_dir, f"profile-{time.time_ns()}")
        os.makedirs(out_dir, exist_ok=True)
        with profile_trace(out_dir):
            time.sleep(duration_ms / 1000.0)
        files = []
        for root, _dirs, names in os.walk(out_dir):
            for n in names:
                files.append(os.path.relpath(os.path.join(root, n), out_dir))
        return {"log_dir": out_dir, "files": sorted(files)}


class NodeAgent(NodeAgentCore):
    """HTTP wrapper: one ThreadingHTTPServer per node process."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        super().__init__(node)
        import http.server

        core = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code: int = 200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path, _, query = self.path.partition("?")
                    params = dict(p.split("=", 1)
                                  for p in query.split("&") if "=" in p)
                    if path == "/healthz":
                        self._json({"ok": True, "node": core.node.hex})
                    elif path == "/api/logs":
                        self._json(core.list_logs())
                    elif path.startswith("/api/logs/"):
                        name = path[len("/api/logs/"):]
                        try:
                            text, nxt = core.read_log(
                                name, int(params.get("offset", 0)),
                                int(params.get("limit", 64 * 1024)))
                        except FileNotFoundError:
                            self._json({"error": "not found"}, 404)
                            return
                        self._json({"text": text, "next_offset": nxt})
                    elif path == "/api/metrics":
                        self._json(core.metrics())
                    else:
                        self._json({"error": "not found"}, 404)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    self._json({"error": repr(e)}, 500)

            def do_POST(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/api/profile":
                        n = int(self.headers.get("Content-Length") or 0)
                        body = {}
                        if n:
                            try:
                                body = json.loads(self.rfile.read(n))
                            except ValueError:
                                pass
                        self._json(core.profile(
                            int(body.get("duration_ms", 500))))
                    else:
                        self._json({"error": "not found"}, 404)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    self._json({"error": repr(e)}, 500)

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="node-agent-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2.0)  # serve_forever returns on shutdown

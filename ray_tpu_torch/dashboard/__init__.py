"""Dashboard: HTTP head serving cluster state, metrics, and the jobs API
(port of ``ray_tpu/dashboard/__init__.py``).

Reference: python/ray/dashboard/head.py (aiohttp app aggregating per-module
routes) + modules/job/job_head.py (jobs REST) + the Prometheus re-export.
Single stdlib ThreadingHTTPServer here — no aiohttp dependency in the
control plane — with:

    GET  /                      HTML overview (nodes/actors/jobs/resources)
    GET  /metrics               Prometheus text format
    GET  /api/cluster           resource totals/availability
    GET  /api/nodes|actors|tasks|objects|placement_groups
    GET  /api/jobs/             list jobs
    POST /api/jobs/             submit {entrypoint, runtime_env, ...}
    GET  /api/jobs/<id>         job info
    GET  /api/jobs/<id>/logs    driver log text
    POST /api/jobs/<id>/stop    stop the driver
    DELETE /api/jobs/<id>       delete a terminal job
    GET  /api/serve             Serve deployment summary
    GET  /api/events?severity=&min_severity=&source=&limit=
                                structured cluster event log
    GET  /api/memory?group_by=callsite|node|task
                                cluster memory/object ownership summary
    GET  /api/metrics/history?name=   sampled metric time-series rings
                                (name may be a prefix* or regex -> multi)
    GET  /api/goodput           badput ledger + straggler/regression/TTRT
    GET  /api/xla               the program observatory's head fold:
                                per-program counts + roofline, MFU
                                against one card's peaks
    GET  /api/stacks?duration_ms=     cluster collapsed-stack dump
    GET  /api/pubsub?channel=&cursor=&timeout=   poll a pubsub channel
    GET  /api/nodes/<hex>/logs[/<name>]     per-node agent: log browse/tail
    GET  /api/nodes/<hex>/metrics           per-node agent: metrics snapshot
    POST /api/nodes/<hex>/profile           per-node agent: profiler trace

The /api/nodes/<hex>/* family proxies to the node's dashboard agent
(agent.py — reference: dashboard/agent.py:26): separate-process daemons
over their agent HTTP address, in-process nodes by direct call.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Optional

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><style>
body{font-family:system-ui,sans-serif;margin:24px;background:#fafafa;color:#222}
h1{font-size:20px} h2{font-size:15px;margin:18px 0 6px}
table{border-collapse:collapse;width:100%;background:#fff;font-size:13px}
th,td{border:1px solid #ddd;padding:4px 8px;text-align:left}
th{background:#f0f0f0} code{background:#eee;padding:1px 4px;border-radius:3px}
.ok{color:#0a0} .bad{color:#c00}
</style></head><body>
<h1>ray_tpu_torch dashboard</h1>
<div id="cluster"></div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>Serve</h2><table id="serve"></table>
<h2>Recent tasks</h2><table id="tasks"></table>
<h2>Cluster events</h2><table id="events"></table>
<script>
function esc(v){return String(v).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]))}
function row(cells, tag){return '<tr>'+cells.map(c=>'<'+tag+'>'+c+'</'+tag+'>').join('')+'</tr>'}
async function refresh(){
 try{
  const c = await (await fetch('/api/cluster')).json();
  document.getElementById('cluster').innerHTML =
    '<p>total: <code>'+esc(JSON.stringify(c.total))+'</code> available: <code>'+
    esc(JSON.stringify(c.available))+'</code></p>';
  const n = await (await fetch('/api/nodes')).json();
  document.getElementById('nodes').innerHTML = row(['id','alive','resources'],'th')+
    n.map(x=>row([esc(x.node_id||x.NodeID),(x.alive??x.Alive)?'<span class=ok>alive</span>':'<span class=bad>dead</span>',
    esc(JSON.stringify(x.resources||x.Resources))],'td')).join('');
  const a = await (await fetch('/api/actors')).json();
  document.getElementById('actors').innerHTML = row(['id','class','state','restarts'],'th')+
    a.map(x=>row([esc(x.actor_id),esc(x.class_name),esc(x.state),esc(x.num_restarts||0)],'td')).join('');
  const j = await (await fetch('/api/jobs/')).json();
  document.getElementById('jobs').innerHTML = row(['id','status','entrypoint','message'],'th')+
    j.map(x=>row([esc(x.submission_id),esc(x.status),'<code>'+esc(x.entrypoint)+'</code>',esc(x.message)],'td')).join('');
  const sv = await (await fetch('/api/serve/latency')).json();
  const lat = v=>v&&v.latency_ms||{};
  document.getElementById('serve').innerHTML =
    row(['deployment','requests','error rate','p50 ms','p95 ms','p99 ms','queue depth'],'th')+
    Object.entries(sv).map(([k,v])=>row([esc(k),esc(v.requests||0),
    esc(((v.error_rate||0)*100).toFixed(1))+'%',esc(lat(v).p50??''),
    esc(lat(v).p95??''),esc(lat(v).p99??''),esc(v.queue_depth||0)],'td')).join('');
  const t = await (await fetch('/api/tasks?limit=25')).json();
  document.getElementById('tasks').innerHTML = row(['task','name','state','node'],'th')+
    t.slice(-25).map(x=>row([esc(x.task_id),esc(x.name||''),esc(x.state),esc(x.node_hex||'')],'td')).join('');
  const ev = await (await fetch('/api/events?limit=25')).json();
  document.getElementById('events').innerHTML = row(['time','severity','source','message'],'th')+
    ev.slice(-25).reverse().map(x=>row([esc(new Date(x.ts*1000).toLocaleTimeString()),
    x.severity==='ERROR'||x.severity==='WARNING'?'<span class=bad>'+esc(x.severity)+'</span>':esc(x.severity),
    esc(x.source),esc(x.message)],'td')).join('');
 }catch(e){console.log(e)}
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


def _json_safe_list(msgs):
    """Best-effort JSON projection of pubsub payloads (arbitrary python
    objects publish fine; the HTTP surface shows their repr)."""
    import json as _json

    out = []
    for m in msgs:
        try:
            _json.dumps(m)
            out.append(m)
        except (TypeError, ValueError):
            out.append(repr(m))
    return out


class DashboardServer:
    """Stdlib HTTP server bound to a Head (+ optional JobManager)."""

    def __init__(self, head, host: str = "127.0.0.1", port: int = 0,
                 job_manager=None, auth_token: Optional[str] = None):
        import http.server

        self.head = head
        self.job_manager = job_manager
        # bearer token gate for job mutations (submit/stop/delete execute
        # shell commands — never expose them unauthenticated off-loopback)
        self.auth_token = auth_token
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200):
                self._send(code, json.dumps(obj).encode())

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                if not n:
                    return {}
                try:
                    return json.loads(self.rfile.read(n).decode())
                except ValueError:
                    return {}

            def do_GET(self):
                try:
                    outer._get(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    self._json({"error": repr(e)}, 500)

            def do_POST(self):
                try:
                    outer._post(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    self._json({"error": repr(e)}, 500)

            def do_DELETE(self):
                try:
                    outer._delete(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    self._json({"error": repr(e)}, 500)

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.address = self._server.server_address
        self._local_agents: dict = {}  # hex -> NodeAgentCore (local nodes)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="dashboard-http",
            daemon=True)
        self._thread.start()

    # ---- routing ----------------------------------------------------------
    _JOB_RE = re.compile(r"^/api/jobs/([^/]+)(/logs|/stop)?$")

    def _get(self, h) -> None:
        path, _, query = h.path.partition("?")
        params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
        limit = int(params.get("limit", 1000))
        if path in ("/", "/index.html"):
            h._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        elif path == "/metrics":
            from ray_tpu_torch.util.metrics import registry, render_prometheus

            h._send(200, render_prometheus(registry()).encode(),
                    "text/plain; version=0.0.4")
        elif path == "/api/timeline":
            # same builder as state.timeline(): task slices + the
            # flight-recorder span plane with merged clocks
            from ray_tpu_torch.util.flight_recorder import cluster_trace

            h._json(cluster_trace(self.head))
        elif path == "/api/cluster":
            h._json({
                "total": self.head.scheduler.total_resources(),
                "available": self.head.scheduler.available_resources(),
            })
        elif path in ("/api/nodes", "/api/actors", "/api/tasks",
                      "/api/objects", "/api/placement_groups"):
            h._json(self.head.state_list(path.rsplit("/", 1)[1], limit))
        elif path == "/api/events":
            # structured cluster events with filters:
            # /api/events?severity=&min_severity=&source=&limit=
            from urllib.parse import unquote

            from ray_tpu_torch.util.events import filter_events

            rows = self.head.state_list("cluster_events", 100_000)
            h._json(filter_events(
                rows,
                severity=unquote(params["severity"])
                if "severity" in params else None,
                source=unquote(params["source"])
                if "source" in params else None,
                min_severity=unquote(params["min_severity"])
                if "min_severity" in params else None)[-limit:])
        elif path == "/api/memory":
            # cluster memory observability (`ray memory` analog): grouped
            # ownership summary + totals + the raw top rows. Uses the
            # same helpers as util.state.memory_summary, so the HTTP, CLI
            # and Python surfaces all render identical numbers.
            from ray_tpu_torch.util.state import (group_memory_rows,
                                            memory_totals)

            gb = params.get("group_by", "callsite")
            rows = self.head.memory_table()
            try:
                groups = group_memory_rows(rows, gb)
            except ValueError as e:
                h._json({"error": str(e)}, 400)
                return
            rows.sort(key=lambda r: -(r.get("size") or 0))
            h._json({"group_by": gb, "groups": groups[:limit],
                     "totals": memory_totals(rows),
                     "objects": rows[:min(limit, 100)]})
        elif path == "/api/metrics/history":
            # sampled metric time-series: /api/metrics/history?name=
            # (no name -> the list of sampled series names). An exact
            # name keeps the single-series shape; a prefix (trailing *)
            # or regex returns every matching series in one response
            # under "matches".
            mh = getattr(self.head, "metrics_history", None)
            if mh is None:
                h._json({"error": "metrics history disabled"}, 404)
            elif "name" in params:
                from urllib.parse import unquote

                name = unquote(params["name"])
                series = mh.query(name)
                if series:
                    h._json({"name": name, "series": series})
                else:
                    h._json({"pattern": name,
                             "matches": mh.query_pattern(name)})
            else:
                h._json({"names": mh.names()})
        elif path == "/api/goodput":
            # the goodput observatory: badput ledger + detector state
            # (same dict `python -m ray_tpu_torch goodput` renders)
            from ray_tpu_torch.util.goodput import goodput_report

            h._json(goodput_report(self.head))
        elif path == "/api/xla":
            # the program observatory: per-program registry fold across
            # processes + roofline/MFU join (same dict `python -m
            # ray_tpu_torch xla` renders)
            from ray_tpu_torch.util.program_observatory import \
                program_report

            h._json(program_report(head=self.head))
        elif path == "/api/stacks":
            # cluster-wide collapsed-stack dump (`python -m ray_tpu_torch
            # stack`): blocks for the sample duration + daemon round
            dur = params.get("duration_ms")
            h._json(self.head.collect_stacks(
                duration_ms=int(dur) if dur else None))
        elif path == "/api/jobs" or path == "/api/jobs/":
            h._json([j.to_dict() for j in self._jm().list_jobs()])
        elif path == "/api/serve":
            # Serve module (reference: dashboard/modules/serve): the
            # controller's deployment summary, or {} when Serve is down
            h._json(self._serve_summary())
        elif path == "/api/serve/latency":
            # per-deployment request-path aggregates (p50/p95/p99, error
            # rate, queue depth) from the head's merged registry — the
            # serve.status() numbers over HTTP
            from ray_tpu_torch.serve.observability import serve_stats

            h._json(serve_stats())
        elif path == "/api/pubsub":
            # poll a pubsub channel over HTTP (tracing/event consumers):
            # /api/pubsub?channel=X&cursor=N&timeout=S
            channel = params.get("channel", "")
            cursor = int(params.get("cursor", 0))
            t = min(float(params.get("timeout", 0.0)), 10.0)
            msgs, nxt, gap = self.head.pubsub.poll(channel, cursor, t)
            h._json({"messages": _json_safe_list(msgs),
                     "cursor": nxt, "gap": gap})
        elif path.startswith("/api/nodes/"):
            self._node_agent_get(h, path, params)
        else:
            m = self._JOB_RE.match(path)
            if m and (m.group(2) or "") == "/logs":
                try:
                    offset = int(params.get("offset", 0))
                    text, nxt = self._jm().read_job_logs(
                        m.group(1), offset=offset)
                    body = text.encode()
                    h.send_response(200)
                    h.send_header("Content-Type",
                                  "text/plain; charset=utf-8")
                    h.send_header("Content-Length", str(len(body)))
                    h.send_header("X-Next-Offset", str(nxt))
                    h.end_headers()
                    h.wfile.write(body)
                except KeyError:
                    h._json({"error": "not found"}, 404)
            elif m and not m.group(2):
                try:
                    h._json(self._jm().get_job_info(m.group(1)).to_dict())
                except KeyError:
                    h._json({"error": "not found"}, 404)
            else:
                h._json({"error": "not found"}, 404)

    # ---- per-node agent proxy (reference: dashboard/agent.py) -------------

    def _resolve_agent(self, node_hex: str):
        """(local NodeAgentCore | None, daemon agent addr | None)."""
        node = self.head.nodes.get(node_hex)
        if node is None:
            return None, None
        if self.head._is_local(node):
            core = self._local_agents.get(node_hex)
            if core is None:
                from .agent import NodeAgentCore

                core = self._local_agents[node_hex] = NodeAgentCore(node)
            return core, None
        return None, getattr(node, "agent_addr", None)

    def _proxy_agent(self, h, addr, path: str, method: str = "GET",
                     body: bytes = b"") -> None:
        import urllib.request

        url = f"http://{addr[0]}:{addr[1]}{path}"
        req = urllib.request.Request(url, data=body or None, method=method)
        if body:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=70) as resp:
                h._send(resp.status, resp.read())
        except Exception as e:  # noqa: BLE001 — agent down / net error
            h._json({"error": f"node agent unreachable: {e!r}"}, 502)

    def _node_agent_get(self, h, path: str, params: dict) -> None:
        parts = path.split("/")  # '', 'api', 'nodes', <hex>, rest...
        if len(parts) < 5:
            h._json({"error": "not found"}, 404)
            return
        node_hex, rest = parts[3], "/".join(parts[4:])
        core, addr = self._resolve_agent(node_hex)
        if core is None and addr is None:
            h._json({"error": "unknown node or no agent"}, 404)
            return
        if core is None:
            qs = "&".join(f"{k}={v}" for k, v in params.items())
            self._proxy_agent(h, addr,
                              f"/api/{rest}" + (f"?{qs}" if qs else ""))
            return
        if rest == "logs":
            h._json(core.list_logs())
        elif rest.startswith("logs/"):
            try:
                text, nxt = core.read_log(
                    rest[len("logs/"):], int(params.get("offset", 0)),
                    int(params.get("limit", 64 * 1024)))
                h._json({"text": text, "next_offset": nxt})
            except FileNotFoundError:
                h._json({"error": "not found"}, 404)
        elif rest == "metrics":
            h._json(core.metrics())
        else:
            h._json({"error": "not found"}, 404)

    def _serve_summary(self) -> dict:
        import ray_tpu_torch

        try:
            info = self.head.gcs.get_named_actor("SERVE_CONTROLLER",
                                                 "default")
            if info is None or info.state == "DEAD":
                return {}
            from ray_tpu_torch.core.actor import ActorHandle

            handle = ActorHandle(info.actor_id, info.class_name)
            return ray_tpu_torch.get(handle.list_deployments.remote(),
                               timeout=10)
        except Exception:
            return {}

    def _authorized(self, h) -> bool:
        if not self.auth_token:
            return True
        import hmac

        got = h.headers.get("Authorization", "")
        return hmac.compare_digest(got, f"Bearer {self.auth_token}")

    def _post(self, h) -> None:
        if not self._authorized(h):
            h._json({"error": "missing/invalid Authorization bearer token"},
                    401)
            return
        path = h.path.split("?", 1)[0]
        if path.startswith("/api/nodes/") and path.endswith("/profile"):
            node_hex = path.split("/")[3]
            core, addr = self._resolve_agent(node_hex)
            if core is None and addr is None:
                h._json({"error": "unknown node or no agent"}, 404)
                return
            body = h._body()
            if core is not None:
                h._json(core.profile(int(body.get("duration_ms", 500))))
            else:
                self._proxy_agent(h, addr, "/api/profile", method="POST",
                                  body=json.dumps(body).encode())
            return
        if path in ("/api/jobs", "/api/jobs/"):
            body = h._body()
            if not body.get("entrypoint"):
                h._json({"error": "entrypoint required"}, 400)
                return
            sid = self._jm().submit_job(
                entrypoint=body["entrypoint"],
                runtime_env=body.get("runtime_env"),
                metadata=body.get("metadata"),
                submission_id=body.get("submission_id"))
            h._json({"submission_id": sid})
            return
        m = self._JOB_RE.match(path)
        if m and m.group(2) == "/stop":
            try:
                h._json({"stopped": self._jm().stop_job(m.group(1))})
            except KeyError:
                h._json({"error": "not found"}, 404)
        else:
            h._json({"error": "not found"}, 404)

    def _delete(self, h) -> None:
        if not self._authorized(h):
            h._json({"error": "missing/invalid Authorization bearer token"},
                    401)
            return
        m = self._JOB_RE.match(h.path.split("?", 1)[0])
        if m and not m.group(2):
            try:
                h._json({"deleted": self._jm().delete_job(m.group(1))})
            except KeyError:
                h._json({"error": "not found"}, 404)
            except RuntimeError as e:
                h._json({"error": str(e)}, 400)
        else:
            h._json({"error": "not found"}, 404)

    def _jm(self):
        if self.job_manager is None:
            raise RuntimeError("no JobManager attached to this dashboard")
        return self.job_manager

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2.0)  # serve_forever returns on shutdown


def start_dashboard(host: str = "127.0.0.1", port: int = 8265,
                    with_jobs: bool = True,
                    auth_token: Optional[str] = None) -> DashboardServer:
    """Start the dashboard on the current in-process head.

    With ``with_jobs`` the head's client server is started too, so
    submitted jobs' drivers join this cluster. On a non-loopback bind a
    bearer token is REQUIRED for job mutations: pass one, or one is
    generated (read it from ``server.auth_token``).
    """
    import ray_tpu_torch
    from ray_tpu_torch.core import api as _api

    head = _api._get_head()
    if auth_token is None and host not in ("127.0.0.1", "localhost"):
        import secrets

        auth_token = secrets.token_hex(16)
    jm = None
    if with_jobs:
        from ray_tpu_torch.jobs import JobManager

        addr, key_hex = ray_tpu_torch.start_client_server()
        jm = JobManager(client_address=addr, cluster_key_hex=key_hex)
    srv = DashboardServer(head, host, port, job_manager=jm,
                          auth_token=auth_token)
    head._dashboard = srv
    return srv

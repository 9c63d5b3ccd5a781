"""HTTP proxy: an HTTP/1.1 server routing requests to deployment handles.

Port of ``ray_tpu/serve/proxy.py``. The reference builds on aiohttp
("what this environment ships"). The port's serving path needs nothing
beyond torch and the standard library, so its proxy is built on
``asyncio.start_server``: the request line, headers and a
``Content-Length`` (or chunked) body read by hand, unary responses with a
``Content-Length``, and streamed responses in chunked transfer encoding
(a mid-stream failure aborts the connection without the last chunk, so
the client can tell truncation from completion). Route matching, status
codes (404 ``no route``, 500 with the error, 503 when dispatch fails,
503 with ``retry-after: 1`` when the dispatch plane sheds the request),
JSON / bytes / text bodies, ``x-request-id``, the ingress span and the
SSE ``text/event-stream`` framing of decode routes are the reference's.
"""

from __future__ import annotations

import asyncio
import http
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

import ray_tpu_torch

_STREAM_END = object()
# request head and body limits (aiohttp's defaults are of the same order)
_MAX_HEAD_BYTES = 64 * 1024
_MAX_BODY_BYTES = 64 * 1024 * 1024
# every open stream parks one executor thread on its next item, so the
# pool is sized for many concurrent streams, not for the CPU count
_EXECUTOR_THREADS = 64


class Request:
    """Minimal request object passed to deployments (starlette-ish)."""

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query_params = query
        self.headers = headers
        self._body = body

    def body(self) -> bytes:
        return self._body

    def json(self) -> Any:
        return json.loads(self._body) if self._body else None

    @property
    def text(self) -> str:
        return self._body.decode()


class _BadRequest(Exception):
    pass


class _Conn:
    """One client connection: reads requests, writes responses."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    async def read_request(self) -> Optional[Tuple[str, str, str, list,
                                                   bytes]]:
        """(method, target, version, [(name, value)], body), or None at
        a clean end of the connection."""
        try:
            head = await self.reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if not e.partial.strip():
                return None
            raise _BadRequest("truncated request head")
        except asyncio.LimitOverrunError:
            raise _BadRequest("request head too large")
        lines = head[:-4].decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ")
        except ValueError:
            raise _BadRequest(f"bad request line {lines[0]!r}")
        headers = []
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep:
                raise _BadRequest(f"bad header line {line!r}")
            headers.append((name.strip(), value.strip()))
        lower = {k.lower(): v for k, v in headers}
        try:
            if lower.get("transfer-encoding", "").lower() == "chunked":
                body = await self._read_chunked()
            else:
                n = int(lower.get("content-length", "0") or 0)
                if not 0 <= n <= _MAX_BODY_BYTES:
                    raise _BadRequest(f"body of {n} bytes is refused")
                body = await self.reader.readexactly(n) if n else b""
        except (ValueError, asyncio.LimitOverrunError) as e:
            raise _BadRequest(f"bad request body framing: {e}")
        return method, target, version, headers, body

    async def _read_chunked(self) -> bytes:
        parts = []
        size = 0
        while True:
            line = await self.reader.readuntil(b"\r\n")
            n = int(line.split(b";")[0].strip(), 16)
            if n == 0:
                # trailers, then the blank line
                while (await self.reader.readuntil(b"\r\n")) != b"\r\n":
                    pass
                return b"".join(parts)
            size += n
            if size > _MAX_BODY_BYTES:
                raise _BadRequest("chunked body is too large")
            parts.append(await self.reader.readexactly(n))
            await self.reader.readexactly(2)

    def _head(self, status: int, headers: Dict[str, str]) -> bytes:
        lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def respond(self, status: int, body: bytes, content_type: str,
                      headers: Dict[str, str], keep_alive: bool) -> None:
        h = {"content-type": content_type,
             "content-length": str(len(body)),
             "connection": "keep-alive" if keep_alive else "close"}
        h.update(headers)
        self.writer.write(self._head(status, h) + body)
        await self.writer.drain()

    async def respond_text(self, status: int, text: str,
                           headers: Dict[str, str], keep_alive: bool) -> None:
        await self.respond(status, text.encode(), "text/plain; charset=utf-8",
                           headers, keep_alive)

    async def start_stream(self, headers: Dict[str, str]) -> None:
        h = {"transfer-encoding": "chunked", "connection": "close"}
        h.update(headers)
        self.writer.write(self._head(200, h))
        await self.writer.drain()

    async def write_chunk(self, data: bytes) -> None:
        if data:
            self.writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self.writer.drain()

    async def end_stream(self) -> None:
        self.writer.write(b"0\r\n\r\n")
        await self.writer.drain()

    def abort(self) -> None:
        self.writer.transport.abort()


class HTTPProxy:
    """Runs an HTTP/1.1 server on a daemon thread in the driver process."""

    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 8000):
        self._controller = controller
        self.host = host
        self.port = port
        self._handles: Dict[str, Any] = {}
        self._routes_cache: Dict[str, str] = {}
        self._routes_expiry = 0.0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._start_error: Optional[BaseException] = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10) or self._server is None:
            raise RuntimeError(
                f"HTTP proxy failed to bind {host}:{port} within 10s "
                f"(server thread died or address unavailable: "
                f"{self._start_error!r})")
        # long-poll push of the route table (reference: long_poll.py);
        # the 1 s TTL in the handler remains the fallback if this dies
        from .handle import get_longpoll_client

        get_longpoll_client(controller).add(self._on_route_push)

    def _on_route_push(self) -> None:
        import time as _time

        try:
            self._routes_cache = ray_tpu_torch.get(
                self._controller.get_route_meta.remote(), timeout=10)
            # pushed data stays valid until the next push
            self._routes_expiry = _time.monotonic() + 3600.0
        except Exception:
            self._routes_expiry = 0.0  # fall back to TTL polling

    def _get_handle(self, name: str):
        from .handle import DeploymentHandle

        if name not in self._handles:
            self._handles[name] = DeploymentHandle(self._controller, name)
        return self._handles[name]

    async def _client(self, reader, writer) -> None:
        conn = _Conn(reader, writer)
        self._conns.add(conn)
        try:
            while True:
                try:
                    req = await conn.read_request()
                except _BadRequest as e:
                    await conn.respond_text(400, str(e), {},
                                            keep_alive=False)
                    return
                if req is None:
                    return
                method, target, version, headers, body = req
                lower = {k.lower(): v for k, v in headers}
                keep_alive = (version == "HTTP/1.1"
                              and lower.get("connection", "").lower()
                              != "close")
                try:
                    if not await self._handle(conn, method, target, headers,
                                              lower, body, keep_alive):
                        return
                except (ConnectionError, asyncio.IncompleteReadError):
                    raise
                except Exception as e:  # noqa: BLE001 — e.g. no controller
                    await conn.respond_text(500, str(e), {},
                                            keep_alive=False)
                    return
                if not keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            return
        finally:
            self._conns.discard(conn)
            writer.close()

    async def _handle(self, conn: _Conn, method: str, target: str,
                      headers: list, lower: Dict[str, str], body: bytes,
                      keep_alive: bool) -> bool:
        """Answer one request. False when the connection must close."""
        import time as _time

        loop = asyncio.get_running_loop()
        # never block the event loop: route table fetched off-loop and
        # cached briefly (long-poll push is the reference design; this is
        # the polling analog with a bounded staleness window)
        now = _time.monotonic()
        if now >= self._routes_expiry:
            self._routes_cache = await loop.run_in_executor(
                None,
                lambda: ray_tpu_torch.get(
                    self._controller.get_route_meta.remote()))
            self._routes_expiry = now + 1.0
        routes = self._routes_cache
        split = urlsplit(target)
        path = unquote(split.path) or "/"
        match = None
        for prefix in sorted(routes, key=len, reverse=True):
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(
                    norm + "/") or norm == "/":
                match = routes[prefix]
                break
        if match is None:
            await conn.respond_text(404, "no route", {}, keep_alive)
            return True
        req = Request(method, path,
                      dict(parse_qsl(split.query, keep_blank_values=True)),
                      dict(headers), body)
        handle = self._get_handle(match["name"])
        # ingress observability: assign (or adopt) the request id, open
        # the root span, and build the meta that rides to the replica.
        # The span can't use the contextvar — the request hops between
        # the event loop and executor threads — so its (trace_id,
        # span_id) travels inside the meta instead and finish() publishes
        # it when the response settles.
        from . import observability as obs
        from ray_tpu_torch.util import tracing

        span, meta, req_id = None, None, ""
        if obs.enabled():
            req_id = lower.get("x-request-id") or obs.new_request_id()
            span = tracing.child_span(f"serve.http {path}",
                                      request_id=req_id)
            meta = obs.make_request_meta(
                deployment=match["name"], route=path, ingress="http",
                request_id=req_id, trace_ctx=span.context)
            handle = handle.options(_request_meta=meta)
        extra = {"x-request-id": req_id} if req_id else {}

        if match.get("stream") or match.get("decode"):
            # dispatch BEFORE sending headers: a routing failure (e.g. no
            # replicas) must surface as a 5xx, not a truncated 200
            sse = bool(match.get("decode"))
            # decode routes take the raw JSON body
            # (decode.parse_decode_request handles bytes)
            stream_arg = body if sse else req
            try:
                try:
                    it = await loop.run_in_executor(
                        None, lambda: handle.options(
                            stream=True,
                            stream_item_timeout_s=match.get("timeout",
                                                            60.0),
                        ).remote(stream_arg))
                except Exception as e:  # noqa: BLE001
                    await conn.respond_text(503, str(e), extra, keep_alive)
                    return True
                # streaming response: chunks flow as the replica yields
                headers_out = dict(extra)
                if sse:
                    # server-sent events: one `data:` record per token
                    # chunk, flushed as it is decoded
                    headers_out["content-type"] = "text/event-stream"
                    headers_out["cache-control"] = "no-cache"
                else:
                    headers_out["content-type"] = "application/octet-stream"
                await conn.start_stream(headers_out)
                try:
                    while True:
                        chunk = await loop.run_in_executor(
                            None, lambda: next(it, _STREAM_END))
                        if chunk is _STREAM_END:
                            break
                        if sse:
                            chunk = (b"data: " + json.dumps(chunk).encode()
                                     + b"\n\n")
                        elif isinstance(chunk, str):
                            chunk = chunk.encode()
                        await conn.write_chunk(chunk)
                except Exception:
                    # mid-stream failure: ABORT the connection (no last
                    # chunk) so the client can tell truncation from
                    # completion
                    conn.abort()
                    return False
                await conn.end_stream()
                return False  # streamed responses close the connection
            finally:
                if span is not None:
                    span.finish()
        timeout = match.get("timeout", 60.0)
        # bytes-body lane: hand the raw request body to __call__
        unary_arg = body if match.get("bytes_body") else req
        try:
            # handle.remote() can spin in Router.choose() waiting for
            # replicas — run it off the event loop too
            def _call():
                return handle.remote(unary_arg).result(timeout=timeout)

            result = await loop.run_in_executor(None, _call)
        except Exception as e:  # noqa: BLE001
            from .compiled_dispatch import BackPressureError

            if isinstance(e, BackPressureError):
                # shed by the dispatch plane: overloaded, not broken —
                # 503 tells the load balancer to back off / retry
                await conn.respond_text(503, str(e),
                                        {**extra, "retry-after": "1"},
                                        keep_alive)
                return True
            await conn.respond_text(500, str(e), extra, keep_alive)
            return True
        finally:
            if span is not None:
                span.finish()
        if isinstance(result, (dict, list)):
            out = (json.dumps(result).encode(),
                   "application/json; charset=utf-8")
        elif isinstance(result, bytes):
            out = (result, "application/octet-stream")
        else:
            out = (str(result).encode(), "text/plain; charset=utf-8")
        await conn.respond(200, out[0], out[1], extra, keep_alive)
        return True

    def _serve(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.set_default_executor(ThreadPoolExecutor(
            max_workers=_EXECUTOR_THREADS, thread_name_prefix="serve-proxy"))
        self._loop = loop
        try:
            self._server = loop.run_until_complete(asyncio.start_server(
                self._client, self.host, self.port,
                limit=_MAX_HEAD_BYTES))
        except BaseException as e:  # noqa: BLE001 — reported by __init__
            self._start_error = e
            self._started.set()
            loop.close()
            return
        # with port=0 report the OS-assigned port (per-node proxies)
        for s in (self._server.sockets or []):
            self.port = s.getsockname()[1]
            break
        self._started.set()
        loop.run_forever()
        loop.close()

    def shutdown(self) -> None:
        if self._loop is not None:
            loop = self._loop

            async def stop():
                if self._server is not None:
                    self._server.close()
                for conn in list(self._conns):
                    conn.abort()
                loop.stop()

            asyncio.run_coroutine_threadsafe(stop(), loop)
            self._thread.join(timeout=5)
            self._loop = None


class ProxyActor:
    """Per-node HTTP proxy (reference: serve's proxy actors with
    ProxyLocation.EveryNode — _private/proxy_state.py). The controller
    spawns one on every alive node with node-affinity scheduling; each
    binds its own port and registers (node, host, port) so external load
    balancers can target any node."""

    def __init__(self, controller, host: str = "0.0.0.0", port: int = 0):
        self._proxy = HTTPProxy(controller, host, port)

    @staticmethod
    def _node_ip() -> str:
        """This node's routable IP (a 0.0.0.0 bind address is useless to
        an external load balancer)."""
        from ray_tpu_torch.core.protocol import infer_node_ip

        return infer_node_ip()

    def address(self):
        node_id = ray_tpu_torch.get_runtime_context().get_node_id()
        host = self._proxy.host
        if host in ("0.0.0.0", "::"):
            host = self._node_ip()
        return {"node_id": node_id, "host": host,
                "port": self._proxy.port}

    def ready(self) -> bool:
        return self._proxy._started.is_set()

    def shutdown(self) -> None:
        self._proxy.shutdown()

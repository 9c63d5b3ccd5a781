"""gRPC ingress: serve deployments over gRPC alongside HTTP.

Reference: serve's gRPC proxy (python/ray/serve/_private/proxy.py
gRPCProxy + config.gRPCOptions) — there, user-supplied protobuf
services; here a *generic* envelope so no per-app codegen is needed
(grpc.GenericRpcHandler — raw bytes in/out):

    method  : /ray_tpu_torch.serve/<deployment_name>
              or /ray_tpu_torch.serve/<deployment_name>.<method_name>
    request : arbitrary bytes, handed to the deployment as the body of a
              Request (same object the HTTP proxy passes)
    reply   : the deployment's return value — bytes passed through, str
              utf-8 encoded, anything else JSON-encoded
    metadata: 'multiplexed-model-id' routes to the model's replica

The port's ingress is the reference's. ``grpc`` is imported when the
ingress starts, not with the module: where grpcio is absent,
``serve.start(grpc_options=...)`` raises an
ImportError that names it, and serve never runs without the ingress it
was asked for.

Python clients call it with a plain channel::

    ch = grpc.insecure_channel(addr)
    fn = ch.unary_unary("/ray_tpu_torch.serve/echo")
    fn(b"payload", metadata=[("multiplexed-model-id", "m1")])
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Any, Dict, Optional

import ray_tpu_torch

from .proxy import Request

_PREFIX = "/ray_tpu_torch.serve/"


def _encode_reply(value: Any) -> bytes:
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode()
    return json.dumps(value).encode()


def _import_grpc():
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "serve's gRPC ingress needs the grpcio package, which is not "
            "installed here; start serve without grpc_options") from e
    return grpc


class GRPCIngress:
    """grpc.server wrapper bound to the Serve controller."""

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 16, default_timeout_s: float = 60.0):
        import threading

        grpc = _import_grpc()
        self._controller = controller
        self._handles: Dict[str, Any] = {}
        self._timeout = default_timeout_s
        self._routes_cache: Dict[str, Any] = {}
        self._routes_expiry = 0.0
        self._routes_lock = threading.Lock()
        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, call_details):
                method = call_details.method
                if not method.startswith(_PREFIX):
                    return None
                target = method[len(_PREFIX):]
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx, target=target: outer._invoke(
                        target, req, ctx))

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers,
                                       thread_name_prefix="grpc-ingress"))
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    def _get_handle(self, name: str):
        from .handle import DeploymentHandle

        if name not in self._handles:
            self._handles[name] = DeploymentHandle(self._controller, name)
        return self._handles[name]

    def _routes(self, force: bool = False):
        """Route table with a 1s TTL cache (same pattern as the HTTP
        proxy) — no per-request controller round-trip. ``force`` bypasses
        the cache (used before concluding a deployment doesn't exist —
        it may have been deployed within the TTL window)."""
        import time

        now = time.monotonic()
        with self._routes_lock:
            if not force and now < self._routes_expiry:
                return self._routes_cache
        routes = ray_tpu_torch.get(
            self._controller.get_route_meta.remote(), timeout=10)
        with self._routes_lock:
            self._routes_cache = routes
            self._routes_expiry = now + 1.0
        return routes

    def _invoke(self, target: str, request_bytes: bytes, ctx) -> bytes:
        import grpc

        name, _, method = target.partition(".")
        # deployment must exist (route table is the source of truth)
        try:
            routes = self._routes()
        except Exception as e:  # noqa: BLE001
            ctx.abort(grpc.StatusCode.UNAVAILABLE,
                      f"serve controller unreachable: {e!r}")
            return b""
        known = {m["name"] for m in routes.values()}
        if name not in known:
            try:
                routes = self._routes(force=True)
                known = {m["name"] for m in routes.values()}
            except Exception:
                pass
            if name not in known:
                ctx.abort(grpc.StatusCode.NOT_FOUND,
                          f"no deployment named {name!r}")
                return b""
        model_id = ""
        req_id = ""
        for k, v in (ctx.invocation_metadata() or ()):
            if k == "multiplexed-model-id":
                model_id = v
            elif k == "x-request-id":
                req_id = v
        req = Request("GRPC", _PREFIX + target, {}, {"content-type":
                      "application/grpc"}, request_bytes)
        handle = self._get_handle(name)
        if method:
            handle = handle.options(method_name=method)
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        # ingress observability: request id + root span + meta (same
        # shape as the HTTP proxy; the span context rides the meta)
        from . import observability as obs
        from ray_tpu_torch.util import tracing

        span = None
        if obs.enabled():
            req_id = req_id or obs.new_request_id()
            span = tracing.child_span(f"serve.grpc {target}",
                                      request_id=req_id)
            handle = handle.options(_request_meta=obs.make_request_meta(
                deployment=name, route=_PREFIX + target, ingress="grpc",
                request_id=req_id, trace_ctx=span.context))
            try:
                ctx.set_trailing_metadata((("x-request-id", req_id),))
            except Exception:
                pass
        try:
            value = handle.remote(req).result(timeout=self._timeout)
        except TimeoutError:
            ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                      f"deployment {name!r} timed out")
            return b""
        except Exception as e:  # noqa: BLE001
            ctx.abort(grpc.StatusCode.INTERNAL, repr(e))
            return b""
        finally:
            if span is not None:
                span.finish()
        return _encode_reply(value)

    def shutdown(self) -> None:
        self._server.stop(grace=1.0)

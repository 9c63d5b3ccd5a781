"""The port's serve control plane (``ray_tpu_torch/serve``) held to the
cases of the JAX package's serve tests, on the CPU: function and class
deployments, the HTTP round trip and JSON body, replicas, composition,
status and delete, rolling updates, batching and autoscaling
(``tests/test_serve.py``); streaming over HTTP and the handle, a rollout
with no outage and the request timeout (``tests/test_serve_hardening.py``);
the long-poll push and retry gating (``tests/test_serve_longpoll.py``);
deployment graphs (``tests/test_serve_dag.py``); and the gRPC ingress
(``tests/test_grpc_ingress.py``, where grpcio is installed).

One runtime and one serve instance serve the whole module; each case
deletes its deployments. The proxy binds a port found free by binding
port 0, never a fixed one. Nothing here imports JAX: the replicas'
workers import this module to unpickle what the cases define at its top.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.serve import InputNode

T = 60  # seconds any one blocking call may take


def free_port() -> int:
    """A port the OS reports free: bind port 0, read it back, close."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port():
    port = free_port()
    rt.init(num_cpus=8, num_gpus=0)
    try:
        serve.start(serve.HTTPOptions(port=port))
        yield port
    finally:
        serve.shutdown()
        rt.shutdown()


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


def _http(port, path, data=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if data is None else json.dumps(data).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=T) as r:
        return r.status, r.read().decode(), r.headers


def test_function_deployment_handle(serve_instance):
    @serve.deployment
    def echo(x):
        return f"echo:{x}"

    handle = serve.run(echo.bind(), route_prefix=None)
    assert handle.remote("hi").result(timeout=T) == "echo:hi"


def test_class_deployment(serve_instance):
    @serve.deployment
    class Counter:
        def __init__(self, start):
            self.count = start

        def incr(self, n):
            self.count += n
            return self.count

        def __call__(self, req):
            return self.count

    handle = serve.run(Counter.bind(10), route_prefix=None)
    assert handle.incr.remote(5).result(timeout=T) == 15
    assert handle.incr.remote(5).result(timeout=T) == 20


@serve.deployment
class Greeter:
    def __call__(self, request):
        name = request.query_params.get("name", "world")
        return {"hello": name}


@serve.deployment
class Adder:
    def __call__(self, request):
        data = request.json()
        return {"sum": data["a"] + data["b"]}


@pytest.mark.parametrize("app,route,path,data,want", [
    (Greeter, "/greet", "/greet?name=tpu", None, {"hello": "tpu"}),
    (Adder, "/add", "/add", {"a": 2, "b": 3}, {"sum": 5}),
], ids=["query_params", "json_body"])
def test_http_roundtrip(serve_instance, app, route, path, data, want):
    run_routed(app.bind(), route)
    status, body, headers = _http(serve_instance, path, data)
    assert status == 200
    assert headers["content-type"].startswith("application/json")
    assert json.loads(body) == want


def test_http_status_codes_and_bodies(serve_instance):
    """404 with no route, 500 with the error, bytes and text bodies."""
    @serve.deployment
    def kinds(request):
        kind = request.query_params.get("kind")
        if kind == "boom":
            raise ValueError("kaput")
        return b"\x00raw" if kind == "bytes" else 42

    run_routed(kinds.bind(), "/kinds")
    port = serve_instance
    assert _http(port, "/kinds?kind=bytes")[1] == "\x00raw"
    status, body, headers = _http(port, "/kinds")
    assert (status, body) == (200, "42")
    assert headers["content-type"].startswith("text/plain")
    with pytest.raises(urllib.error.HTTPError) as e:
        _http(port, "/kinds?kind=boom")
    assert e.value.code == 500 and "kaput" in e.value.read().decode()
    from ray_tpu_torch.serve import api as serve_api

    serve.delete("kinds")
    # the route table reaches the proxy by long-poll push: wait for it
    # (a request routed before it lands waits out the router's 30 s
    # search for a replica)
    deadline = time.time() + T
    while "/kinds" in serve_api._proxy._routes_cache \
            and time.time() < deadline:
        time.sleep(0.05)
    with pytest.raises(urllib.error.HTTPError) as e:
        _http(port, "/kinds")
    assert e.value.code == 404 and e.value.read() == b"no route"


def test_http_framing(serve_instance):
    """The proxy's own HTTP/1.1 framing (the JAX package's proxy is
    aiohttp's): two requests on one kept-alive connection, a chunked
    request body, and 400 for a request line it cannot read."""
    import http.client

    run_routed(Adder.bind(), "/add")
    conn = http.client.HTTPConnection("127.0.0.1", serve_instance,
                                      timeout=T)
    try:
        for a in (1, 2):
            conn.request("POST", "/add", body=json.dumps({"a": a, "b": 3}))
            resp = conn.getresponse()
            assert (resp.status, json.loads(resp.read())) == (
                200, {"sum": a + 3})
        conn.request("POST", "/add", body=iter([b'{"a": 4,', b' "b": 5}']),
                      encode_chunked=True)
        resp = conn.getresponse()
        assert json.loads(resp.read()) == {"sum": 9}
    finally:
        conn.close()
    with socket.create_connection(("127.0.0.1", serve_instance),
                                  timeout=T) as s:
        s.sendall(b"NOT-HTTP\r\n\r\n")
        assert s.recv(64).startswith(b"HTTP/1.1 400 Bad Request")


def test_multiple_replicas(serve_instance):
    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self, req):
            return self.pid

    handle = serve.run(WhoAmI.bind(), route_prefix=None)
    pids = {handle.remote(None).result(timeout=T) for _ in range(20)}
    assert len(pids) >= 2  # pow-2 routing spreads load


def test_composition(serve_instance):
    @serve.deployment
    class Preprocessor:
        def process(self, x):
            return x * 2

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            doubled = self.pre.process.remote(x).result(timeout=T)
            return doubled + 1

    handle = serve.run(Model.bind(Preprocessor.bind()), route_prefix=None)
    assert handle.remote(10).result(timeout=T) == 21


def test_status_and_delete(serve_instance):
    @serve.deployment
    def f(x):
        return x

    serve.run(f.bind(), route_prefix=None)
    st = serve.status()
    assert "f" in st
    serve.delete("f")
    assert "f" not in serve.status()


@pytest.mark.parametrize("replicas", [1, 2], ids=["reconfigure",
                                                   "no_outage"])
def test_rolling_update(serve_instance, replicas):
    """A new version replaces the old; with two replicas every request
    during the rollout gets an answer (old or new version)."""
    @serve.deployment(name="v", version="1", num_replicas=replicas)
    def v1(x):
        return "v1"

    handle = serve.run(v1.bind(), route_prefix=None)
    assert handle.remote(0).result(timeout=T) == "v1"

    @serve.deployment(name="v", version="2", num_replicas=replicas)
    def v2(x):
        return "v2"

    handle = serve.run(v2.bind(), route_prefix=None)
    saw = set()
    deadline = time.time() + 120
    while time.time() < deadline:
        # every call must succeed during the rollout
        saw.add(handle.remote(0).result(timeout=15))
        if "v2" in saw:
            break
        time.sleep(0.05)
    assert "v2" in saw, f"rollout never completed: {saw}"


def test_reconfigure_user_config(serve_instance):
    @serve.deployment(user_config={"scale": 2})
    class Scaled:
        def reconfigure(self, cfg):
            self.scale = cfg["scale"]

        def __call__(self, x):
            return x * self.scale

    handle = serve.run(Scaled.bind(), route_prefix=None)
    assert handle.remote(5).result(timeout=T) == 10


def test_batching(serve_instance):
    @serve.deployment
    class BatchModel:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def handle_batch(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 10 for x in xs]

        async def __call__(self, x):
            return await self.handle_batch(x)

        def get_batch_sizes(self):
            return self.batch_sizes

    handle = serve.run(BatchModel.bind(), route_prefix=None)
    deadline = time.time() + T
    while True:
        responses = [handle.remote(i) for i in range(8)]
        results = sorted(r.result(timeout=T) for r in responses)
        assert results == [i * 10 for i in range(8)]
        sizes = handle.get_batch_sizes.remote().result(timeout=T)
        if max(sizes) > 1:  # some batching happened
            break
        assert time.time() < deadline, \
            f"no batch formed before the deadline: {sizes}"
        time.sleep(0.1)


def test_autoscaling_scales_up(serve_instance):
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0, "upscale_delay_s": 0.1})
    class Slow:
        def __call__(self, req):
            time.sleep(0.4)
            return "ok"

    handle = serve.run(Slow.bind(), route_prefix=None)
    responses = [handle.remote(None) for _ in range(12)]
    deadline = time.time() + 120
    scaled = False
    while time.time() < deadline:
        if serve.status().get("Slow", {}).get("num_replicas", 0) >= 2:
            scaled = True
            break
        # sustain queue depth: collect finished responses, resubmit
        done, responses = responses[:4], responses[4:]
        for r in done:
            r.result(timeout=T)
        responses.extend(handle.remote(None) for _ in range(4))
        time.sleep(0.2)
    for r in responses:
        r.result(timeout=T)
    assert scaled


def test_streaming_response_http(serve_instance):
    @serve.deployment(stream=True)
    def chunks(req):
        for i in range(4):
            yield f"part{i};"

    run_routed(chunks.bind(), "/stream")
    status, body, headers = _http(serve_instance, "/stream")
    assert body == "part0;part1;part2;part3;"
    assert headers["transfer-encoding"] == "chunked"


def test_streaming_handle(serve_instance):
    @serve.deployment(stream=True)
    def gen(req):
        for i in range(3):
            yield i * 2

    handle = serve.run(gen.bind(), route_prefix=None)
    assert list(handle.options(stream=True).remote(None)) == [0, 2, 4]


def test_request_timeout(serve_instance):
    @serve.deployment(request_timeout_s=1.0)
    def slow(req):
        time.sleep(10)
        return "late"

    run_routed(slow.bind(), "/slow")
    t0 = time.time()
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _http(serve_instance, "/slow")
    elapsed = time.time() - t0
    assert exc_info.value.code == 500
    assert elapsed < 8, f"timeout not enforced ({elapsed:.1f}s)"


def test_wait_for_version_blocks_then_wakes(serve_instance):
    from ray_tpu_torch.serve import api as serve_api

    controller = serve_api._controller
    v0 = rt.get(controller.get_version.remote(), timeout=T)
    # no change: the long-poll must BLOCK for its timeout, not spin
    t0 = time.monotonic()
    v = rt.get(controller.wait_for_version.remote(v0, 0.4), timeout=T)
    assert time.monotonic() - t0 >= 0.35
    assert v == v0

    # a deploy bumps the version and wakes the watcher quickly
    @serve.deployment
    def g():
        return "g"

    results = {}

    def watch():
        t = time.monotonic()
        results["v"] = rt.get(
            controller.wait_for_version.remote(v0, 25.0), timeout=40)
        results["dt"] = time.monotonic() - t

    th = threading.Thread(target=watch)
    th.start()
    time.sleep(0.1)
    serve.run(g.bind(), route_prefix=None, _wait_timeout=T)
    th.join(timeout=30)
    assert results["v"] > v0
    assert results["dt"] < 5.0  # woke on the deploy, not a 25 s timeout


def test_router_longpoll_sees_new_replicas_fast(serve_instance):
    @serve.deployment(num_replicas=1)
    class M:
        def __call__(self):
            return "ok"

    handle = serve.run(M.bind(), route_prefix=None, _wait_timeout=T)
    assert handle.remote().result(timeout=T) == "ok"  # starts the poller
    router = handle._router
    v_before = router._version

    # scale up: the router must learn WITHOUT another request
    serve.run(M.options(num_replicas=2).bind(), route_prefix=None,
              _wait_timeout=T)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if router._version > v_before and len(router._replicas) == 2:
            break
        time.sleep(0.02)
    assert len(router._replicas) == 2, "router did not see the scale-up"


@pytest.mark.parametrize("retry", [False, True],
                         ids=["non_idempotent", "default"])
def test_retry_gating(serve_instance, retry):
    @serve.deployment(retry_on_replica_failure=retry)
    def pay():
        return "charged"

    handle = serve.run(pay.bind(), route_prefix=None, _wait_timeout=T)
    resp = handle.remote()
    # replica death re-executes only a retryable request
    assert (resp._redispatch is not None) is retry
    assert resp.result(timeout=T) == "charged"


@serve.deployment
class Doubler:
    def apply(self, x):
        return x * 2


@serve.deployment
class Bias:
    def __init__(self, bias=0):
        self.bias = bias

    def apply(self, x):
        return x + self.bias


@serve.deployment
class Combiner:
    def combine(self, a, b):
        return {"sum": a + b}


def _two_stage():
    with InputNode() as inp:
        doubled = Doubler.bind().apply.bind(inp)
        return Bias.bind(10).apply.bind(doubled)


def _diamond():
    with InputNode() as inp:
        left = Doubler.bind().apply.bind(inp)
        right = Bias.bind(100).apply.bind(inp)
        return Combiner.bind().combine.bind(left, right)


@pytest.mark.parametrize("graph,x,want,stages", [
    (_two_stage, 5, 20, ("Doubler", "Bias")),
    (_diamond, 3, {"sum": 6 + 103}, ("Doubler", "Bias", "Combiner")),
], ids=["two_stage", "diamond"])
def test_deployment_graph(serve_instance, graph, x, want, stages):
    handle = serve.run(graph(), route_prefix=None)
    assert handle.remote(x).result(timeout=T) == want
    # every stage exists as a first-class deployment
    st = serve.status()
    assert set(stages) | {"DAGDriver"} <= set(st)


def test_grpc_ingress_needs_grpcio(serve_instance, monkeypatch):
    """Without grpcio, asking for the gRPC ingress raises an ImportError
    that names the package; serve does not carry on without it."""
    import sys

    from ray_tpu_torch.serve import api as serve_api

    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(ImportError, match="grpcio"):
        serve.start(grpc_options=serve.gRPCOptions(port=0))
    assert serve.get_grpc_ingress() is None
    assert serve_api._grpc is None


@pytest.fixture
def grpc_serve(serve_instance):
    grpc = pytest.importorskip(
        "grpc", reason="grpcio is not installed: the gRPC ingress cases "
        "need it (the ingress itself raises without it, tested above)")
    serve.start(grpc_options=serve.gRPCOptions(port=0))
    try:
        yield grpc
    finally:
        from ray_tpu_torch.serve import api as serve_api

        serve_api._grpc.shutdown()
        serve_api._grpc = None


def test_grpc_unary_roundtrip_and_errors(grpc_serve):
    grpc = grpc_serve

    @serve.deployment
    class Echo:
        def __call__(self, req):
            return b"echo:" + req.body()

        def stats(self, req):
            return {"n": len(req.body())}

    serve.run(Echo.bind(), route_prefix="/echo")
    port = serve.get_grpc_ingress().port
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        call = ch.unary_unary("/ray_tpu_torch.serve/Echo")
        assert call(b"hi", timeout=T) == b"echo:hi"
        # method addressing: <deployment>.<method>
        call2 = ch.unary_unary("/ray_tpu_torch.serve/Echo.stats")
        assert json.loads(call2(b"abcd", timeout=T)) == {"n": 4}
        # unknown deployment -> NOT_FOUND
        bad = ch.unary_unary("/ray_tpu_torch.serve/Nope")
        with pytest.raises(grpc.RpcError) as e:
            bad(b"x", timeout=30)
        assert e.value.code() == grpc.StatusCode.NOT_FOUND

        # deployment exception -> INTERNAL
        @serve.deployment
        class Boom:
            def __call__(self, req):
                raise ValueError("nope")

        serve.run(Boom.bind(), route_prefix="/boom")
        boom = ch.unary_unary("/ray_tpu_torch.serve/Boom")
        with pytest.raises(grpc.RpcError) as e:
            boom(b"x", timeout=T)
        assert e.value.code() == grpc.StatusCode.INTERNAL
    finally:
        ch.close()


def test_grpc_multiplexed_metadata(grpc_serve):
    grpc = grpc_serve

    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, mid):
            return "M" + mid

        async def __call__(self, req):
            return await self.get_model(serve.get_multiplexed_model_id())

    serve.run(Multi.bind(), route_prefix="/multi")
    port = serve.get_grpc_ingress().port
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        call = ch.unary_unary("/ray_tpu_torch.serve/Multi")
        out = call(b"", timeout=T,
                   metadata=(("multiplexed-model-id", "zz"),))
        assert out == b"Mzz"
    finally:
        ch.close()

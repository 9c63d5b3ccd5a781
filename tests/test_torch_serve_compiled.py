"""The port's compiled serve dispatch plane
(``ray_tpu_torch/serve/compiled_dispatch.py``) held to the cases of the
JAX package's tests on the CPU:

- ``tests/test_serve_compiled.py``: admission and correctness on the
  ring lanes, ring-fed continuous batching with no assembly timer, async
  composition forming batches, per-item error isolation, overflow to
  eager within the budget, shedding past it with ``BackPressureError``
  (and 503 with ``retry-after`` at the HTTP proxy), the dispatch
  metrics, oversized requests and replies falling back to eager, the
  per-deployment and global opt-outs, and lanes following a rolling
  update. The reference's shed case also reads the dashboard's
  ``/api/serve/latency``, which the port does not have; here it reads
  ``serve.status()``.
- ``tests/test_serve_decode.py:130-196``: decode streams over the
  compiled stream lane, against the JAX package's ``DecodeScheduler``
  over ``ToyEngine`` (no eager fallback once warm, concurrent streams in
  one running batch, prefix-affinity routing, a malformed request
  failing fast).

Plus: ``LlamaConfig.debug()`` at fp32 through the compiled lane gives the
JAX ``LlamaDecodeEngine``'s greedy tokens, and the compiled lane's rounds
and an eager generator stepping one replica's scheduler in turn each get
every one of their own tokens.

One runtime and one serve instance serve the module (the HTTP proxy in
the driver, on a port found free); each case deletes its deployments.
JAX is imported inside the tests, never at the top: the replicas'
workers import this module.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.core.config import global_config

T = 60  # seconds any one blocking call may take


def free_port() -> int:
    """A port the OS reports free: bind port 0, read it back, close."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port():
    port = free_port()
    rt.init(num_cpus=4, num_gpus=0)
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
    """``serve.run``, then wait until the driver's HTTP proxy holds
    ``route`` (it learns the route table a moment after the deploy)."""
    from ray_tpu_torch.serve import api as serve_api

    handle = serve.run(app, route_prefix=route)
    deadline = time.time() + T
    while route not in serve_api._proxy._routes_cache \
            and time.time() < deadline:
        time.sleep(0.02)
    return handle


def _drain():
    from ray_tpu_torch.serve import observability as obs

    obs.drain_deferred()


def _rolled_out(deployment, version):
    """Whether the controller holds the deployment's target number of
    replicas, every one at ``version``."""
    from ray_tpu_torch.serve import api as serve_api

    dep = rt.get(serve_api._controller.list_deployments.remote(),
                 timeout=T).get(deployment, {})
    return dep.get("replica_versions") == [version] * dep.get("target", -1)


def _planes(deployment):
    _drain()
    return serve.status().get(deployment, {}).get("dispatch_planes", {})


# --------------------------------------------------------------------------- #
# tests/test_serve_compiled.py
# --------------------------------------------------------------------------- #


def test_compiled_plane_carries_requests(serve_instance):
    @serve.deployment
    class LaneCounter:
        def __init__(self):
            self.n = 0

        def incr(self, by, scale=1):
            self.n += by * scale
            return self.n

        def read(self):
            return self.n

    h = serve.run(LaneCounter.bind(), route_prefix=None)
    assert h.incr.remote(1).result(timeout=T) == 1
    assert h.incr.remote(2, scale=3).result(timeout=T) == 7
    assert h.read.remote().result(timeout=T) == 7
    planes = _planes("LaneCounter")
    assert planes.get("compiled", 0) >= 2, planes


def test_continuous_batch_drains_backlog_without_timer(serve_instance):
    @serve.deployment(max_inflight=8)
    class Direct:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=30.0)
        async def go(self, xs):
            self.sizes.append(len(xs))
            return [x + 1 for x in xs]

        def sizes_(self):
            return self.sizes

    h = serve.run(Direct.bind(), route_prefix=None)
    # a call of another method first builds the replica's lane: an eager
    # go(0) alone would wait out the 30 s assembly timer
    h.sizes_.remote().result(timeout=T)
    assert h.go.remote(0).result(timeout=40) == 1
    t0 = time.perf_counter()
    rs = [h.go.remote(i) for i in range(8)]
    assert [r.result(timeout=40) for r in rs] == [i + 1 for i in range(8)]
    took = time.perf_counter() - t0
    assert took < 10.0, f"batch waited out a timer: {took:.1f}s"
    assert max(h.sizes_.remote().result(timeout=T)) > 1


def test_async_composition_forms_batches(serve_instance):
    @serve.deployment(max_inflight=8)
    class Composed:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def handle_batch(self, xs):
            self.sizes.append(len(xs))
            return [x * 10 for x in xs]

        async def __call__(self, x):
            return await self.handle_batch(x)

        def sizes_(self):
            return self.sizes

    h = serve.run(Composed.bind(), route_prefix=None)
    h.remote(0).result(timeout=30)
    rs = [h.remote(i) for i in range(8)]
    assert sorted(r.result(timeout=30) for r in rs) == \
        [i * 10 for i in range(8)]
    assert max(h.sizes_.remote().result(timeout=T)) > 1


def test_per_item_error_isolation(serve_instance):
    @serve.deployment(max_inflight=8)
    class FlakyItems:
        def go(self, x):
            if x == 3:
                raise ValueError(f"bad {x}")
            return x * 2

    h = serve.run(FlakyItems.bind(), route_prefix=None)
    h.go.remote(0).result(timeout=T)
    rs = [h.go.remote(i) for i in range(6)]
    outcomes = []
    for r in rs:
        try:
            outcomes.append(("ok", r.result(timeout=30)))
        except Exception as e:  # noqa: BLE001
            outcomes.append(("err", type(e).__name__, "bad 3" in str(e)))
    assert outcomes[3][0] == "err" and outcomes[3][2], outcomes[3]
    for i in (0, 1, 2, 4, 5):
        assert outcomes[i] == ("ok", i * 2)


def test_overflow_rides_eager_within_budget(serve_instance):
    @serve.deployment(max_inflight=2)
    class WindowSlow:
        def __call__(self, x):
            time.sleep(0.15)
            return x

    h = serve.run(WindowSlow.bind(), route_prefix=None)
    h.remote(0).result(timeout=30)
    rs = [h.remote(i) for i in range(10)]
    assert sorted(r.result(timeout=T) for r in rs) == list(range(10))
    _drain()
    st = serve.status()["WindowSlow"]
    assert st.get("shed", 0) == 0
    planes = st.get("dispatch_planes", {})
    assert planes.get("compiled", 0) >= 1
    assert planes.get("eager", 0) >= 1


def test_shed_past_budget_with_typed_error(serve_instance):
    @serve.deployment(max_inflight=2, concurrency_budget=4)
    class Busy:
        def __call__(self, x):
            time.sleep(0.5)
            return x

    h = serve.run(Busy.bind(), route_prefix=None)
    h.remote(0).result(timeout=30)
    shed, responses = 0, []
    with pytest.raises(serve.BackPressureError) as ei:
        for i in range(12):
            try:
                responses.append(h.remote(i))
            except serve.BackPressureError:
                shed += 1
                if shed >= 3:
                    raise
    msg = str(ei.value)
    assert "Busy" in msg and "budget 4" in msg and "max_inflight=2" in msg
    assert ei.value.deployment == "Busy" and ei.value.budget == 4
    for r in responses:
        r.result(timeout=T)
    _drain()
    st = serve.status()["Busy"]
    assert st["shed"] >= 3
    assert st["dispatch_ms"].get("p50") is not None


def test_dispatch_metrics_surfaced(serve_instance):
    from ray_tpu_torch.util.metrics import registry, render_prometheus

    @serve.deployment
    def dispecho(x):
        return x

    h = serve.run(dispecho.bind(), route_prefix=None)
    for i in range(5):
        assert h.remote(i).result(timeout=T) == i
    _drain()
    text = render_prometheus(registry())
    assert "port_serve_dispatch_seconds_bucket" in text
    st = serve.status()["dispecho"]
    assert st["dispatch_ms"].get("p50") is not None
    assert st.get("dispatch_planes", {}).get("compiled", 0) >= 1


def test_oversized_payload_falls_back_to_eager(serve_instance):
    @serve.deployment
    class Sink:
        def size(self, blob):
            return len(blob)

    h = serve.run(Sink.bind(), route_prefix=None)
    assert h.size.remote(b"x").result(timeout=T) == 1
    big = b"x" * (global_config().serve_channel_slot_bytes + 1024)
    assert h.size.remote(big).result(timeout=T) == len(big)
    assert _planes("Sink").get("eager", 0) >= 1


def test_oversized_reply_retries_eager(serve_instance):
    @serve.deployment
    class Blower:
        def blow(self, n):
            return b"y" * n

    h = serve.run(Blower.bind(), route_prefix=None)
    assert h.blow.remote(8).result(timeout=T) == b"y" * 8
    n = global_config().serve_channel_slot_bytes + 4096
    out = h.blow.remote(n).result(timeout=120)
    assert len(out) == n
    assert _planes("Blower").get("eager", 0) >= 1

    @serve.deployment(retry_on_replica_failure=False)
    class BlowerNoRetry:
        def blow(self, n):
            return b"y" * n

    h2 = serve.run(BlowerNoRetry.bind(), route_prefix=None)
    assert h2.blow.remote(8).result(timeout=T) == b"y" * 8
    deadline = time.time() + T
    while _planes("BlowerNoRetry").get("compiled", 0) < 1:
        assert time.time() < deadline
        assert h2.blow.remote(8).result(timeout=T) == b"y" * 8
    with pytest.raises(Exception, match="slot capacity"):
        h2.blow.remote(n).result(timeout=120)


def test_deployment_opt_out_stays_eager(serve_instance):
    @serve.deployment(compiled_dispatch=False)
    def optout(x):
        return x + 1

    h = serve.run(optout.bind(), route_prefix=None)
    for i in range(4):
        assert h.remote(i).result(timeout=T) == i + 1
    planes = _planes("optout")
    assert planes.get("compiled", 0) == 0
    assert planes.get("eager", 0) >= 4


def test_global_switch_off_stays_eager(serve_instance, monkeypatch):
    monkeypatch.setattr(global_config(), "serve_compiled_dispatch", False)

    @serve.deployment
    def gateoff(x):
        return x * 2

    h = serve.run(gateoff.bind(), route_prefix=None)
    for i in range(3):
        assert h.remote(i).result(timeout=T) == i * 2
    planes = _planes("gateoff")
    assert planes.get("compiled", 0) == 0
    assert planes.get("eager", 0) >= 3


def test_rolling_update_moves_lanes_to_new_version(serve_instance):
    @serve.deployment(name="rollv", version="1")
    def v(x):
        return "v1"

    h = serve.run(v.bind(), route_prefix=None)
    assert h.remote(0).result(timeout=T) == "v1"

    @serve.deployment(name="rollv", version="2")
    def v2(x):
        return "v2"

    h = serve.run(v2.bind(), route_prefix=None)
    # wait on the controller: the rollout is done once every replica is
    # version 2 (the v1 replica retired); the handle's router then takes
    # that replica set. A "v2" reply alone comes from the surge replica
    # and says nothing of whether the v1 replica still serves.
    deadline = time.time() + 180
    while time.time() < deadline:
        if _rolled_out("rollv", "2"):
            h._router._refresh(force=True)
            break
        time.sleep(0.2)
    assert h.remote(0).result(timeout=T) == "v2"
    base = _planes("rollv").get("compiled", 0)
    deadline = time.time() + T
    while time.time() < deadline:
        assert h.remote(0).result(timeout=T) == "v2"
        if _planes("rollv").get("compiled", 0) > base:
            return
        time.sleep(0.1)
    raise AssertionError("post-update requests never rode a fresh lane")


def test_http_sheds_with_503(serve_instance):
    """The driver's proxy maps BackPressureError to 503 with
    ``retry-after: 1`` (overloaded, not broken)."""
    @serve.deployment(max_inflight=1, concurrency_budget=2,
                      retry_on_replica_failure=False)
    class Jam:
        def __call__(self, req):
            time.sleep(1.0)
            return "ok"

    run_routed(Jam.bind(), "/jam")
    url = f"http://127.0.0.1:{serve_instance}/jam"
    codes, retry_after = [], []
    lock = threading.Lock()

    def hit():
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
            with lock:
                retry_after.append(e.headers.get("retry-after"))
        with lock:
            codes.append(code)

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=T)
    assert 503 in codes, codes
    assert 200 in codes, codes
    assert "1" in retry_after, retry_after


# --------------------------------------------------------------------------- #
# tests/test_serve_decode.py:130-196: decode over the compiled stream lane
# --------------------------------------------------------------------------- #


def _toy_lm(**opts):
    @serve.deployment(decode=True, **opts)
    class ToyLane:
        def create_decode_engine(self):
            from ray_tpu_torch.serve.decode import ToyEngine

            return ToyEngine(n_pages=64, page_size=4)

    return ToyLane


def _warm_stream(handle, deployment, rounds=10):
    """Tiny streams until one rides the compiled decode lane (the first
    may land eager while the lane compiles)."""
    for _ in range(rounds):
        list(handle.options(stream=True).remote(
            {"prompt": [99, 98], "max_tokens": 1}))
        if _planes(deployment).get("compiled_stream", 0) >= 1:
            return
        time.sleep(0.5)
    raise AssertionError(
        f"stream never rode compiled_stream: {_planes(deployment)}")


def _reference_tokens(prompt, max_tokens, n_pages=64, page_size=4):
    """The JAX package's scheduler over its ToyEngine, in-process."""
    from ray_tpu.serve.decode import DecodeScheduler, ToyEngine

    sched = DecodeScheduler(ToyEngine(n_pages=n_pages, page_size=page_size))
    assert sched.submit("r", {"prompt": list(prompt),
                              "max_tokens": max_tokens}) is None
    frames, active = [], True
    while active:
        out, active = sched.step()
        frames.extend(out)
    assert frames[-1][1] == "final", frames[-1]
    return json.loads(frames[-1][2])["tokens"]


def test_stream_rides_rings_and_matches_reference(serve_instance):
    h = serve.run(_toy_lm(route_prefix=None).bind())
    _warm_stream(h, "ToyLane")
    before = _planes("ToyLane")
    items = list(h.options(stream=True).remote(
        {"prompt": [3, 1, 4], "max_tokens": 12}))
    chunks, final = items[:-1], items[-1]
    assert final["done"] is True and final["n_generated"] == 12
    assert [c["token"] for c in chunks] == final["tokens"]
    assert [c["i"] for c in chunks] == list(range(12))
    assert final["tokens"] == _reference_tokens([3, 1, 4], 12)
    after = _planes("ToyLane")
    assert after.get("compiled_stream", 0) \
        == before.get("compiled_stream", 0) + 1
    assert after.get("eager", 0) == before.get("eager", 0)


def test_driver_proxy_sse_rides_the_compiled_lane(serve_instance):
    """The default proxy runs in the driver, where the compiled plane is
    available: its SSE streams ride the decode lane the handle warmed,
    with the JAX scheduler's tokens and no eager fallback."""
    h = run_routed(_toy_lm().bind(), "/toy")
    _warm_stream(h, "ToyLane")
    before = _planes("ToyLane")
    body = json.dumps({"prompt": [3, 1, 4], "max_tokens": 12}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{serve_instance}/toy", data=body),
            timeout=T) as r:
        assert r.headers["content-type"] == "text/event-stream"
        records = [json.loads(line[len(b"data: "):])
                   for line in r.read().split(b"\n\n")
                   if line.startswith(b"data: ")]
    final = records[-1]
    assert final["done"] is True
    assert [r["token"] for r in records[:-1]] == final["tokens"]
    assert final["tokens"] == _reference_tokens([3, 1, 4], 12)
    after = _planes("ToyLane")
    assert after.get("compiled_stream", 0) \
        == before.get("compiled_stream", 0) + 1, after
    assert after.get("eager", 0) == before.get("eager", 0), after


def test_concurrent_streams_share_the_running_batch(serve_instance):
    h = serve.run(_toy_lm(route_prefix=None).bind())
    _warm_stream(h, "ToyLane")

    def run(prompt):
        return list(h.options(stream=True).remote(
            {"prompt": prompt, "max_tokens": 10}))[-1]["tokens"]

    with ThreadPoolExecutor(2) as ex:
        fa = ex.submit(run, [1, 2])
        fb = ex.submit(run, [7, 8, 9])
        assert fa.result(timeout=T) == _reference_tokens([1, 2], 10)
        assert fb.result(timeout=T) == _reference_tokens([7, 8, 9], 10)


def test_prefix_affinity_routes_repeat_prompts_to_warm_replica(
        serve_instance):
    h = serve.run(_toy_lm(route_prefix=None, num_replicas=2).bind())
    _warm_stream(h, "ToyLane")
    prompt = {"prompt": [42, 43, 44, 45], "max_tokens": 3}
    first = list(h.options(stream=True).remote(dict(prompt)))[-1]
    hits = 0
    for _ in range(3):
        final = list(h.options(stream=True).remote(dict(prompt)))[-1]
        hits += bool(final.get("cached_prefix"))
    assert hits == 3, f"first={first}, hits={hits}/3"


def test_malformed_request_fails_fast(serve_instance):
    h = serve.run(_toy_lm(route_prefix=None).bind())
    _warm_stream(h, "ToyLane")
    with pytest.raises(Exception, match="prompt"):
        list(h.options(stream=True).remote({"prompt": []}))


def test_llama_debug_greedy_tokens_over_the_compiled_lane_match_jax(
        serve_instance):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ray_tpu.models import llama as jl
    from ray_tpu.serve.decode import DecodeScheduler

    @serve.deployment(decode=True)
    class LlamaLane:
        def __init__(self, tree):
            self.tree = tree

        def create_decode_engine(self):
            import torch

            from ray_tpu_torch.models import llama as tl

            cfg = dataclasses.replace(tl.LlamaConfig.debug(),
                                      dtype=torch.float32)
            return tl.LlamaDecodeEngine(
                cfg, tl.params_from_numpy(cfg, self.tree, "cpu"),
                n_pages=32, page_size=8, device="cpu")

    jcfg = dataclasses.replace(jl.LlamaConfig.debug(), dtype=jnp.float32)
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    requests = [([3, 1, 4, 1, 5], 6), ([9, 2, 6], 5),
                ([5, 3, 5, 8, 9, 7, 9, 3, 2], 4),
                ([3, 1, 4, 1, 5], 6)]  # a prefix hit
    sched = DecodeScheduler(jl.LlamaDecodeEngine(jcfg, params, n_pages=32,
                                                 page_size=8))
    want = []
    for i, (prompt, n) in enumerate(requests):
        assert sched.submit(i, {"prompt": prompt, "max_tokens": n}) is None
        active = True
        while active:
            out, active = sched.step()
            want += [json.loads(p) for _, kind, p in out if kind == "final"]
    h = serve.run(LlamaLane.bind(tree), route_prefix=None)
    # the warm stream's prompt shares no page with the requests'
    list(h.options(stream=True).remote({"prompt": [7] * 9,
                                        "max_tokens": 1}))
    before = _planes("LlamaLane")
    got = [list(h.options(stream=True).remote(
        {"prompt": p, "max_tokens": n}))[-1] for p, n in requests]
    assert got == want
    assert got[-1]["cached_prefix"] is True
    after = _planes("LlamaLane")
    assert after.get("compiled_stream", 0) \
        == before.get("compiled_stream", 0) + len(requests), after


class _ToyCallable:
    def create_decode_engine(self):
        from ray_tpu_torch.serve.decode import ToyEngine

        return ToyEngine(n_pages=64, page_size=4)


def test_eager_steps_keep_the_compiled_lanes_frames():
    """The replica's two decode planes in one process, interleaved by
    hand: the compiled lane's rounds (``handle_request_decode``) and an
    eager generator (``handle_request_decode_stream``) step the same
    scheduler. The iterations the eager generator runs decode the
    compiled request's tokens too; the lane's next round must still
    ship every one of them, in order: its chunks are the final record's
    tokens, and those the JAX scheduler's."""
    import cloudpickle

    from ray_tpu_torch.serve.replica import ServeReplica

    replica = ServeReplica._cls(cloudpickle.dumps(_ToyCallable), (), {},
                                deployment_name="toy")
    lane = {"prompt": [3, 1, 4], "max_tokens": 12}
    frames, active = replica.handle_request_decode([(0, lane)])
    eager = replica.handle_request_decode_stream(
        {"prompt": [2, 7], "max_tokens": 12})
    eager_items = []
    while active or eager is not None:
        if eager is not None:
            item = next(eager, None)  # one eager iteration (or more)
            if item is None:
                eager = None
            else:
                eager_items.append(item)
        if active:
            out, active = replica.handle_request_decode([])
            frames += out
    chunks = [json.loads(p)["token"] for c, kind, p in frames
              if kind == "chunk"]
    finals = [json.loads(p) for c, kind, p in frames if kind == "final"]
    assert all(c == 0 for c, _, _ in frames)
    assert len(finals) == 1 and chunks == finals[0]["tokens"]
    assert chunks == _reference_tokens([3, 1, 4], 12)
    eager_chunks = [json.loads(p)["token"] for kind, p in eager_items
                    if kind == "chunk"]
    assert eager_chunks == _reference_tokens([2, 7], 12)

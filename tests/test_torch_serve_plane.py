"""Decode over the port's serve control plane, held against the JAX
package on the CPU: ``serve.run`` -> controller -> replica actor ->
``DeploymentHandle`` stream and the HTTP proxy's SSE stream, against the
JAX package's in-process ``serve/decode.py:DecodeScheduler`` on the same
prompts (the contract of ``tests/test_serve_decode.py``: SSE records whose
tokens are the final record's, eager dispatch counted; and of
``tests/test_kv_cache.py``: identical greedy tokens).

- ``ToyEngine``: the handle stream and the SSE stream give the JAX
  scheduler's frames, every stream on the ``eager`` plane.
- ``LlamaConfig.debug()`` at fp32 on the CPU, its params JAX's
  ``init_params`` carried across by ``params_from_numpy``: greedy tokens
  over HTTP equal the JAX ``LlamaDecodeEngine`` under the JAX scheduler.
- Concurrent streams on one replica run side by side.
- A replica asking for a card on this host is refused, not served on
  the CPU.

The JAX side never calls ``ray_tpu.init``: one runtime per process, the
port's. JAX is imported inside the tests, never at the top: the replicas'
workers import this module.
"""

import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve

T = 60  # seconds any one blocking call may take

TOY_PROMPTS = [([3, 1, 4], 6), ([2, 7, 1, 8, 2, 8], 9), ([5], 4),
               ([3, 1, 4], 5)]  # the last: a prefix-cache hit


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


def _jax_finals(make_engine, requests):
    """Final records of the JAX package's scheduler, in-process, for
    ``(prompt, max_tokens)`` requests submitted one after another."""
    from ray_tpu.serve.decode import DecodeScheduler

    sched = DecodeScheduler(make_engine())
    finals = []
    for i, (prompt, max_tokens) in enumerate(requests):
        assert sched.submit(i, {"prompt": list(prompt),
                                "max_tokens": max_tokens}) is None
        active = True
        while active:
            out, active = sched.step()
            finals += [json.loads(p) for _, kind, p in out
                       if kind == "final"]
    return finals


def _sse(port, path, prompt, max_tokens):
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=body), timeout=T) as r:
        assert r.headers["content-type"] == "text/event-stream"
        records = [json.loads(line[len(b"data: "):])
                   for line in r.read().split(b"\n\n")
                   if line.startswith(b"data: ")]
    assert records[-1]["done"] is True
    # each SSE record carries one token; the final record all of them
    assert [r["token"] for r in records[:-1]] == records[-1]["tokens"]
    return records[-1]


def _planes(deployment):
    from ray_tpu_torch.serve import observability as obs

    obs.drain_deferred()
    return serve.status().get(deployment, {}).get("dispatch_planes", {})


def test_toy_decode_handle_and_sse_match_the_jax_scheduler(serve_instance):
    @serve.deployment(decode=True)
    class ToyLM:
        def create_decode_engine(self):
            from ray_tpu_torch.serve.decode import ToyEngine

            return ToyEngine(n_pages=64, page_size=4)

    def jax_toy():
        from ray_tpu.serve.decode import ToyEngine

        return ToyEngine(n_pages=64, page_size=4)

    want = _jax_finals(jax_toy, TOY_PROMPTS)
    h = run_routed(ToyLM.bind(), "/lm")
    got_sse = [_sse(serve_instance, "/lm", p, n) for p, n in TOY_PROMPTS]
    assert got_sse == want
    for (prompt, n), final in zip(TOY_PROMPTS, want):
        items = list(h.options(stream=True).remote(
            {"prompt": prompt, "max_tokens": n}))
        assert [i["token"] for i in items[:-1]] == final["tokens"]
        # the replica's cache already holds every prompt
        assert items[-1] == dict(final, cached_prefix=True)
    planes = _planes("ToyLM")
    assert planes.get("eager", 0) >= 2 * len(TOY_PROMPTS), planes
    assert not [p for p in planes if p.startswith("compiled")], planes


def test_llama_debug_greedy_tokens_over_http_match_jax(serve_instance):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    @serve.deployment(decode=True)
    class LlamaLM:
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
    want = _jax_finals(lambda: jl.LlamaDecodeEngine(
        jcfg, params, n_pages=32, page_size=8), requests)
    run_routed(LlamaLM.bind(tree), "/llama")
    got = [_sse(serve_instance, "/llama", p, n) for p, n in requests]
    assert got == want
    assert got[-1]["cached_prefix"] is True
    assert not [p for p in _planes("LlamaLM") if p.startswith("compiled")]


def test_streams_on_one_replica_run_side_by_side(serve_instance):
    """Two streams of one replica overlap: the first waits inside its
    generator for the second to reach the replica. Each stream's
    generator holds a thread of the replica's for the whole request, so
    one thread for them all would never finish this."""
    @serve.deployment(stream=True, max_ongoing_requests=4)
    class Gate:
        def __init__(self):
            self.second = threading.Event()

        def __call__(self, who):
            if who == "second":
                self.second.set()
            elif not self.second.wait(timeout=20):
                raise TimeoutError("the second stream never started")
            yield who

    h = serve.run(Gate.bind(), route_prefix=None).options(
        stream=True, stream_item_timeout_s=T)
    got = {}
    first = threading.Thread(
        target=lambda: got.update(first=list(h.remote("first"))),
        daemon=True)
    first.start()
    time.sleep(0.2)
    got["second"] = list(h.remote("second"))
    first.join(timeout=T)
    assert got == {"first": ["first"], "second": ["second"]}


def test_replica_asking_for_a_card_is_refused_here(serve_instance):
    @serve.deployment(decode=True, ray_actor_options={"num_gpus": 1})
    class OnTheCard:
        def create_decode_engine(self):
            from ray_tpu_torch.models.llama import LlamaDecodeEngine

            return LlamaDecodeEngine()

    with pytest.raises(rt.PlacementGroupError,
                       match=r"cannot reserve 1 x \{'GPU': 1"):
        serve.run(OnTheCard.bind(), route_prefix=None)
    assert "OnTheCard" not in serve.status()

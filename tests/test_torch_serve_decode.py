"""Port parity: ray_tpu_torch.serve (scheduler, paged KV cache) and the
port's LlamaDecodeEngine against the JAX package's.

- The port's DecodeScheduler + LlamaDecodeEngine(device="cpu") and the JAX
  DecodeScheduler + LlamaDecodeEngine, both float32 on the same params,
  must give identical greedy tokens for every request (the contract of
  tests/test_kv_cache.py's engine tests).
- The ToyEngine schedulers must emit the same reply frames.
- Prefix hits mirror tests/test_kv_cache.py: byte-identical logits, and
  the same generation with and without a hit.
- Page accounting balances after every request retires.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import decode as jd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import decode as td
from ray_tpu_torch.serve.kv_cache import (PagePool, PrefixCache, SequenceKV,
                                          pages_for)


def _run_all(sched, reqs):
    """Submit (corr, payload) requests and step to completion; returns the
    reply frames in order, errors as (corr, "error", type name, message)."""
    frames = []
    for corr, req in reqs:
        err = sched.submit(corr, req)
        if err is not None:
            frames.append((corr, "error", type(err[2]).__name__,
                           str(err[2])))
    active = True
    while active:
        replies, active = sched.step()
        for corr, kind, payload in replies:
            if kind == "error":
                frames.append((corr, kind, type(payload).__name__,
                               str(payload)))
            else:
                frames.append((corr, kind, payload))
    return frames


def _finals(frames):
    return {f[0]: json.loads(f[2]) for f in frames if f[1] == "final"}


def _balanced(engine):
    pool, cache = engine.pool, engine.prefix_cache
    held = sum(len(e.pages) for e in cache._entries.values())
    assert pool.used == held, "pages leaked past retirement"
    assert pool.alloc_total - pool.free_total == pool.used
    cache.evict_lru(pool.n_pages)
    assert pool.used == 0 and len(cache) == 0


LLAMA_REQS = [
    ("a", {"prompt": [3, 1, 4, 1, 5], "max_tokens": 6}),
    ("b", {"prompt": [9, 2, 6], "max_tokens": 5}),
    ("c", {"prompt": [5, 3, 5, 8, 9, 7, 9, 3, 2], "max_tokens": 4}),
    ("d", {"prompt": [3, 1, 4, 1, 5], "max_tokens": 6}),  # prefix hit
]


def test_llama_schedulers_give_identical_greedy_tokens():
    jcfg = dataclasses.replace(jl.LlamaConfig.debug(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.debug(), dtype=torch.float32)
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    jeng = jl.LlamaDecodeEngine(jcfg, params, n_pages=32, page_size=8)
    teng = tl.LlamaDecodeEngine(tcfg, tl.params_from_numpy(tcfg, tree, "cpu"),
                                n_pages=32, page_size=8, device="cpu")
    want = _finals(_run_all(jd.DecodeScheduler(jeng), LLAMA_REQS))
    got = _finals(_run_all(td.DecodeScheduler(teng), LLAMA_REQS))
    assert got == want
    assert got["d"]["cached_prefix"] is True
    assert teng.prefill_calls == jeng.prefill_calls == 3
    assert teng.decode_calls == jeng.decode_calls
    _balanced(teng)


@pytest.fixture
def engine():
    # default cfg: LlamaConfig.debug() in bf16, on the CPU
    return tl.LlamaDecodeEngine(n_pages=16, page_size=4, seed=0,
                                device="cpu")


def test_prefix_hit_blob_is_cold_prefill_logits(engine):
    prompt = [3, 1, 4, 1, 5]
    cold = engine.prefill(prompt, engine.prefix_cache.alloc_with_evict(
        pages_for(len(prompt), engine.page_size)))
    sched = td.DecodeScheduler(engine)
    _run_all(sched, [("c", {"prompt": prompt, "max_tokens": 1})])
    entry = engine.prefix_cache._entries[tuple(prompt)]
    assert isinstance(entry.blob, np.ndarray)
    np.testing.assert_array_equal(entry.blob, cold)


def test_generation_identical_with_and_without_cache_hit(engine):
    sched = td.DecodeScheduler(engine)
    req = {"prompt": [7, 8, 9], "max_tokens": 6}
    cold = _finals(_run_all(sched, [("c", req)]))["c"]
    prefills = engine.prefill_calls
    warm = _finals(_run_all(sched, [("w", req)]))["w"]
    assert engine.prefill_calls == prefills, "hit must skip prefill"
    assert warm["cached_prefix"] is True and cold["cached_prefix"] is False
    assert warm["tokens"] == cold["tokens"]
    _balanced(engine)


def test_engine_stores_kv_in_compute_dtype(engine):
    c = engine.cfg
    assert engine.k_store.shape == (16, 4, c.n_layers, c.n_kv_heads,
                                    c.head_dim)
    assert engine.k_store.dtype == engine.v_store.dtype == torch.bfloat16
    assert engine.params["layers"]["wq"].dtype == torch.bfloat16
    assert engine.params["layers"]["attn_norm"].dtype == torch.float32


TOY_REQS = [
    ("a", {"prompt": [3, 1, 4, 1, 5, 9], "max_tokens": 8}),
    ("b", {"prompt": [2, 7, 1], "max_tokens": 10}),       # COW tail page
    ("c", {"prompt": [2, 7, 1], "max_tokens": 10}),       # concurrent hit
    ("bad", {"prompt": []}),                               # malformed
    ("e", {"prompt": [6, 6, 6, 6], "max_tokens": 12, "eos": 0}),
    ("big", {"prompt": list(range(200)), "max_tokens": 2}),  # never fits
    ("f", json.dumps({"prompt": [1, 2], "max_tokens": 3}).encode()),
]


@pytest.mark.parametrize("max_batch,n_pages", [(8, 32), (2, 32), (8, 6)])
def test_toy_schedulers_emit_the_same_frames(max_batch, n_pages):
    want = _run_all(jd.DecodeScheduler(jd.ToyEngine(n_pages, 4),
                                       max_batch=max_batch), TOY_REQS)
    eng = td.ToyEngine(n_pages, 4)
    sched = td.DecodeScheduler(eng, max_batch=max_batch)
    got = _run_all(sched, TOY_REQS)
    assert got == want
    assert sched.stats()["running"] == 0 and sched.stats()["waiting"] == 0
    _balanced(eng)


def test_page_pool_is_all_or_nothing_and_rejects_double_free():
    pool = PagePool(4, 2)
    pages = pool.alloc(3)
    assert pool.alloc(2) is None and pool.used == 3
    pool.release(pages[:1])
    with pytest.raises(ValueError, match="double free"):
        pool.release(pages[:1])
    with pytest.raises(ValueError, match="out of range"):
        pool.release([4])


def test_eviction_never_frees_a_referenced_prefix():
    pool = PagePool(4, 2)
    cache = PrefixCache(pool)
    held = cache.insert((1, 2, 3), 3, pool.alloc(2))   # refcount 1
    idle = cache.insert((4,), 1, pool.alloc(1))
    cache.release(idle)
    assert cache.alloc_with_evict(2) is not None       # evicts the idle one
    assert cache.lookup((1, 2, 3)) is held and cache.lookup((4,)) is None
    assert cache.alloc_with_evict(1) is None           # held pages stay


def test_sequence_kv_refuses_writes_into_shared_pages():
    kv = SequenceKV(page_size=4, shared=[7, 8], owned=[3])
    assert kv.capacity() == 12 and kv.page_for(9) == (3, 1)
    with pytest.raises(ValueError, match="copy-on-write"):
        kv.writable_for(5)
    assert kv.writable_for(8) == (3, 0)
    with pytest.raises(IndexError):
        kv.page_for(12)


def _admit_under_tail_pressure(decode):
    """A cold prompt of 5 tokens (2 pages and a copy-on-write tail page)
    on a 4-page pool with 2 pages held elsewhere: the first round has
    room for the prompt's pages but not its tail page; then the pages
    are given back and the request runs. Returns the prefills before the
    pages came back, the final frame and the engine."""
    engine = decode.ToyEngine(n_pages=4, page_size=4)
    held = engine.pool.alloc(2)
    sched = decode.DecodeScheduler(engine)
    assert sched.submit("b", {"prompt": [3, 1, 4, 1, 5],
                              "max_tokens": 2}) is None
    sched.step()
    prefills_under_pressure = engine.prefill_calls
    engine.pool.release(held)
    return prefills_under_pressure, _finals(_run_all(sched, []))["b"], \
        engine


def test_cold_prefill_reserves_its_tail_page():
    """A cold prefill runs only once its sequence's tail page is had too,
    so the request is reported cold and prefilled once. The JAX
    package's scheduler prefills into the prompt's pages, finds no tail
    page, leaves the entry idle in the prefix cache and, a round later,
    admits the request as a prefix hit (``cached_prefix`` True for a
    prompt prefilled for it; were the idle entry evicted meanwhile, the
    prompt would be prefilled twice)."""
    waited, final, engine = _admit_under_tail_pressure(td)
    assert waited == 0 and engine.prefill_calls == 1
    assert final["cached_prefix"] is False
    ref_waited, ref_final, ref_engine = _admit_under_tail_pressure(jd)
    assert ref_waited == 1 and ref_engine.prefill_calls == 1
    assert ref_final["cached_prefix"] is True
    assert final["tokens"] == ref_final["tokens"]
    _balanced(engine)

"""Port parity: the port's observability (``ray_tpu_torch/util/{metrics,
flight_recorder,program_observatory,device_telemetry}.py``, the serve
hooks) against the JAX package's on the same inputs, on the CPU.

- The metrics registry and the flight recorder are copies: the same
  calls give the same snapshot values, Prometheus text and span events,
  under names mapped ``ray_tpu_`` -> ``port_`` by :data:`PORT_NAMES`.
- The program observatory against ``observe_compiled`` over the same
  shape sequences: equal compiles, recompiles, variants and churn; FLOPs
  and bytes equal where JAX's count is the executed work (a loop-free
  program), and the analytic count where it is not (JAX counts a
  ``lax.scan`` body once).
- Observation runs a call once and changes nothing it computes.
- The serving hooks: the same requests through both packages'
  ``DecodeScheduler`` over their ``LlamaDecodeEngine`` give equal KV
  gauges, decode-bucket gauges, token counts, span counts and program
  variants.
"""

import ast
import dataclasses
import json
import pathlib
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core.config import global_config as jax_config
from ray_tpu.models import llama as jl
from ray_tpu.serve import decode as jd
from ray_tpu.serve.kv_cache import PagePool as JPagePool
from ray_tpu.serve.kv_cache import PrefixCache as JPrefixCache
from ray_tpu.serve.kv_cache import flush_kv_gauges as jax_flush_kv_gauges
from ray_tpu.util import flight_recorder as jfr
from ray_tpu.util import metrics as jm
from ray_tpu.util import xla_observatory as xo
from ray_tpu_torch.core.config import global_config as port_config
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.serve import decode as td
from ray_tpu_torch.serve.kv_cache import PagePool, PrefixCache, flush_kv_gauges
from ray_tpu_torch.util import device_telemetry
from ray_tpu_torch.util import flight_recorder as fr
from ray_tpu_torch.util import metrics as pm
from ray_tpu_torch.util import program_observatory as po
from torch.utils._python_dispatch import _get_current_dispatch_mode

ROOT = pathlib.Path(__file__).resolve().parents[1]

# every metric the port registers, from the JAX package's counterpart
PORT_NAMES = {
    "ray_tpu_xla_compiles_total": "port_program_compiles_total",
    "ray_tpu_xla_recompiles_total": "port_program_recompiles_total",
    "ray_tpu_xla_compile_seconds_total": "port_program_compile_seconds_total",
    "ray_tpu_xla_program_flops": "port_program_flops",
    "ray_tpu_xla_program_bytes_accessed": "port_program_bytes_accessed",
    "ray_tpu_xla_program_peak_bytes": "port_program_peak_bytes",
    "ray_tpu_xla_program_variants": "port_program_variants",
    "ray_tpu_xla_shape_churn": "port_program_shape_churn",
    "ray_tpu_xla_programs": "port_programs",
    "ray_tpu_xla_recompiles": "port_program_recompiles",
    "ray_tpu_device_bytes_in_use": "port_device_bytes_in_use",
    "ray_tpu_device_peak_bytes_in_use": "port_device_peak_bytes_in_use",
    "ray_tpu_jax_events_total": "port_compile_events_total",
    "ray_tpu_jax_event_duration_seconds":
        "port_compile_event_duration_seconds",
    "ray_tpu_serve_kv_pages_used": "port_serve_kv_pages_used",
    "ray_tpu_serve_kv_pages_capacity": "port_serve_kv_pages_capacity",
    "ray_tpu_serve_kv_prefix_hit_rate": "port_serve_kv_prefix_hit_rate",
    "ray_tpu_serve_decode_buckets": "port_serve_decode_buckets",
    "ray_tpu_serve_itl_seconds": "port_serve_itl_seconds",
    "ray_tpu_serve_tokens_generated_total":
        "port_serve_tokens_generated_total",
    # the runtime's copies
    "ray_tpu_badput_seconds": "port_badput_seconds",
    "ray_tpu_goodput_fraction": "port_goodput_fraction",
    "ray_tpu_checkpoint_bytes_total": "port_checkpoint_bytes_total",
    "ray_tpu_checkpoint_seconds_total": "port_checkpoint_seconds_total",
    "ray_tpu_train_step_seconds": "port_train_step_seconds",
    "ray_tpu_train_tokens_per_sec": "port_train_tokens_per_sec",
    "ray_tpu_object_store_bytes_free": "port_object_store_bytes_free",
    "ray_tpu_object_store_bytes_used": "port_object_store_bytes_used",
    "ray_tpu_object_store_evicted_bytes_total":
        "port_object_store_evicted_bytes_total",
    "ray_tpu_object_store_evicted_objects_total":
        "port_object_store_evicted_objects_total",
    "ray_tpu_object_store_fragmentation_ratio":
        "port_object_store_fragmentation_ratio",
    "ray_tpu_object_store_inline_bytes": "port_object_store_inline_bytes",
    "ray_tpu_object_store_put_bytes_total":
        "port_object_store_put_bytes_total",
    "ray_tpu_object_store_puts_total": "port_object_store_puts_total",
    "ray_tpu_object_store_restored_bytes_total":
        "port_object_store_restored_bytes_total",
    "ray_tpu_object_store_restored_objects_total":
        "port_object_store_restored_objects_total",
    "ray_tpu_object_store_spilled_bytes_total":
        "port_object_store_spilled_bytes_total",
    "ray_tpu_object_store_spilled_objects_total":
        "port_object_store_spilled_objects_total",
    "object_transfer_bytes_pulled_total":
        "port_object_transfer_bytes_pulled_total",
    "object_transfer_bytes_pushed_total":
        "port_object_transfer_bytes_pushed_total",
    "object_transfer_pool_evicted_total":
        "port_object_transfer_pool_evicted_total",
    "object_transfer_pool_hits_total": "port_object_transfer_pool_hits_total",
    "object_transfer_pool_misses_total":
        "port_object_transfer_pool_misses_total",
    "object_transfer_stripe_pulls_total":
        "port_object_transfer_stripe_pulls_total",
    "object_transfer_stripe_retries_total":
        "port_object_transfer_stripe_retries_total",
    # the data package (ingest slice)
    "ray_tpu_data_blocks_produced_total": "port_data_blocks_produced_total",
    "ray_tpu_data_bytes_produced_total": "port_data_bytes_produced_total",
    "ray_tpu_data_fused_stages_total": "port_data_fused_stages_total",
    "ray_tpu_data_fused_operators_total":
        "port_data_fused_operators_total",
    "ray_tpu_data_locality_hints_total": "port_data_locality_hints_total",
    # the serve control plane's request path
    "ray_tpu_serve_request_latency_seconds":
        "port_serve_request_latency_seconds",
    "ray_tpu_serve_handle_queue_wait_seconds":
        "port_serve_handle_queue_wait_seconds",
    "ray_tpu_serve_replica_queue_wait_seconds":
        "port_serve_replica_queue_wait_seconds",
    "ray_tpu_serve_batch_wait_seconds": "port_serve_batch_wait_seconds",
    "ray_tpu_serve_exec_seconds": "port_serve_exec_seconds",
    "ray_tpu_serve_replica_queue_depth": "port_serve_replica_queue_depth",
    "ray_tpu_serve_batch_size": "port_serve_batch_size",
    "ray_tpu_serve_batch_utilization": "port_serve_batch_utilization",
    "ray_tpu_serve_dispatch_seconds": "port_serve_dispatch_seconds",
    "ray_tpu_serve_shed_total": "port_serve_shed_total",
    "ray_tpu_serve_requests_total": "port_serve_requests_total",
    "ray_tpu_serve_errors_total": "port_serve_errors_total",
    "ray_tpu_serve_timeouts_total": "port_serve_timeouts_total",
    # compiled graphs: the ring channels, the net rings and the DAGs
    "ray_tpu_dag_channel_serialized_bytes_total":
        "port_dag_channel_serialized_bytes_total",
    "ray_tpu_dag_channel_tensor_bytes_total":
        "port_dag_channel_tensor_bytes_total",
    "ray_tpu_dag_ring_occupancy": "port_dag_ring_occupancy",
    "ray_tpu_dag_ring_stall_seconds_total":
        "port_dag_ring_stall_seconds_total",
    "ray_tpu_net_ring_retransmits_total": "port_net_ring_retransmits_total",
    "ray_tpu_dag_executions_total": "port_dag_executions_total",
}
_METRIC_CLASSES = {"Counter", "Gauge", "Histogram", "_Counter", "_Gauge"}


def registered_metric_names(package: pathlib.Path):
    """The first (name) argument of every Counter / Gauge / Histogram
    constructed in the package's sources."""
    names = set()
    for path in package.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Call) and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) else getattr(
                    fn, "attr", None)
                if name in _METRIC_CLASSES:
                    names.add(node.args[0].value)
    return names


@pytest.fixture(autouse=True)
def _fresh_programs():
    xo.reset_for_tests()
    po.reset_for_tests()
    yield
    xo.reset_for_tests()
    po.reset_for_tests()


@pytest.fixture
def all_spans():
    """Both recorders on, recording every span, rings cleared, under one
    process label (an earlier test in this process may have set the JAX
    recorder's)."""
    saved = [(m._on[0], m._min_dur[0], m._proc_label[0]) for m in (jfr, fr)]
    for m in (jfr, fr):
        m.configure(enabled=True, min_span_us=0.0)
        m.set_process_label("obs-test")
        m.reset_for_tests()
    yield
    for m, (on, min_dur, label) in zip((jfr, fr), saved):
        m.configure(enabled=on, min_span_us=min_dur * 1e6)
        m.set_process_label(label)


# --------------------------------------------------------------------------- #
# The metrics registry and the flight recorder: copies
# --------------------------------------------------------------------------- #


def test_port_names_map_every_port_metric_from_a_jax_one():
    port = registered_metric_names(ROOT / "ray_tpu_torch")
    jax_names = registered_metric_names(ROOT / "ray_tpu")
    assert set(PORT_NAMES.values()) == port
    assert set(PORT_NAMES) <= jax_names
    assert len(set(PORT_NAMES.values())) == len(PORT_NAMES)


def _drive(metrics, prefix):
    """The same calls on one package's metrics module."""
    c = metrics.Counter(prefix + "test_obs_requests_total", "requests")
    g = metrics.Gauge(prefix + "test_obs_depth", "depth")
    h = metrics.Histogram(prefix + "test_obs_latency_seconds", "latency",
                          boundaries=[0.01, 0.1, 1.0])
    for i, v in enumerate((0.005, 0.05, 0.5, 5.0, 0.05)):
        c.inc(tags={"deployment": "a" if i % 2 else "b"})
        g.set(float(i), tags={"deployment": "a"})
        h.observe(v, tags={"deployment": "a"})
    c.inc(2.5, tag_key=metrics.tags_key({"deployment": "a"}))
    return h


def test_registry_copy_gives_the_same_snapshot_text_and_series():
    reg_j, reg_p = jm._Registry(), pm._Registry()
    saved = jm._registry, pm._registry
    jm._registry, pm._registry = reg_j, reg_p
    try:
        hj = _drive(jm, "ray_tpu_")
        hp = _drive(pm, "port_")
        # the percentile fold over the same buckets (exact)
        assert hj.percentile(0.5, {"deployment": "a"}, reg_j) \
            == hp.percentile(0.5, {"deployment": "a"}, reg_p)
        assert hj.summary(reg=reg_j) == hp.summary(reg=reg_p)
    finally:
        jm._registry, pm._registry = saved
    snap_j, snap_p = reg_j.snapshot(), reg_p.snapshot()
    assert {k.replace("ray_tpu_", "port_", 1): v
            for k, v in snap_j.items()} == snap_p
    assert jm.render_prometheus(reg_j).replace("ray_tpu_", "port_") \
        == pm.render_prometheus(reg_p)
    assert {k.replace("ray_tpu_", "port_", 1): v for k, v in
            jm.aggregate_series(reg_j).items()} == \
        pm.aggregate_series(reg_p)


def test_span_events_of_the_same_records_are_equal(all_spans):
    for m in (jfr, fr):
        sp = m.register_span("test.obs_span", tag_keys=("deployment",))
        sp.end_at(10.0, 0.25, "dep")
        sp.end_at(11.0, 0.000001, "dep")
        m.register_span("test.obs_instant").instant()
    pj, pp = jfr.snapshot_payload(), fr.snapshot_payload()
    ej, ep = jfr.build_span_events([pj]), fr.build_span_events([pp])

    def rel(events, payload):
        # timestamps relative to each process's own wall anchors
        base = payload["anchor_wall"] - payload["anchor_mono"]
        return [{**e, "ts": round(e["ts"] - base * 1e6, 3) if e["ph"] == "X"
                 else None, "args": {k: v for k, v in e["args"].items()
                                     if k != "source"}}
                for e in events]

    assert rel(ej, pj) == rel(ep, pp)
    assert [e["name"] for e in ep] == ["test.obs_span", "test.obs_span",
                                       "test.obs_instant"]
    # the same payload gives the same events, byte for byte
    assert jfr.build_span_events([pp]) == fr.build_span_events([pp])
    assert fr.drain()["events"] == [list(r) for r in fr._collect(0, 2)]
    assert fr.drain() is None


def test_span_floor_and_disabled_recorder_record_nothing(all_spans):
    sp = fr.register_span("test.obs_floor")
    fr.configure(min_span_us=500.0)
    sp.end_at(1.0, 100e-6)
    assert not fr.snapshot_payload()["events"]
    fr.configure(enabled=False, min_span_us=0.0)
    assert fr.now() == 0.0
    sp.end(fr.now())
    sp.end_at(1.0, 1.0)
    assert not fr.snapshot_payload()["events"]
    fr.configure(enabled=True)
    t = fr.now()
    sp.end(t)
    assert len(fr.snapshot_payload()["events"]) == 1
    with pytest.raises(ValueError):
        fr.register_span("test.obs_floor", tag_keys=("other",))


def test_config_copies_the_jax_fields_and_env_overrides(monkeypatch):
    from ray_tpu.core.config import Config as JaxConfig
    from ray_tpu_torch.core.config import Config

    port = {f.name: f.default for f in dataclasses.fields(Config)}
    jaxc = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert port == {k: jaxc[k] for k in port}
    monkeypatch.setenv("RAY_TPU_XLA_OBSERVATORY_ENABLED", "0")
    monkeypatch.setenv("RAY_TPU_FLIGHT_RECORDER_MIN_SPAN_US", "12.5")
    cfg = Config()
    assert cfg.xla_observatory_enabled is False
    assert cfg.flight_recorder_min_span_us == 12.5
    assert JaxConfig().xla_observatory_enabled is False


_ADOPT = """
import json
from ray_tpu_torch.util import flight_recorder as fr
{configure}
sp = fr.register_span("test.adopt")
sp.end(fr.now())
print(json.dumps({{"on": fr.enabled(), "min_us": fr._min_dur[0] * 1e6,
                  "capacity": fr._capacity, "window": fr._dump_window_s[0],
                  "spans": len(fr.snapshot_payload()["events"])}}))
"""


def _adopted(env, configure=""):
    out = subprocess.run(
        [sys.executable, "-c", _ADOPT.format(configure=configure)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, **env})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_recorder_adopts_the_config_knobs_on_first_use():
    # a fresh process each: the recorder adopts the global config once.
    # Every knob set through the environment takes effect: the floor (a
    # span of a few microseconds is recorded only with it at 0), the
    # ring's capacity, the dump window and the switch; an explicit
    # configure() before first use overrides the config, never the
    # reverse
    env = {"RAY_TPU_FLIGHT_RECORDER_MIN_SPAN_US": "0",
           "RAY_TPU_FLIGHT_RECORDER_EVENTS": "2048",
           "RAY_TPU_FLIGHT_RECORDER_DUMP_WINDOW_S": "3.5"}
    assert _adopted(env) == {"on": True, "min_us": 0.0, "capacity": 2048,
                             "window": 3.5, "spans": 1}
    assert _adopted({**env, "RAY_TPU_FLIGHT_RECORDER": "0"})["spans"] == 0
    assert _adopted(env, "fr.configure(min_span_us=1e9)") == {
        "on": True, "min_us": 1e9, "capacity": 2048, "window": 3.5,
        "spans": 0}
    defaults = _adopted({})
    assert (defaults["min_us"], defaults["capacity"]) == (500.0, 65536)


# --------------------------------------------------------------------------- #
# The program observatory against observe_compiled
# --------------------------------------------------------------------------- #


def _counts(rec):
    return {k: rec[k] for k in ("compiles", "recompiles", "variants")}


def _churn(rec):
    return [(c["from"], c["to"]) for c in rec["churn"]]


def test_matmul_counts_equal_jax_exactly():
    # a loop-free program: JAX's cost_analysis is the executed work, and
    # the dispatch-level count reads the same, exactly
    jfn = xo.observe_compiled(jax.jit(lambda m: m @ m), "obs.mm")
    pfn = po.observe_program(lambda m: m @ m, "obs.mm")
    x = np.ones((64, 64), np.float32)
    np.testing.assert_array_equal(np.asarray(jfn(jnp.asarray(x))),
                                  pfn(torch.from_numpy(x)).numpy())
    j, p = xo.get_program("obs.mm"), po.get_program("obs.mm")
    assert j["flops"] == p["flops"] == 524_288.0
    assert j["bytes_accessed"] == p["bytes_accessed"] == 49_152.0
    assert j["avals"] == p["avals"] == "f32[64,64]"
    assert _counts(j) == _counts(p)
    assert p["memory"]["argument"] == 16_384
    assert p["peak_bytes"] == 32_768  # the argument and the output


def test_shape_sequence_gives_jax_compiles_recompiles_and_churn():
    jfn = xo.observe_compiled(jax.jit(lambda x: x + 1), "obs.seq")
    pfn = po.observe_program(lambda x: x + 1, "obs.seq")
    for n in (4, 5, 6, 5, 4, 7):
        jfn(jnp.zeros((n,), jnp.float32))
        pfn(torch.zeros((n,)))
    j, p = xo.get_program("obs.seq"), po.get_program("obs.seq")
    assert _counts(j) == _counts(p) == {"compiles": 4, "recompiles": 3,
                                        "variants": 4}
    assert _churn(j) == _churn(p) == [("f32[4]", "f32[5]"),
                                      ("f32[5]", "f32[6]"),
                                      ("f32[6]", "f32[7]")]
    flat = pm.aggregate_series(pm.registry())
    churn = [dict(t) for t, _ in flat["port_program_shape_churn"]
             if dict(t)["program"] == "obs.seq"]
    assert {"program": "obs.seq", "from": "f32[4]", "to": "f32[5]"} in churn


def test_scalars_fake_no_recompile():
    jfn = xo.observe_compiled(jax.jit(lambda x, s: x * s), "obs.scalar")
    pfn = po.observe_program(lambda x, s: x * s, "obs.scalar")
    for s in (2.0, 3.0, 4.5):
        assert float(jfn(jnp.ones((3,), jnp.float32), s)[0]) \
            == float(pfn(torch.ones(3), s)[0]) == s
    assert _counts(xo.get_program("obs.scalar")) \
        == _counts(po.get_program("obs.scalar")) \
        == {"compiles": 1, "recompiles": 0, "variants": 1}


def test_later_new_fingerprints_are_counted_not_analysed():
    # a wrapper analyses its first ANALYSED_FIRST_CALLS new fingerprints;
    # a later one runs as it is, outside any dispatch mode, and is counted
    # from its fingerprint: the same compiles, recompiles, variants and
    # churn as JAX's, the count columns those of the latest analysed call
    assert po.ANALYSED_FIRST_CALLS == 1
    modes = []

    def fn(x):
        modes.append(_get_current_dispatch_mode() is not None)
        return x @ x

    capped = po.observe_program(fn, "obs.capped")
    jfn = xo.observe_compiled(jax.jit(lambda x: x @ x), "obs.capped")
    for n in (4, 8, 4, 16):
        capped(torch.ones(n, n))
        jfn(jnp.ones((n, n), jnp.float32))
    assert modes == [True, False, False, False]
    rec = po.get_program("obs.capped")
    assert _counts(rec) == _counts(xo.get_program("obs.capped")) == {
        "compiles": 3, "recompiles": 2, "variants": 3}
    assert _churn(rec) == _churn(xo.get_program("obs.capped"))
    assert rec["analysed"] == 1
    assert [(v["analysed"], v.get("flops")) for v in rec["by_variant"]] \
        == [(True, 128.0), (False, None), (False, None)]
    assert rec["flops"] == 128.0 and rec["avals"] == "f32[16,16]"

    modes.clear()
    every = po.observe_program(fn, "obs.every")
    every.max_analysed = None
    for n in (4, 8, 4, 16):
        every(torch.ones(n, n))
    assert modes == [True, True, False, True]
    rec = po.get_program("obs.every")
    assert rec["analysed"] == rec["compiles"] == 3
    assert [v["flops"] for v in rec["by_variant"]] \
        == [2.0 * n ** 3 for n in (4, 8, 16)]


def test_disabled_knob_is_a_passthrough():
    jcfg, pcfg = jax_config(), port_config()
    fn = lambda x: x - 1  # noqa: E731
    try:
        jcfg.xla_observatory_enabled = pcfg.xla_observatory_enabled = False
        assert po.observe_program(fn, "obs.off") is fn
        jitted = jax.jit(fn)
        assert xo.observe_compiled(jitted, "obs.off") is jitted
        # a wrapper built while on runs plainly, recording nothing, once
        # the knob is off
        pcfg.xla_observatory_enabled = True
        wrapped = po.observe_program(lambda x: x - 2, "obs.off2")
        pcfg.xla_observatory_enabled = False
        assert float(wrapped(torch.zeros(2))[0]) == -2.0
        assert po.get_program("obs.off2") is None
        assert not wrapped.probe(torch.zeros(2))
    finally:
        jcfg.xla_observatory_enabled = pcfg.xla_observatory_enabled = True


def test_debug_forward_counts_the_executed_flops():
    """The port counts what runs: 2 * 90,112 matmul weights * 128 tokens
    = 23,068,672, plus 4,194,304 for attention's QK^T and PV over the full
    T x T (the plain version's einsums on the CPU; on the card the kernel
    reports the causal half). It is not compared with JAX's cost_analysis,
    which reads 16,893,954 here: JAX runs the layers under ``lax.scan``
    and counts the body once whatever the trip count."""
    cfg = tl.LlamaConfig.debug()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 64)))
    fwd = po.observe_program(tl.forward, "obs.forward")
    with torch.no_grad():
        fwd(cfg, params.tree(), tokens)
    rec = po.get_program("obs.forward")
    weights = cfg.n_layers * (2 * cfg.dim * cfg.n_heads * cfg.head_dim
                              + 2 * cfg.dim * cfg.n_kv_heads * cfg.head_dim
                              + 3 * cfg.dim * cfg.mlp_dim) \
        + cfg.dim * cfg.vocab_size
    attention = cfg.n_layers * 2 * 2 * 2 * cfg.n_heads * 64 * 64 \
        * cfg.head_dim
    assert weights == 90_112 and attention == 4_194_304
    assert rec["flops"] == 2 * weights * 128 + attention == 27_262_976
    assert rec["flops_by_op"] == {"aten.mm": 23_068_672,
                                  "aten.bmm": 4_194_304}
    assert "kernels" not in rec  # the plain version launches nothing


def _train_state(observe):
    cfg = dataclasses.replace(tl.LlamaConfig.debug(), remat=True,
                              loss_chunk=16)
    init_state, train_step = tl.make_train_step(cfg, device="cpu")
    if observe:
        train_step = po.observe_program(train_step, "obs.train_step")
    state = init_state(0)
    tokens = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 65)))
    loss = train_step(state, tokens)
    return state, loss


def test_observed_train_step_updates_the_state_exactly_once():
    plain, plain_loss = _train_state(False)
    seen, seen_loss = _train_state(True)
    assert seen["step"] == plain["step"] == 1
    assert float(seen_loss) == float(plain_loss)
    for (name, a), (_, b) in zip(plain["params"].named_parameters(),
                                 seen["params"].named_parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(a.grad, b.grad), name
    rec = po.get_program("obs.train_step")
    assert rec["compiles"] == 1 and rec["flops"] > 0


def test_failed_bookkeeping_keeps_the_result_and_never_replays(monkeypatch):
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    monkeypatch.setattr(po._CountingMode, "_note",
                        lambda *a: (_ for _ in ()).throw(RuntimeError()))
    wrapped = po.observe_program(fn, "obs.broken")
    out = wrapped(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0)) and len(calls) == 1
    rec = po.get_program("obs.broken")
    assert rec["compiles"] == 1 and rec["analysis_failed"] is True
    assert "flops" not in rec
    wrapped(torch.ones(3))
    assert len(calls) == 2 and po.get_program("obs.broken")["compiles"] == 1


def test_own_exceptions_pass_through_and_prestart_failures_fall_back():
    def boom(x):
        raise KeyError("the function's own")

    wrapped = po.observe_program(boom, "obs.raises")
    with pytest.raises(KeyError, match="the function's own"):
        wrapped(torch.ones(1))
    assert po.get_program("obs.raises") is None  # analysed again next time

    class Unfingerprintable:
        @property
        def shape(self):
            raise RuntimeError("no shape")

        dtype = "f32"

    ran = []
    wrapped = po.observe_program(lambda x: ran.append(x) or "ran",
                                 "obs.fallback")
    assert wrapped(Unfingerprintable()) == "ran"
    assert wrapped._fallback and len(ran) == 1
    assert wrapped(torch.ones(1)) == "ran"  # permanent
    assert po.get_program("obs.fallback") is None


def test_kernel_tally_counts_other_threads_while_open():
    shape = (2, 128, 8, 2, 64, True)
    fa.report_kernel_work("fwd", *shape)  # none open: not counted anywhere
    with fa.KernelTally() as tally:
        worker = threading.Thread(
            target=lambda: [fa.report_kernel_work(k, *shape)
                            for k in ("dq", "dkv", "dkv")])
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        fa.report_kernel_work("fwd", *shape)
    fa.report_kernel_work("fwd", *shape)  # closed again
    want = {k: fa.attention_work(*shape, k) for k in ("fwd", "dq", "dkv")}
    assert tally.counts == {
        "fwd": {"launches": 1, "flops": want["fwd"][0],
                "bytes": want["fwd"][1]},
        "dq": {"launches": 1, "flops": want["dq"][0],
               "bytes": want["dq"][1]},
        "dkv": {"launches": 2, "flops": 2 * want["dkv"][0],
                "bytes": 2 * want["dkv"][1]}}
    assert tally.total("launches") == 4
    assert not fa._open_tallies


def test_attention_work_counts_the_unmasked_pairs():
    B, T, Hq, Hkv, D = 1, 4, 2, 1, 8
    assert fa.attention_work(B, T, Hq, Hkv, D, True, "fwd")[0] \
        == 2 * 2 * D * 10 * B * Hq
    assert fa.attention_work(B, T, Hq, Hkv, D, False, "dkv")[0] \
        == 2 * 4 * D * 16 * B * Hq
    # bf16 q, k, v, o and an fp32 lse row a query
    assert fa.attention_work(B, T, Hq, Hkv, D, True, "fwd")[1] \
        == 2 * B * T * D * (2 * Hq + 2 * Hkv) + 4 * B * Hq * T


def test_report_joins_measured_spans_and_rooflines(all_spans):
    from ray_tpu_torch.train.spmd import _sp_compute

    fn = po.observe_program(lambda m: m @ m, "spmd.train_step")
    x = torch.ones((64, 64))
    for _ in range(3):
        t0 = fr.now()
        fn(x)
        _sp_compute.end(t0)
    report = po.program_report()
    assert report["platform"] == "cpu"
    assert report["peak_flops_per_chip"] > 0 and report["ridge_intensity"] > 0
    row = report["programs"]["spmd.train_step"]
    assert row["measured_span"] == "spmd.compute"
    assert row["measured_steps"] == 3 and row["mean_step_s"] > 0
    assert 0 < row["mfu"] < 1
    assert row["arithmetic_intensity"] == round(524_288 / 49_152, 4)
    assert row["verdict"] in ("compute-bound", "memory-bound")
    assert row["verdict_enforced"] is False  # CPU: trend-only
    # spans before a mark are left out
    assert "measured_span" not in po.program_report(
        fr.next_seq())["programs"]["spmd.train_step"]
    text = po.format_programs(report)
    assert "spmd.train_step" in text and "trend-only" in text
    assert "measured: 3 x spmd.compute" in text
    assert dict(pm.aggregate_series(pm.registry())["port_programs"])[()] \
        == float(len(report["programs"]))


def test_peak_table_and_overrides():
    assert po.peaks_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert po.peaks_for("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    assert po.peaks_for("NVIDIA H100 NVL") == (835e12, 3.9e12)
    assert po.peaks_for("NVIDIA H200") == (989e12, 4.8e12)
    assert po.peaks_for("NVIDIA A100-SXM4-80GB") is None  # no made-up peak
    cfg = port_config()
    try:
        cfg.xla_peak_flops, cfg.xla_peak_hbm_bytes = 123e12, 456e9
        assert po.peak_flops_per_chip() == 123e12
        assert po.peak_hbm_bytes_per_sec() == 456e9
    finally:
        cfg.xla_peak_flops = cfg.xla_peak_hbm_bytes = 0.0
    assert po.peak_flops_per_chip() == po._CPU_NOMINAL_FLOPS


# --------------------------------------------------------------------------- #
# Device telemetry
# --------------------------------------------------------------------------- #


class _FakeCard:
    type = "cuda"

    def __init__(self, index, current, peak):
        self.index = index
        self._stats = {"allocated_bytes.all.current": current,
                       "allocated_bytes.all.peak": peak}

    def memory_stats(self):
        return self._stats


class _UntouchedCard(_FakeCard):
    def __init__(self, index):
        super().__init__(index, 0, 0)  # this process never allocated


class _BrokenCard:
    type, index = "cuda", 9

    def memory_stats(self):
        raise RuntimeError("no stats")


def test_telemetry_publishes_tagged_gauges_like_jax():
    from ray_tpu.util import device_telemetry as jt

    class _JaxCard:
        platform = "cuda"

        def __init__(self, i, in_use, peak):
            self.id = i
            self._s = {"bytes_in_use": in_use, "peak_bytes_in_use": peak}

        def memory_stats(self):
            return self._s

    n = device_telemetry.collect_device_stats(
        [_FakeCard(0, 1024, 4096), _FakeCard(1, 2048, 8192),
         _UntouchedCard(2), _BrokenCard()], node_hex="abcdef0123456789")
    assert n == 2
    assert jt.collect_device_stats(
        [_JaxCard(0, 1024, 4096), _JaxCard(1, 2048, 8192)],
        node_hex="abcdef0123456789") == 2
    snap_p, snap_j = pm.registry().snapshot(), jm.registry().snapshot()
    for port, jax_name in (("port_device_bytes_in_use",
                            "ray_tpu_device_bytes_in_use"),
                           ("port_device_peak_bytes_in_use",
                            "ray_tpu_device_peak_bytes_in_use")):
        for i in (0, 1):
            key = (("device", f"cuda:{i}"), ("node", "abcdef01"))
            assert snap_p[port]["values"][key] \
                == snap_j[jax_name]["values"][key]
        assert (("device", "cuda:2"), ("node", "abcdef01")) \
            not in snap_p[port]["values"]


def test_compile_events_are_counted():
    before = pm.registry().snapshot().get(
        "port_compile_events_total", {}).get("values", {})
    key = (("event", "program.first_call"),)
    po.observe_program(lambda x: x + 1, "obs.event")(torch.ones(2))
    device_telemetry.record_compile_event("kernel.build", 2.5)
    snap = pm.registry().snapshot()
    assert snap["port_compile_events_total"]["values"][key] \
        == before.get(key, 0.0) + 1
    hist = snap["port_compile_event_duration_seconds"]["values"][
        (("event", "kernel.build"),)]
    assert hist["count"] >= 1 and hist["le"][10] >= 1


def test_telemetry_knobs_gate_collection_and_set_the_interval(monkeypatch):
    knobs = port_config()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(device_telemetry, "CudaDevice",
                        lambda i: _FakeCard(i, 512, 1024))
    assert device_telemetry.collect_once() == 1
    monkeypatch.setattr(knobs, "device_telemetry_enabled", False)
    assert device_telemetry.collect_once() == 0
    assert device_telemetry.start_device_telemetry() is None
    monkeypatch.setattr(knobs, "device_telemetry_enabled", True)
    # the thread ticks at the knob's interval (the default, 10 s, would
    # give no tick within the wait)
    ticks = []
    monkeypatch.setattr(device_telemetry, "collect_once",
                        lambda node_hex="": ticks.append(node_hex) or 1)
    monkeypatch.setattr(knobs, "device_telemetry_interval_ms", 50)
    stop = device_telemetry.start_device_telemetry()
    try:
        deadline = time.monotonic() + 5.0
        while len(ticks) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
    assert len(ticks) >= 2


def test_collect_once_never_initialises_cuda():
    code = """
import json, torch
from ray_tpu_torch.util import device_telemetry
n = device_telemetry.collect_once()
print(json.dumps({"n": n, "initialized": torch.cuda.is_initialized()}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "n": 0, "initialized": False}


# --------------------------------------------------------------------------- #
# The serving hooks against the JAX scheduler's
# --------------------------------------------------------------------------- #


def test_kv_gauges_equal_the_jax_ones_on_the_same_pool_states():
    dep = "obs-kv-gauges"
    pools = [(JPagePool(16, 4), JPrefixCache), (PagePool(16, 4), PrefixCache)]
    caches = []
    for pool, cache_cls in pools:
        cache = cache_cls(pool)
        pages = cache.alloc_with_evict(3)
        entry = cache.insert((1, 2, 3), 3, pages)
        cache.release(entry)
        cache.lookup((1, 2, 3))
        cache.lookup((9,))
        caches.append(cache)
    jax_flush_kv_gauges(dep, pools[0][0], caches[0])
    flush_kv_gauges(dep, pools[1][0], caches[1])
    snap_j, snap_p = jm.registry().snapshot(), pm.registry().snapshot()
    tags = (("deployment", dep),)
    for name in ("ray_tpu_serve_kv_pages_used",
                 "ray_tpu_serve_kv_pages_capacity",
                 "ray_tpu_serve_kv_prefix_hit_rate"):
        assert snap_p[PORT_NAMES[name]]["values"][tags] \
            == snap_j[name]["values"][tags]
    assert snap_p["port_serve_kv_pages_used"]["values"][tags] \
        == float(pools[1][0].used) == 3.0


REQS = [
    ("a", {"prompt": [3, 1, 4, 1, 5], "max_tokens": 6}),
    ("b", {"prompt": [9, 2, 6, 5, 3, 5, 8, 9, 7], "max_tokens": 12}),
    ("c", {"prompt": list(range(1, 18)), "max_tokens": 4}),
    ("d", {"prompt": [3, 1, 4, 1, 5], "max_tokens": 6}),  # prefix hit
]


def _serve(sched):
    finals, active = {}, True
    for corr, req in REQS:
        assert sched.submit(corr, req) is None
    while active:
        replies, active = sched.step()
        for corr, kind, payload in replies:
            assert kind != "error", payload
            if kind == "final":
                finals[corr] = json.loads(payload)["tokens"]
    return finals


def _span_counts(events, dep):
    out = {}
    for e in events:
        if e["args"].get("deployment") == dep:
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _series(snap, name, dep=None, **tags):
    key = tuple(sorted(({"deployment": dep} if dep else tags).items()))
    return snap[name]["values"].get(key)


def test_serving_hooks_match_the_jax_scheduler(all_spans):
    jcfg = dataclasses.replace(jl.LlamaConfig.debug(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.debug(), dtype=torch.float32)
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    jeng = jl.LlamaDecodeEngine(jcfg, params, n_pages=32, page_size=4)
    teng = tl.LlamaDecodeEngine(tcfg, tl.params_from_numpy(tcfg, tree, "cpu"),
                                n_pages=32, page_size=4, device="cpu")
    jdep, tdep = "obs-serve-jax", "obs-serve-port"
    jsched = jd.DecodeScheduler(jeng, deployment=jdep)
    tsched = td.DecodeScheduler(teng, deployment=tdep)
    assert _serve(jsched) == _serve(tsched)
    for sched, eng in ((jsched, jeng), (tsched, teng)):
        sched._next_gauge = 0.0  # flush on the next (idle) iteration
        sched.step()
    snap_j, snap_p = jm.registry().snapshot(), pm.registry().snapshot()

    # KV gauges against each pool's ground truth, and against each other
    for name in ("ray_tpu_serve_kv_pages_used",
                 "ray_tpu_serve_kv_pages_capacity",
                 "ray_tpu_serve_kv_prefix_hit_rate"):
        assert _series(snap_p, PORT_NAMES[name], tdep) \
            == _series(snap_j, name, jdep)
    assert _series(snap_p, "port_serve_kv_pages_used", tdep) \
        == float(teng.pool.used)
    assert _series(snap_p, "port_serve_kv_prefix_hit_rate", tdep) \
        == teng.prefix_cache.hit_rate == 0.25
    # decode buckets (one gauge a kind) and the programs' variants
    assert teng.buckets() == {k: sorted(v) for k, v in jeng._buckets.items()}
    for kind in ("prefill", "decode"):
        assert _series(snap_p, "port_serve_decode_buckets", kind=kind) \
            == _series(snap_j, "ray_tpu_serve_decode_buckets", kind=kind) \
            == len(teng.buckets()[kind])
    for program, kind in (("llama.prefill", "prefill"),
                          ("llama.decode", "decode")):
        j, p = xo.get_program(program), po.get_program(program)
        assert _counts(j) == _counts(p)
        assert p["variants"] == len(teng.buckets()[kind])
        assert p["recompiles"] == p["variants"] - 1
        assert p["analysed"] == 1  # the first bucket; the rest counted
    # tokens generated and inter-token latencies
    tokens = _series(snap_p, "port_serve_tokens_generated_total", tdep)
    assert tokens == _series(snap_j, "ray_tpu_serve_tokens_generated_total",
                             jdep) == sum(r["max_tokens"] for _, r in REQS)
    assert _series(snap_p, "port_serve_itl_seconds", tdep)["count"] \
        == _series(snap_j, "ray_tpu_serve_itl_seconds", jdep)["count"] \
        == tokens - len(REQS)
    # one serve.prefill span an admission, one serve.decode_step span an
    # iteration that decoded
    spans_j = _span_counts(jfr.build_span_events([jfr.snapshot_payload()]),
                           jdep)
    spans_p = _span_counts(fr.build_span_events([fr.snapshot_payload()]),
                           tdep)
    assert spans_p == spans_j
    assert spans_p["serve.prefill"] == tsched.admitted == len(REQS)
    assert spans_p["serve.decode_step"] == max(
        r["max_tokens"] for _, r in REQS) - 1


def test_observed_engine_serves_the_same_tokens_as_unobserved():
    cfg = tl.LlamaConfig.debug()

    def run(observe):
        knobs = port_config()
        knobs.xla_observatory_enabled = observe
        try:
            eng = tl.LlamaDecodeEngine(cfg, n_pages=32, page_size=4, seed=0,
                                       device="cpu")
            return _serve(td.DecodeScheduler(eng)), eng
        finally:
            knobs.xla_observatory_enabled = True

    (off, eng_off), (on, eng_on) = run(False), run(True)
    assert off == on
    assert eng_off.buckets() == eng_on.buckets()
    assert not hasattr(eng_off._decode_fn, "probe")
    args = eng_on.decode_inputs(5, 1, [0, 1])
    assert po.get_program("llama.decode")["variants"] \
        == len(eng_on.buckets()["decode"])
    assert eng_on._decode_fn.probe(*args)  # a seen bucket


def test_churn_names_the_leaves_that_moved():
    # the decode engine's programs lead with the params: a new bucket's
    # churn names the cache view that moved, not the unchanged weights
    fn = po.observe_program(lambda params, kv: kv.sum(), "obs.churn")
    params = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    for n in (8, 16, 8):
        fn(params, torch.ones(2, n, 3))
    rec = po.get_program("obs.churn")
    assert rec["avals"] == "f32[4,4];f32[4];f32[2,16,3]"
    assert _churn(rec) == [("f32[2,8,3]", "f32[2,16,3]")]
    assert _counts(rec) == {"compiles": 2, "recompiles": 1, "variants": 2}

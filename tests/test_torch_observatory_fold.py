"""The program observatory's head-side fold and two repairs of the port's
observation plane, held against the JAX package on the CPU.

- The fold (``program_report(head=...)``, the counterpart of
  ``ray_tpu.util.xla_observatory.xla_report``): the same metric series
  and spans, renamed ``ray_tpu_xla_*`` -> ``port_program_*``, give the
  same columns; across processes, a worker's program reaches
  ``GET /api/xla`` with the counts of its own report; a churning
  program's recompile storm shows in the cluster events, the API and the
  CLI (``tests/test_xla_observatory.py:159`` and ``:351``).
- The goodput ledger's compile column back-fills from the port's own
  first-call span, ``program.first_call``
  (``tests/test_xla_observatory.py:296-322``, where the span is JAX's
  ``xla.compile``).
- ``_CountingMode`` frees a storage whose finalizer runs on a thread
  inside the mode's lock (a GC-reentrant lock before).

Metric counters are process-global and cumulative, so programs carry
unique names, or their head-local series are cleared first.
"""

import argparse
import gc
import itertools
import json
import threading
import time
import types
import urllib.request

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core.config import global_config
from ray_tpu_torch.util import flight_recorder as fr
from ray_tpu_torch.util import goodput
from ray_tpu_torch.util import program_observatory as po
from ray_tpu_torch.util.metrics import registry

T = 60  # seconds any one blocking call may take


def _span(name, src, ts_s, dur_s, **extra):
    return {"ph": "X", "cat": "span", "name": name,
            "ts": ts_s * 1e6, "dur": dur_s * 1e6,
            "args": {"source": src, **extra}}


@pytest.fixture
def every_span():
    """Record every span, however short; restore the floor after."""
    saved = fr._min_dur[0] * 1e6
    fr.configure(enabled=True, min_span_us=0.0)
    fr.reset_for_tests()
    yield
    fr.configure(min_span_us=saved)
    fr.reset_for_tests()


def _forget(reg, program: str) -> None:
    """Drop every series of ``program`` from a registry, this process's
    and the merged sources' (earlier tests in the process may have
    observed the same name)."""
    with reg._lock:
        for name, m in reg.metrics.items():
            for values in [m["values"], *(m.get("sources") or {}).values()]:
                for tags in [t for t in values
                             if dict(t).get("program") == program]:
                    del values[tags]


def _forget_local(program: str) -> None:
    _forget(registry(), program)


# --------------------------------------------------------------------------- #
# Repair: the finalizer never takes the mode's lock
# --------------------------------------------------------------------------- #


def test_counting_mode_frees_a_storage_inside_its_lock():
    """A storage whose last reference goes in a GC cycle is freed by
    ``gc.collect()`` on a thread already holding ``_CountingMode._lock``:
    its finalizer must not wait for that lock."""
    mode = po._CountingMode({})
    x = torch.ones(256)
    out = x.clone()
    nbytes = out.untyped_storage().nbytes()
    mode._note(torch.ops.aten.clone.default, (x,), {}, [x], out)
    assert mode.live == nbytes and mode.peak_live == nbytes
    cycle = [out]
    cycle.append(cycle)
    del out, cycle
    gc.disable()   # the collection runs below, inside the lock
    try:
        def collect_inside_the_lock():
            with mode._lock:
                gc.collect()

        th = threading.Thread(target=collect_inside_the_lock, daemon=True)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive(), "the finalizer deadlocked on the lock"
    finally:
        gc.enable()
    # the free is queued, and the lock's next holder releases it
    assert mode.output_bytes(()) == 0
    assert mode.live == 0 and mode.peak_live == nbytes


# --------------------------------------------------------------------------- #
# Repair: the goodput compile column back-fills from program.first_call
# --------------------------------------------------------------------------- #


def _first_call_events():
    return [
        _span("spmd.compute", "A", 0.0, 1.0),
        _span("spmd.compile", "A", 1.0, 2.0),
        # the same wall time seen program by program on A: must NOT add
        _span("program.first_call", "A", 1.0, 1.5,
              program="spmd.train_step"),
        # a source that never reaches the spmd seam (a serve replica's
        # decode): its first calls are its only compile signal
        _span("program.first_call", "B", 1.0, 0.5, program="llama.decode"),
    ]


def test_goodput_compile_column_backfills_from_first_call_spans():
    events = _first_call_events()
    ledger = goodput.classify_badput(events)
    assert ledger["window"]["wall_s"] == pytest.approx(3.0)
    assert ledger["badput_s"]["compile"] == pytest.approx(1.25)  # mean(2, .5)
    assert ledger["goodput_s"] == pytest.approx(1.0)

    # first calls never define the window ...
    widened = goodput.classify_badput(
        events + [_span("program.first_call", "B", 10.0, 5.0,
                        program="x")])
    assert widened["window"]["wall_s"] == pytest.approx(3.0)
    # ... and alone they make an empty ledger
    only = goodput.classify_badput(
        [_span("program.first_call", "B", 0.0, 5.0, program="x")])
    assert only["window"]["wall_s"] == 0.0 and only["steps"] == 0


def _payload(records, source):
    """One span payload as a worker drains it: wall anchor 0, so a
    record's monotonic start is its wall time."""
    names = {}
    events = []
    for seq, (name, tag_keys, t0, dur, tags) in enumerate(records):
        sid = next((i for i, d in names.items() if d["name"] == name),
                   len(names))
        names[sid] = {"name": name, "tag_keys": list(tag_keys)}
        events.append([seq, sid, fr.KIND_SPAN, t0, dur, list(tags)])
    return {"pid": 1, "proc": source, "anchor_mono": 0.0,
            "anchor_wall": 0.0, "names": names, "events": events,
            "source": source}


def test_live_ledger_backfills_from_first_call_spans(every_span):
    """The health monitor's incremental ledger agrees with the offline
    fold on the same spans."""
    head = types.SimpleNamespace(flight_spans={
        "A": [_payload([("spmd.compute", (), 0.0, 1.0, ()),
                        ("spmd.compile", (), 1.0, 2.0, ()),
                        ("program.first_call", ("program",), 1.0, 1.5,
                         ("spmd.train_step",))], "A")],
        "B": [_payload([("program.first_call", ("program",), 1.0, 0.5,
                         ("llama.decode",))], "B")]},
        nodes={})
    acc = goodput.LedgerAccumulator()
    acc.fold(head)
    live = acc.ledger()
    offline = goodput.goodput_report(head)
    assert live["badput_s"]["compile"] == pytest.approx(1.25)
    assert offline["badput_s"]["compile"] == pytest.approx(1.25)
    assert live["window"]["wall_s"] == pytest.approx(3.0)
    assert live["sources"] == 1


def test_goodput_compile_column_equals_an_observed_first_call(every_span):
    """End to end on the CPU: a program observed with ``observe_program``
    in a step window; the ledger's compile column is that first call's
    span."""
    from ray_tpu_torch.train.spmd import _sp_compute

    po.reset_for_tests()
    fn = po.observe_program(lambda m: m @ m, "gp.first_call")
    x = torch.ones(128, 128)
    for _ in range(3):
        t0 = fr.now()
        fn(x)
        _sp_compute.end(t0)
    events = fr.build_span_events([fr.snapshot_payload()])
    first = [e for e in events if e["name"] == "program.first_call"]
    assert len(first) == 1
    ledger = goodput.classify_badput(events)
    assert ledger["steps"] == 3
    assert ledger["badput_s"]["compile"] == pytest.approx(
        round(first[0]["dur"] / 1e6, 6), abs=1e-6)
    assert ledger["badput_s"]["compile"] > 0
    rec = po.get_program("gp.first_call")
    assert rec["compile_seconds"] == pytest.approx(
        first[0]["dur"] / 1e6, abs=1e-3)


# --------------------------------------------------------------------------- #
# The fold against the JAX package's xla_report
# --------------------------------------------------------------------------- #

_RENAME = {
    "ray_tpu_xla_compiles_total": "port_program_compiles_total",
    "ray_tpu_xla_recompiles_total": "port_program_recompiles_total",
    "ray_tpu_xla_compile_seconds_total": "port_program_compile_seconds_total",
    "ray_tpu_xla_program_flops": "port_program_flops",
    "ray_tpu_xla_program_bytes_accessed": "port_program_bytes_accessed",
    "ray_tpu_xla_program_peak_bytes": "port_program_peak_bytes",
    "ray_tpu_xla_program_variants": "port_program_variants",
    "ray_tpu_xla_shape_churn": "port_program_shape_churn",
}
_COUNTERS = {"ray_tpu_xla_compiles_total", "ray_tpu_xla_recompiles_total",
             "ray_tpu_xla_compile_seconds_total"}


def _worker_snapshot(prog, values):
    """A worker's registry snapshot carrying one program's series."""
    snap = {}
    for name, val in values.items():
        tags = (("program", prog),)
        if name == "ray_tpu_xla_shape_churn":
            for frm, to in val:
                snap.setdefault(name, {"type": "gauge", "help": "",
                                       "buckets": None, "values": {}})
                snap[name]["values"][(("from", frm), ("program", prog),
                                      ("to", to))] = 1.0
            continue
        snap[name] = {"type": "counter" if name in _COUNTERS else "gauge",
                      "help": "", "buckets": None, "values": {tags: val}}
    return snap


def _renamed(snap):
    return {_RENAME[k]: v for k, v in snap.items()}


def test_fold_matches_the_jax_xla_report(every_span):
    from ray_tpu.core.config import global_config as jax_config
    from ray_tpu.util import flight_recorder as jfr
    from ray_tpu.util import metrics as jm
    from ray_tpu.util import xla_observatory as xo

    tag = f"{time.monotonic_ns()}"
    train, decode, plain = ("spmd.train_step", "llama.decode",
                            f"fold.plain.{tag}")
    # two workers: counters add, gauges take the max
    w1 = {train: {"ray_tpu_xla_compiles_total": 2.0,
                  "ray_tpu_xla_recompiles_total": 1.0,
                  "ray_tpu_xla_compile_seconds_total": 0.75,
                  "ray_tpu_xla_program_flops": 4.0e12,
                  "ray_tpu_xla_program_bytes_accessed": 2.0e10,
                  "ray_tpu_xla_program_peak_bytes": 3.0e9,
                  "ray_tpu_xla_program_variants": 2.0,
                  "ray_tpu_xla_shape_churn": [("f32[4,8]", "f32[4,16]")]},
          decode: {"ray_tpu_xla_compiles_total": 3.0,
                   "ray_tpu_xla_compile_seconds_total": 0.25,
                   "ray_tpu_xla_program_flops": 3.2e10,
                   "ray_tpu_xla_program_bytes_accessed": 1.6e10,
                   "ray_tpu_xla_program_variants": 3.0},
          plain: {"ray_tpu_xla_compiles_total": 1.0,
                  "ray_tpu_xla_program_flops": 1.0e6}}
    w2 = {train: {"ray_tpu_xla_compiles_total": 1.0,
                  "ray_tpu_xla_compile_seconds_total": 0.5,
                  "ray_tpu_xla_program_flops": 5.0e12,
                  "ray_tpu_xla_program_bytes_accessed": 1.0e10,
                  "ray_tpu_xla_program_variants": 1.0}}
    spans = [("spmd.compute", (), 10.0, 0.010, ()),
             ("spmd.compute", (), 10.1, 0.012, ()),
             ("spmd.compute", (), 10.2, 0.014, ()),
             ("serve.decode_step", ("deployment",), 11.0, 0.020, ("d",)),
             ("serve.decode_step", ("deployment",), 11.1, 0.030, ("d",))]
    head = types.SimpleNamespace(
        flight_spans={"w1": [_payload(spans, "w1")]}, nodes={},
        health_monitor=types.SimpleNamespace(
            recompile=types.SimpleNamespace(active={train: 3.0})))

    jfr.configure(enabled=True, min_span_us=0.0)
    jfr.reset_for_tests()
    xo.reset_for_tests()
    po.reset_for_tests()
    reports = {}
    for name, reg, cfg, rename, fold in (
            ("jax", jm.registry(), jax_config(), dict, xo.xla_report),
            ("port", registry(), global_config(), _renamed,
             lambda h: po.program_report(head=h))):
        for prog in (train, decode):  # earlier series of these names go
            _forget(reg, prog)
        for wid, worker in ((f"fold-{tag}-1", w1), (f"fold-{tag}-2", w2)):
            snap = {}
            for prog, values in worker.items():
                for metric, entry in _worker_snapshot(prog, values).items():
                    snap.setdefault(metric, dict(entry, values={}))
                    snap[metric]["values"].update(entry["values"])
            reg.merge(wid, rename(snap))
        saved = (cfg.xla_peak_flops, cfg.xla_peak_hbm_bytes)
        cfg.xla_peak_flops, cfg.xla_peak_hbm_bytes = 989e12, 3.35e12
        try:
            reports[name] = fold(head)
        finally:
            cfg.xla_peak_flops, cfg.xla_peak_hbm_bytes = saved
    jax_rep, port_rep = reports["jax"], reports["port"]
    for prog in (train, decode, plain):
        assert port_rep["programs"][prog] == jax_rep["programs"][prog], prog
    row = port_rep["programs"][train]
    assert row["compiles"] == 3.0 and row["flops"] == 5.0e12
    assert row["measured_steps"] == 3
    assert row["mfu"] == pytest.approx(5.0e12 / 0.012 / 989e12, rel=1e-4)
    assert port_rep["programs"][decode]["measured_steps"] == 2
    assert port_rep["storms"] == jax_rep["storms"] == [train]
    for prog in (train, decode):
        _forget(jm.registry(), prog)
        _forget(registry(), prog)
    for key in ("peak_flops_per_chip", "peak_hbm_bytes_per_sec",
                "ridge_intensity"):
        assert port_rep[key] == jax_rep[key]
    text = po.format_programs(port_rep)
    assert "ACTIVE RECOMPILE STORMS: spmd.train_step" in text
    assert "measured: 3 x spmd.compute spans" in text
    jfr.reset_for_tests()


# --------------------------------------------------------------------------- #
# Across processes: a worker's program through GET /api/xla, and a storm
# --------------------------------------------------------------------------- #


@pytest.fixture
def fast_reports(every_span):
    cfg = global_config()
    saved = (cfg.metrics_report_interval_ms,
             cfg.flight_recorder_report_interval_ms,
             cfg.flight_recorder_min_span_us)
    cfg.metrics_report_interval_ms = 300
    cfg.flight_recorder_report_interval_ms = 300
    cfg.flight_recorder_min_span_us = 0.0
    yield cfg
    (cfg.metrics_report_interval_ms,
     cfg.flight_recorder_report_interval_ms,
     cfg.flight_recorder_min_span_us) = saved


@rt.remote
class _ObservedStep:
    def run(self, steps: int):
        import torch as _torch

        from ray_tpu_torch.train.spmd import _sp_compute
        from ray_tpu_torch.util import flight_recorder as _fr
        from ray_tpu_torch.util import program_observatory as _po

        fn = _po.observe_program(lambda m: m @ m, "spmd.train_step")
        # 33.5 MFLOP a call: an MFU that survives rounding to 6 places
        # however slowly a loaded host runs it
        x = _torch.ones(256, 256)
        for _ in range(steps):
            t0 = _fr.now()
            fn(x)
            _sp_compute.end(t0)
        return _po.program_report()["programs"]["spmd.train_step"]


def _get_json(url):
    with urllib.request.urlopen(url, timeout=T) as r:
        assert r.status == 200
        return json.loads(r.read().decode())


def test_api_xla_folds_a_workers_program(fast_reports):
    from ray_tpu_torch.dashboard import start_dashboard

    _forget_local("spmd.train_step")
    po.reset_for_tests()
    rt.init(num_cpus=2, num_gpus=0)
    dash = None
    try:
        local = rt.get(_ObservedStep.remote().run.remote(4), timeout=T)
        dash = start_dashboard(port=0, with_jobs=False)
        base = f"http://127.0.0.1:{dash.address[1]}"
        deadline = time.monotonic() + T
        row = {}
        while time.monotonic() < deadline:
            row = _get_json(base + "/api/xla")["programs"].get(
                "spmd.train_step", {})
            if row.get("measured_steps") == 4 and row.get("flops"):
                break
            time.sleep(0.2)
        for key in ("flops", "bytes_accessed", "variants", "compiles",
                    "peak_bytes"):
            assert row.get(key) == local[key], (key, row, local)
        assert row["measured_steps"] == 4
        assert row["measured_span"] == "spmd.compute"
        assert 0 < row["mfu"] < 1
        assert row["verdict_enforced"] is False   # CPU: trend-only

        # the CLI renders the same fold
        from ray_tpu_torch.__main__ import _cmd_xla

        assert _cmd_xla(argparse.Namespace(
            address=base, json=False, program="spmd.train_step")) == 0
        # the goodput ledger sees the worker's first call as compile
        gp = _get_json(base + "/api/goodput")
        assert gp["steps"] == 4 and gp["badput_s"]["compile"] > 0
    finally:
        if dash is not None:
            dash.stop()
        rt.shutdown()
        _forget_local("spmd.train_step")


def test_shape_churn_storm_visible_in_events_and_api(capsys):
    from ray_tpu_torch.core.runtime import get_current_runtime
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.util import state

    rt.init(num_cpus=1, num_gpus=0)
    dash = None
    try:
        head = get_current_runtime().head
        deadline = time.monotonic() + 30
        while head.health_monitor is None:
            assert time.monotonic() < deadline, "health monitor never started"
            time.sleep(0.05)
        monitor = head.health_monitor

        fn = po.observe_program(lambda x: x * 2, "torch.e2e.churny")
        sizes = itertools.count(4)
        for _ in range(6):
            for _ in range(4):
                fn(torch.zeros(next(sizes)))
            monitor.tick()
            if "torch.e2e.churny" in monitor.recompile.active:
                break
        assert "torch.e2e.churny" in monitor.recompile.active

        rows = state.list_cluster_events(severity="WARNING")
        storm = next(r for r in rows
                     if "recompile storm" in r["message"]
                     and r.get("entity_id") == "torch.e2e.churny")
        assert "torch.e2e.churny recompiled" in storm["message"]
        assert "f32[" in storm["message"] and " -> " in storm["message"]
        assert storm["attrs"]["recompiles"] >= 3

        dash = start_dashboard(port=0, with_jobs=False)
        base = f"http://127.0.0.1:{dash.address[1]}"
        api = _get_json(f"{base}/api/xla")
        row = api["programs"]["torch.e2e.churny"]
        assert row["recompiles"] >= 3
        assert row["compiles"] >= 4
        assert row["compile_seconds"] > 0
        assert row["churn"]
        assert "torch.e2e.churny" in api["storms"]

        from ray_tpu_torch.__main__ import _cmd_xla

        assert _cmd_xla(argparse.Namespace(
            address=base, json=False, program="torch.e2e.churny")) == 0
        assert _cmd_xla(argparse.Namespace(
            address=base, json=False, program="no.such.program")) == 1
        assert _cmd_xla(argparse.Namespace(
            address=base, json=False, program=None)) == 0
        assert "ACTIVE RECOMPILE STORMS" in capsys.readouterr().out
    finally:
        if dash is not None:
            dash.stop()
        rt.shutdown()

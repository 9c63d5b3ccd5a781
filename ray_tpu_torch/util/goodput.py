"""Goodput observatory: fold the span + event planes into a badput ledger.

Hyperscale training fleets report *goodput* — the fraction of wall
clock spent making forward progress — and attribute the complement
(*badput*) to named causes: ingest stalls, compiles, checkpoint
barriers, recovery gaps after faults, pipeline bubbles (the accounting
arXiv:2605.25645 does by hand for its TPU-vs-GPU comparison). This
module computes that ledger automatically from telemetry the runtime
already records: flight-recorder spans (``spmd.*``/``pipe.*``/
``ckpt.*``), and the death/rejoin cluster events.

``classify_badput`` is a pure, deterministic function over a merged
Chrome-trace event list (``flight_recorder.build_span_events``) plus
cluster-event rows — unit-testable on synthetic spans.
``goodput_report`` is the head-side assembly behind ``python -m
ray_tpu goodput`` and ``GET /api/goodput``; it also publishes the
ledger as registry gauges so the metrics plane, the CLI, and the API
all agree. The *watchers* over this ledger (straggler / regression /
time-to-recovered-throughput detectors) live in ``train/health.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ray_tpu_torch.util.metrics import Gauge

__all__ = [
    "BADPUT_CATEGORIES",
    "LedgerAccumulator",
    "classify_badput",
    "format_goodput",
    "goodput_report",
    "publish_ledger",
    "recovery_intervals",
]

# wall-clock decomposition buckets; "idle" is the unattributed residual
BADPUT_CATEGORIES = ("ingest", "compile", "checkpoint", "recovery",
                     "bubble", "idle")

_g_goodput = Gauge("port_goodput_fraction",
                   "Productive fraction of the observed train window")
_g_badput = Gauge("port_badput_seconds",
                  "Badput wall seconds by category over the observed "
                  "train window", tag_keys=("category",))

# span families that define the train window and the ledger columns
_PRODUCTIVE = ("spmd.compute",)
_INGEST = ("spmd.ingest_wait",)
_COMPILE = ("spmd.compile",)
_CKPT = ("ckpt.save", "ckpt.restore")
_PIPE_BUSY = ("pipe.fwd", "pipe.bwd", "pipe.loss_bwd")
_WINDOW_SPANS = (_PRODUCTIVE + _INGEST + _COMPILE + _CKPT +
                 ("pipe.step",) + _PIPE_BUSY)
# the program observatory's span for one analysed first call
# (util/program_observatory.py): the compile column's back-fill
_FIRST_CALL = "program.first_call"


def recovery_intervals(cluster_events: Iterable[dict],
                       end_ts: Optional[float] = None
                       ) -> List[Tuple[float, float, str]]:
    """(start_ts, end_ts, entity) wall-clock gaps between a node-death
    WARNING and the matching rejoin INFO (or ``end_ts``/the death ts
    when the node never came back). Overlaps are NOT merged here —
    callers that sum must merge (``classify_badput`` does)."""
    deaths: Dict[str, float] = {}  # entity -> death ts, still open
    out: List[Tuple[float, float, str]] = []
    for ev in sorted(cluster_events, key=lambda e: e.get("ts", 0.0)):
        if ev.get("source") != "NODE":
            continue
        msg = ev.get("message", "")
        entity = ev.get("entity_id", "")
        if ev.get("severity") == "WARNING" and "dead" in msg:
            deaths.setdefault(entity, ev.get("ts", 0.0))
        elif "alive" in msg and entity in deaths:
            out.append((deaths.pop(entity), ev.get("ts", 0.0), entity))
    for entity, t0 in deaths.items():
        out.append((t0, max(end_ts, t0) if end_ts is not None else t0,
                    entity))
    return out


def _merged_total(intervals: List[Tuple[float, float]],
                  lo: float, hi: float) -> float:
    """Total seconds covered by the union of intervals, clipped to
    [lo, hi] — overlapping recovery gaps must not double-count."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            total += (cur_b - cur_a) if cur_b is not None else 0.0
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def classify_badput(events: Sequence[Dict[str, Any]],
                    cluster_events: Iterable[dict] = ()) -> Dict[str, Any]:
    """Fold merged span events + cluster events into the badput ledger.

    The window is the extent of train-plane spans (wall-clock µs in
    Chrome-trace ``ts``). Per-process span families (spmd compute /
    ingest / compile, checkpoint I/O) are averaged across the sources
    that recorded them, so an N-host gang's per-host seconds read as
    per-run wall seconds; pipeline busy normalizes by stage count the
    same way ``pipeline_stats()`` does. The residual nothing explains
    is "idle".
    """
    spans = [ev for ev in events
             if ev.get("ph") == "X" and ev.get("cat") == "span"
             and ev.get("name") in _WINDOW_SPANS]
    if not spans:
        return {"window": {"start_ts": None, "end_ts": None,
                           "wall_s": 0.0},
                "steps": 0, "sources": 0, "goodput_s": 0.0,
                "goodput_fraction": None,
                "badput_s": {c: 0.0 for c in BADPUT_CATEGORIES}}
    t_lo = min(ev["ts"] for ev in spans)
    t_hi = max(ev["ts"] + ev.get("dur", 0.0) for ev in spans)
    wall_s = max((t_hi - t_lo) / 1e6, 1e-9)

    def per_source(names, pool=spans) -> Dict[str, float]:
        per: Dict[str, float] = {}
        for ev in pool:
            if ev["name"] in names:
                src = str((ev.get("args") or {}).get("source", ev.get("pid")))
                per[src] = per.get(src, 0.0) + ev.get("dur", 0.0) / 1e6
        return per

    def per_source_mean(names) -> float:
        # sum per recording process, then average across processes:
        # N hosts each stalling 2s is a 2s column, not 2N
        per = per_source(names)
        return sum(per.values()) / len(per) if per else 0.0

    compute_s = per_source_mean(_PRODUCTIVE)
    ingest_s = per_source_mean(_INGEST)
    ckpt_s = per_source_mean(_CKPT)
    # compile column: spmd.compile is the train-step compile wall; the
    # program observatory's per-program first-call spans back-fill
    # sources that never hit the spmd seam (serve decode). A source with
    # spmd.compile keeps that number — its first-call spans are the same
    # wall time seen program-by-program, not additional badput. First
    # calls do NOT define the window (serve-only clusters would
    # otherwise grow a fake "train window" out of compile spans alone).
    first_pool = [ev for ev in events
                  if ev.get("ph") == "X" and ev.get("cat") == "span"
                  and ev.get("name") == _FIRST_CALL]
    compile_per = per_source((_FIRST_CALL,), pool=first_pool)
    compile_per.update(per_source(_COMPILE))
    compile_s = (sum(compile_per.values()) / len(compile_per)
                 if compile_per else 0.0)

    # pipeline plane: productive = busy averaged over stages; bubble is
    # the stepped wall the stages spent idle (same K-normalized
    # accounting as pipeline_stats/attribute_trace)
    step_spans = [ev for ev in spans if ev["name"] == "pipe.step"]
    step_wall_s = sum(ev.get("dur", 0.0) for ev in step_spans) / 1e6
    stages = {str((ev.get("args") or {}).get("stage", "?"))
              for ev in spans if ev["name"] in _PIPE_BUSY}
    k = len(stages) or 1
    busy_s = sum(ev.get("dur", 0.0) for ev in spans
                 if ev["name"] in _PIPE_BUSY) / 1e6
    pipe_productive_s = busy_s / k
    bubble_s = max(step_wall_s - pipe_productive_s, 0.0) \
        if step_spans else 0.0

    recov = recovery_intervals(cluster_events, end_ts=t_hi / 1e6)
    recovery_s = _merged_total([(a, b) for a, b, _ in recov],
                               t_lo / 1e6, t_hi / 1e6)

    goodput_s = compute_s + pipe_productive_s
    explained = (goodput_s + ingest_s + compile_s + ckpt_s +
                 recovery_s + bubble_s)
    idle_s = max(wall_s - explained, 0.0)
    steps = len([ev for ev in spans if ev["name"] == "spmd.compute"]) \
        + len(step_spans)
    sources = {str((ev.get("args") or {}).get("source", ev.get("pid")))
               for ev in spans}
    return {
        "window": {"start_ts": round(t_lo / 1e6, 6),
                   "end_ts": round(t_hi / 1e6, 6),
                   "wall_s": round(wall_s, 6)},
        "steps": steps,
        "sources": len(sources),
        "goodput_s": round(goodput_s, 6),
        "goodput_fraction": round(min(goodput_s / wall_s, 1.0), 4),
        "badput_s": {
            "ingest": round(ingest_s, 6),
            "compile": round(compile_s, 6),
            "checkpoint": round(ckpt_s, 6),
            "recovery": round(recovery_s, 6),
            "bubble": round(bubble_s, 6),
            "idle": round(idle_s, 6),
        },
        "recovery_gaps": [
            {"start_ts": round(a, 6), "end_ts": round(b, 6),
             "entity": e[:8], "gap_s": round(b - a, 6)}
            for a, b, e in recov],
    }


# span family -> ledger column, for the incremental fold
_FAMILY: Dict[str, str] = {}
for _n in _PRODUCTIVE:
    _FAMILY[_n] = "compute"
for _n in _INGEST:
    _FAMILY[_n] = "ingest"
for _n in _COMPILE:
    _FAMILY[_n] = "compile"
for _n in _CKPT:
    _FAMILY[_n] = "checkpoint"


class LedgerAccumulator:
    """Incremental :func:`classify_badput`: running per-source family
    sums behind per-source seq cursors.

    A full refold is O(every retained span) — fine on demand, hostile
    inside a periodic monitor tick (a capacity ring is ~65k spans of
    pure-Python, GIL-holding folding). The accumulator folds each span
    record exactly once: ``fold`` pulls only records past the cursors
    (``cluster_span_payloads(head, since=...)``), updates the running
    sums, and returns the NEW spans as Chrome-trace events (the
    straggler detector's per-tick input); ``ledger`` assembles the same
    dict shape as :func:`classify_badput` from the running state plus
    the current cluster events. Window time is rebuilt per call, so
    recovery/idle stay consistent with the accumulated span extent.
    """

    def __init__(self) -> None:
        self._cursors: Dict[str, int] = {}   # source -> max seq folded
        self._fam: Dict[str, Dict[str, float]] = {}  # src -> column -> s
        self._busy_s = 0.0
        self._step_wall_s = 0.0
        self._stages: set = set()
        self._steps = 0        # spmd.compute spans folded
        self._pipe_steps = 0   # pipe.step spans folded
        self._sources: set = set()
        # first-call seconds per source — compile-column back-fill for
        # sources with no spmd.compile (see classify_badput)
        self._first_calls: Dict[str, float] = {}
        self._t_lo: Optional[float] = None   # wall seconds
        self._t_hi: Optional[float] = None

    def fold(self, head) -> List[Dict[str, Any]]:
        """Fold records not yet seen; returns them as span events."""
        from ray_tpu_torch.util import flight_recorder as _fr

        payloads = _fr.cluster_span_payloads(head, since=self._cursors)
        for p in payloads:
            evs = p.get("events") or []
            if evs:
                src = str(p.get("source"))
                self._cursors[src] = max(self._cursors.get(src, -1),
                                         evs[-1][0])
        events = _fr.build_span_events(payloads)
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") != "span":
                continue
            name = ev.get("name")
            if name == _FIRST_CALL:
                # tracked for the compile column, but never widens the
                # train window or the source census
                args = ev.get("args") or {}
                src = str(args.get("source", ev.get("pid")))
                self._first_calls[src] = (self._first_calls.get(src, 0.0)
                                          + ev.get("dur", 0.0) / 1e6)
                continue
            if name not in _WINDOW_SPANS:
                continue
            ts = ev["ts"] / 1e6
            dur = ev.get("dur", 0.0) / 1e6
            self._t_lo = ts if self._t_lo is None else min(self._t_lo, ts)
            self._t_hi = ts + dur if self._t_hi is None \
                else max(self._t_hi, ts + dur)
            args = ev.get("args") or {}
            src = str(args.get("source", ev.get("pid")))
            self._sources.add(src)
            fam = _FAMILY.get(name)
            if fam is not None:
                d = self._fam.setdefault(src, {})
                d[fam] = d.get(fam, 0.0) + dur
            if name == "spmd.compute":
                self._steps += 1
            elif name == "pipe.step":
                self._pipe_steps += 1
                self._step_wall_s += dur
            elif name in _PIPE_BUSY:
                self._busy_s += dur
                self._stages.add(str(args.get("stage", "?")))
        return events

    def ledger(self, cluster_events: Iterable[dict] = ()) -> Dict[str, Any]:
        """The accumulated ledger, same shape as ``classify_badput``."""
        if self._t_lo is None or self._t_hi is None:
            return {"window": {"start_ts": None, "end_ts": None,
                               "wall_s": 0.0},
                    "steps": 0, "sources": 0, "goodput_s": 0.0,
                    "goodput_fraction": None,
                    "badput_s": {c: 0.0 for c in BADPUT_CATEGORIES}}
        t_lo, t_hi = self._t_lo, self._t_hi
        wall_s = max(t_hi - t_lo, 1e-9)

        def fam_mean(col: str) -> float:
            per = [d[col] for d in self._fam.values() if col in d]
            return sum(per) / len(per) if per else 0.0

        compute_s = fam_mean("compute")
        ingest_s = fam_mean("ingest")
        ckpt_s = fam_mean("checkpoint")
        # spmd.compile wins per source; first calls back-fill the rest
        compile_per = dict(self._first_calls)
        for src, d in self._fam.items():
            if "compile" in d:
                compile_per[src] = d["compile"]
        compile_s = (sum(compile_per.values()) / len(compile_per)
                     if compile_per else 0.0)
        k = len(self._stages) or 1
        pipe_productive_s = self._busy_s / k
        bubble_s = max(self._step_wall_s - pipe_productive_s, 0.0) \
            if self._pipe_steps else 0.0
        recov = recovery_intervals(cluster_events, end_ts=t_hi)
        recovery_s = _merged_total([(a, b) for a, b, _ in recov],
                                   t_lo, t_hi)
        goodput_s = compute_s + pipe_productive_s
        explained = (goodput_s + ingest_s + compile_s + ckpt_s +
                     recovery_s + bubble_s)
        idle_s = max(wall_s - explained, 0.0)
        return {
            "window": {"start_ts": round(t_lo, 6),
                       "end_ts": round(t_hi, 6),
                       "wall_s": round(wall_s, 6)},
            "steps": self._steps + self._pipe_steps,
            "sources": len(self._sources),
            "goodput_s": round(goodput_s, 6),
            "goodput_fraction": round(min(goodput_s / wall_s, 1.0), 4),
            "badput_s": {
                "ingest": round(ingest_s, 6),
                "compile": round(compile_s, 6),
                "checkpoint": round(ckpt_s, 6),
                "recovery": round(recovery_s, 6),
                "bubble": round(bubble_s, 6),
                "idle": round(idle_s, 6),
            },
            "recovery_gaps": [
                {"start_ts": round(a, 6), "end_ts": round(b, 6),
                 "entity": e[:8], "gap_s": round(b - a, 6)}
                for a, b, e in recov],
        }


def publish_ledger(ledger: Dict[str, Any]) -> None:
    """Mirror a ledger onto registry gauges so the metrics plane agrees
    with the CLI and ``/api/goodput`` (and the history rings get a
    goodput time series for free)."""
    frac = ledger.get("goodput_fraction")
    if frac is not None:
        _g_goodput.set(float(frac))
    for cat in BADPUT_CATEGORIES:
        _g_badput.set(float(ledger.get("badput_s", {}).get(cat, 0.0)),
                      tags={"category": cat})


def goodput_report(head) -> Dict[str, Any]:
    """Assemble the full goodput report for one head: ledger over the
    merged clock-aligned span plane + health-detector state (straggler /
    regression / TTRT) when the monitor is running."""
    from ray_tpu_torch.util import flight_recorder as _fr

    events = _fr.build_span_events(_fr.cluster_span_payloads(head))
    try:
        rows = head.state_list("cluster_events", 10_000)
    except Exception:
        rows = []
    ledger = classify_badput(events, rows)
    publish_ledger(ledger)
    monitor = getattr(head, "health_monitor", None)
    if monitor is not None:
        ledger["health"] = monitor.summary()
    return ledger


def format_goodput(ledger: Dict[str, Any]) -> str:
    """Human-readable ``python -m ray_tpu goodput`` rendering."""
    win = ledger.get("window", {})
    lines = ["is my run healthy", "-" * 26]
    if not win.get("wall_s"):
        lines.append("no train-plane spans observed (run a train loop "
                     "with the flight recorder on)")
        return "\n".join(lines)
    wall = win["wall_s"]
    frac = ledger.get("goodput_fraction") or 0.0
    lines.append(f"window             : {wall:.3f}s wall, "
                 f"{ledger.get('steps', 0)} steps, "
                 f"{ledger.get('sources', 0)} process(es)")
    lines.append(f"goodput            : {frac:.2%} "
                 f"({ledger.get('goodput_s', 0.0):.3f}s productive)")
    lines.append("badput:")
    for cat in BADPUT_CATEGORIES:
        s = ledger.get("badput_s", {}).get(cat, 0.0)
        if s:
            lines.append(f"  {cat:<17}: {s:.3f}s ({s / wall:.2%})")
    for gap in ledger.get("recovery_gaps", ()):
        lines.append(f"  recovery gap     : node {gap['entity']} "
                     f"out {gap['gap_s']:.3f}s")
    health = ledger.get("health") or {}
    for rec in health.get("ttrt", ()):
        if rec.get("recovered_ts"):
            lines.append(
                f"ttrt               : node {rec['entity'][:8]} "
                f"throughput recovered in {rec['ttrt_s']:.3f}s "
                f"(baseline {rec['baseline']:.1f})")
        else:
            lines.append(f"ttrt               : node {rec['entity'][:8]} "
                         f"NOT yet recovered (baseline "
                         f"{rec['baseline']:.1f})")
    for s in health.get("stragglers", ()):
        lines.append(f"straggler          : {s}")
    for r in health.get("regressions", ()):
        lines.append(f"regression         : {r}")
    if not (health.get("stragglers") or health.get("regressions")):
        lines.append("stragglers         : none active")
        lines.append("regressions        : none active")
    return "\n".join(lines)

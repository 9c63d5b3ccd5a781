"""Application and runtime metrics: Counter/Gauge/Histogram over a
per-process registry, its snapshot, Prometheus text rendering and the
series fold.

Port of ``ray_tpu/util/metrics.py``, copied whole (it is stdlib only):
the same registry, record modes and folds, so one reader serves both
packages. The port registers its metrics under the ``port_`` prefix. Each
process keeps a local registry; a head that merges the registries of its
workers (``merge``, ``retire``, ``start_report_thread``) comes with the
runtime's port.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

_TagKey = Tuple[Tuple[str, str], ...]


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"type", "help", "values": {tag_key: float}, "buckets"?}
        self.metrics: Dict[str, dict] = {}
        self._dirty = False

    def record(self, name: str, mtype: str, help_: str, tags: _TagKey,
               value: float, mode: str = "set",
               buckets: Optional[List[float]] = None) -> None:
        with self._lock:
            m = self.metrics.setdefault(
                name, {"type": mtype, "help": help_, "values": {},
                       "buckets": buckets})
            if mode == "add":
                m["values"][tags] = m["values"].get(tags, 0.0) + value
            elif mode == "observe":  # histogram: per-bucket counts + sum
                counts = m["values"].setdefault(tags, _hist_zero(buckets))
                counts["sum"] += value
                counts["count"] += 1
                for b in buckets or ():
                    if value <= b:
                        counts["le"][b] += 1
            else:
                m["values"][tags] = value
            self._dirty = True

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            self._dirty = False
            out = {}
            for name, m in self.metrics.items():
                out[name] = {"type": m["type"], "help": m["help"],
                             "buckets": m["buckets"],
                             "values": {k: (dict(v, le=dict(v["le"]))
                                            if isinstance(v, dict) else v)
                                        for k, v in m["values"].items()}}
            return out

    def retire(self, source_id: str) -> None:
        """A source (worker) died: fold its cumulative metrics (counters,
        histograms) into a retired accumulator so sums stay monotonic if
        the node:pid source id is ever reused, and drop its gauges so
        /metrics stops exporting stale liveness values."""
        with self._lock:
            for m in self.metrics.values():
                sources = m.get("sources") or {}
                values = sources.pop(source_id, None)
                if values is None:
                    continue
                if m["type"] == "gauge":
                    continue  # dropped
                retired = sources.setdefault("_retired", {})
                for tags, v in values.items():
                    if m["type"] == "histogram":
                        acc = retired.setdefault(tags,
                                                 _hist_zero(m["buckets"]))
                        acc["sum"] += v["sum"]
                        acc["count"] += v["count"]
                        for b, c in (v.get("le") or {}).items():
                            acc["le"][b] = acc["le"].get(b, 0) + c
                    else:
                        retired[tags] = retired.get(tags, 0.0) + v

    def merge(self, source_id: str, snap: Dict[str, dict]) -> None:
        """Head-side: absorb a worker snapshot (keyed so re-reports
        overwrite rather than double-count)."""
        with self._lock:
            for name, m in snap.items():
                mine = self.metrics.setdefault(
                    name, {"type": m["type"], "help": m["help"],
                           "buckets": m.get("buckets"), "values": {},
                           "sources": {}})
                mine.setdefault("sources", {})[source_id] = m["values"]


def _hist_zero(buckets):
    return {"sum": 0.0, "count": 0, "le": {b: 0 for b in (buckets or ())}}


_registry = _Registry()


def registry() -> _Registry:
    return _registry


def _tags_key(tags: Optional[Dict[str, str]]) -> _TagKey:
    return tuple(sorted((tags or {}).items()))


def tags_key(tags: Optional[Dict[str, str]]) -> _TagKey:
    """Precompute a tag key for the ``tag_key=`` fast path: hot callers
    (the serve request path) build the sorted tuple once per tag set
    instead of once per record."""
    return _tags_key(tags)


class Counter:
    """Monotonic counter (reference: ray.util.metrics.Counter)."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        self._name = name
        self._desc = description

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None,
            tag_key: Optional[_TagKey] = None) -> None:
        _registry.record(self._name, "counter", self._desc,
                         tag_key if tag_key is not None
                         else _tags_key(tags), value, mode="add")


class Gauge:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        self._name = name
        self._desc = description

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None,
            tag_key: Optional[_TagKey] = None) -> None:
        _registry.record(self._name, "gauge", self._desc,
                         tag_key if tag_key is not None
                         else _tags_key(tags), value, mode="set")


class Histogram:
    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        self._name = name
        self._desc = description
        self._buckets = sorted(boundaries or
                               [0.001, 0.01, 0.1, 1, 10, 100])

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None,
                tag_key: Optional[_TagKey] = None) -> None:
        _registry.record(self._name, "histogram", self._desc,
                         tag_key if tag_key is not None
                         else _tags_key(tags), value, mode="observe",
                         buckets=self._buckets)

    def percentile(self, q: float,
                   tags: Optional[Dict[str, str]] = None,
                   reg: Optional[_Registry] = None) -> Optional[float]:
        """Estimate the q-quantile (0 < q <= 1) from the merged bucket
        counts for one tag set (all sources folded). None when the series
        has no observations."""
        agg = aggregate_histogram(self._name, reg)
        v = agg.get(_tags_key(tags))
        if v is None:
            return None
        return percentile_from_buckets(v["le"], v["count"], q)

    def summary(self, percentiles: Tuple[float, ...] = (0.5, 0.95, 0.99),
                reg: Optional[_Registry] = None) -> Dict[_TagKey, dict]:
        """Per-tag-set {count, sum, avg, p50, ...} over merged buckets
        (the serve.status() aggregation path)."""
        return histogram_summary(self._name, percentiles, reg)


# --------------------------------------------------------------------------- #
# Histogram aggregation: percentiles over bucket counts (head side)
# --------------------------------------------------------------------------- #


def aggregate_histogram(name: str,
                        reg: Optional[_Registry] = None
                        ) -> Dict[_TagKey, dict]:
    """One histogram's {tags: {"sum", "count", "le"}} with every source
    (local values, merged workers, the _retired accumulator) folded."""
    reg = reg or _registry
    with reg._lock:
        m = reg.metrics.get(name)
        if m is None or m["type"] != "histogram":
            return {}
        agg: Dict[_TagKey, dict] = {}

        def fold(tags: _TagKey, v: dict) -> None:
            acc = agg.setdefault(tags, _hist_zero(m["buckets"]))
            acc["sum"] += v.get("sum", 0.0)
            acc["count"] += v.get("count", 0)
            for b, c in (v.get("le") or {}).items():
                acc["le"][b] = acc["le"].get(b, 0) + c

        for tags, v in m["values"].items():
            fold(tags, v)
        for values in (m.get("sources") or {}).values():
            for tags, v in values.items():
                fold(tags, v)
        return agg


def percentile_from_buckets(le: Dict[float, int], count: int,
                            q: float) -> Optional[float]:
    """Prometheus-style histogram_quantile over cumulative bucket counts:
    linear interpolation inside the bucket the rank falls in, lower bound
    0 for the first bucket, and the highest finite bound when the rank
    lands in +Inf."""
    if count <= 0 or not le:
        return None
    q = min(max(q, 0.0), 1.0)
    rank = q * count
    prev_bound, prev_cum = 0.0, 0
    bounds = sorted(le)
    for b in bounds:
        cum = le[b]
        if cum >= rank:
            if cum == prev_cum:
                return float(b)
            return prev_bound + (float(b) - prev_bound) \
                * (rank - prev_cum) / (cum - prev_cum)
        prev_bound, prev_cum = float(b), cum
    return float(bounds[-1])  # rank falls in the +Inf bucket


def histogram_summary(name: str,
                      percentiles: Tuple[float, ...] = (0.5, 0.95, 0.99),
                      reg: Optional[_Registry] = None
                      ) -> Dict[_TagKey, dict]:
    """{tags: {"count", "sum", "avg", "p50", "p95", ...}} for one
    histogram, merged across sources (the serve.status() /
    /api/serve/latency aggregation helper)."""
    out: Dict[_TagKey, dict] = {}
    for tags, v in aggregate_histogram(name, reg).items():
        row = {"count": v["count"], "sum": v["sum"],
               "avg": (v["sum"] / v["count"]) if v["count"] else None}
        for q in percentiles:
            label = ("p%g" % (q * 100)).replace(".", "_")
            row[label] = percentile_from_buckets(v["le"], v["count"], q)
        out[tags] = row
    return out


# --------------------------------------------------------------------------- #
# Prometheus text rendering (head side)
# --------------------------------------------------------------------------- #


def _escape_label_value(v) -> str:
    """Prometheus exposition format: label values escape backslash, quote
    and newline (a raw quote would make the scrape unparseable)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """HELP text escapes backslash and newline."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_tags(tags: _TagKey, extra: Dict[str, str] = ()) -> str:
    items = list(tags) + list(dict(extra).items() if extra else [])
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + inner + "}"


def render_prometheus(reg: _Registry) -> str:
    """All sources merged into Prometheus exposition text."""
    lines: List[str] = []
    with reg._lock:
        for name, m in sorted(reg.metrics.items()):
            lines.append(f"# HELP {name} {_escape_help(m['help'])}")
            lines.append(f"# TYPE {name} {m['type']}")
            all_values: List[Tuple[str, _TagKey, object]] = []
            for tags, v in m["values"].items():
                all_values.append(("", tags, v))
            for src, values in (m.get("sources") or {}).items():
                for tags, v in values.items():
                    all_values.append((src, tags, v))
            if m["type"] == "histogram":
                for src, tags, v in all_values:
                    extra = {"source": src} if src else {}
                    cum = 0
                    for b in sorted((v.get("le") or {})):
                        cum = v["le"][b]
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_tags(tags, dict(extra, le=str(b)))}"
                            f" {cum}")
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_tags(tags, dict(extra, le='+Inf'))}"
                        f" {v['count']}")
                    lines.append(
                        f"{name}_sum{_fmt_tags(tags, extra)} {v['sum']}")
                    lines.append(
                        f"{name}_count{_fmt_tags(tags, extra)} {v['count']}")
            else:
                # same metric from several sources: sum counters, keep
                # per-source gauges
                if m["type"] == "counter":
                    agg: Dict[_TagKey, float] = {}
                    for _, tags, v in all_values:
                        agg[tags] = agg.get(tags, 0.0) + v
                    for tags, v in agg.items():
                        lines.append(f"{name}{_fmt_tags(tags)} {v}")
                else:
                    for src, tags, v in all_values:
                        extra = {"source": src} if src else {}
                        lines.append(f"{name}{_fmt_tags(tags, extra)} {v}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------- #
# Metrics history: bounded per-series time-series rings (head side)
# --------------------------------------------------------------------------- #


def aggregate_series(reg: _Registry) -> Dict[str, List[Tuple[_TagKey, float]]]:
    """Flatten the merged registry into scalar series, aggregated the same
    way the Prometheus rendering does: counters sum across sources,
    gauges stay per-source (with a ``source`` tag), histograms project to
    ``<name>_count`` and ``<name>_sum`` series."""
    out: Dict[str, List[Tuple[_TagKey, float]]] = {}
    with reg._lock:
        for name, m in reg.metrics.items():
            all_values: List[Tuple[str, _TagKey, object]] = []
            for tags, v in m["values"].items():
                all_values.append(("", tags, v))
            for src, values in (m.get("sources") or {}).items():
                for tags, v in values.items():
                    all_values.append((src, tags, v))
            if m["type"] == "histogram":
                counts: Dict[_TagKey, float] = {}
                sums: Dict[_TagKey, float] = {}
                for _src, tags, v in all_values:
                    counts[tags] = counts.get(tags, 0.0) + v["count"]
                    sums[tags] = sums.get(tags, 0.0) + v["sum"]
                out[name + "_count"] = list(counts.items())
                out[name + "_sum"] = list(sums.items())
            elif m["type"] == "counter":
                agg: Dict[_TagKey, float] = {}
                for _src, tags, v in all_values:
                    agg[tags] = agg.get(tags, 0.0) + v
                out[name] = list(agg.items())
            else:  # gauge
                series: Dict[_TagKey, float] = {}
                for src, tags, v in all_values:
                    key = tags + ((("source", src),) if src else ())
                    series[key] = v
                out[name] = list(series.items())
    return out


class MetricsHistory:
    """Bounded (ts, value) rings per metric series so rates and trends are
    queryable instead of only instantaneous snapshots (reference: the
    dashboard's Grafana time-series over the Prometheus scrape; here a
    self-contained ring served at ``/api/metrics/history``)."""

    def __init__(self, max_samples: int = 360):
        self.max_samples = max(2, int(max_samples))
        self._lock = threading.Lock()
        # metric name -> tag key -> deque[(ts, value)]
        self._series: Dict[str, Dict[_TagKey, "deque"]] = {}

    def sample(self, reg: Optional[_Registry] = None,
               now: Optional[float] = None) -> None:
        """Append one sample of every series in the merged registry."""
        flat = aggregate_series(reg or _registry)
        ts = time.time() if now is None else now
        with self._lock:
            for name, series in flat.items():
                by_tags = self._series.setdefault(name, {})
                for tags, value in series:
                    ring = by_tags.get(tags)
                    if ring is None:
                        ring = by_tags[tags] = deque(
                            maxlen=self.max_samples)
                    ring.append((ts, float(value)))

    def query(self, name: str) -> List[Dict]:
        """All series of one metric: [{"tags": {...}, "points": [[ts, v]]}]."""
        with self._lock:
            by_tags = self._series.get(name, {})
            return [{"tags": dict(tags), "points": [list(p) for p in ring]}
                    for tags, ring in by_tags.items()]

    def query_pattern(self, pattern: str) -> Dict[str, List[Dict]]:
        """Every series whose metric name matches ``pattern``, in one
        response: an exact name, a prefix (trailing ``*``), or a regex
        (fullmatch; a pattern that does not compile falls back to exact
        match). ``{name: [{"tags": ..., "points": ...}]}`` sorted by
        name — the multi-series form behind
        ``/api/metrics/history?name=port_program_*``."""
        import re

        with self._lock:
            names = sorted(self._series)
        if pattern.endswith("*") and not pattern.endswith(".*"):
            prefix = pattern[:-1]
            sel = [n for n in names if n.startswith(prefix)]
        else:
            try:
                rx = re.compile(pattern)
            except re.error:
                sel = [n for n in names if n == pattern]
            else:
                sel = [n for n in names if rx.fullmatch(n)]
        return {n: self.query(n) for n in sel}

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)


def start_report_thread(send_fn, interval_s: float) -> threading.Event:
    """Worker-side: periodically flush the local registry via send_fn.

    A transient send failure (node channel blip, head mid-restart) must not
    kill the report thread for the life of the worker: log the first
    failure, re-mark the registry dirty, and retry on the next interval.
    """
    import logging

    stop = threading.Event()
    log = logging.getLogger("ray_tpu_torch.metrics")

    def loop():
        warned = False
        while not stop.wait(interval_s):
            if not _registry._dirty:
                continue
            snap = _registry.snapshot()
            try:
                send_fn(snap)
                warned = False
            except Exception as e:  # noqa: BLE001
                # snapshot() cleared the dirty bit; restore it so the next
                # interval re-reports (values are cumulative, nothing lost)
                with _registry._lock:
                    _registry._dirty = True
                if not warned:
                    warned = True
                    log.warning("metrics report failed (will retry "
                                "next interval): %r", e)

    threading.Thread(target=loop, daemon=True,
                     name="metrics-report").start()
    return stop

"""Flight recorder: a per-process lock-free span ring (port of the
process-local half of ``ray_tpu/util/flight_recorder.py``).

Every process keeps ONE preallocated ring of fixed-size span records.
The hot path is two monotonic-clock reads and one tuple store:
``itertools.count().__next__`` is GIL-atomic, so concurrent emitters
never lock, and a slot store is a single list assignment; a torn read on
the drain side is detected by the seq stamped inside the record.
Instrumented seams in the port: the decode scheduler's
``serve.prefill`` / ``serve.decode_step`` (``serve/decode.py``), the
SPMD step phases (``train/spmd.py``) and the program observatory's
``program.first_call`` (``util/program_observatory.py``).

Timestamps are process-local ``time.monotonic()`` plus a per-process
``(anchor_mono, anchor_wall)`` pair captured at import, so any record
converts to wall time locally; :func:`build_span_events` turns payloads
into Chrome/Perfetto events.

Span names are REGISTERED, not free-form: :func:`register_span` is the
one registration site per name (one name, one tag set), which keeps the
trace vocabulary reviewable.

:func:`dump` writes the last N seconds of spans to
``<dump dir>/logs/flightrec/``. Gated by the ``RAY_TPU_FLIGHT_RECORDER``
config knob; spans shorter than ``flight_recorder_min_span_us`` (default
500 us) stop at the duration compare, so microsecond-rate callers pay
only the clock reads. The recorder adopts the ``flight_recorder*`` knobs
of ``core/config.py`` on first use.

Left out until the runtime is ported: the head-side collection
(``cluster_span_payloads``), the cross-host merge (``cluster_trace``,
with the clock-offset estimator) and ``attribute_trace``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "adopt_config",
    "build_span_events",
    "configure",
    "drain",
    "dump",
    "enabled",
    "now",
    "register_span",
    "set_dump_dir",
    "set_process_label",
    "snapshot_payload",
    "snapshot_payload_since",
    "next_seq",
]

# kinds stored in a record slot
KIND_SPAN = 0
KIND_INSTANT = 1

# per-process wall anchors: monotonic is the recording clock (immune to
# wall steps); the pair converts any record to wall time at export
_ANCHOR_MONO = time.monotonic()
_ANCHOR_WALL = time.time()

_DEF_LOCK = threading.Lock()
_DEFS: Dict[str, "Span"] = {}

# the ring: preallocated slots, GIL-atomic seq allocation. _hi is a
# store-only high-water mark (reading itertools.count would consume).
_DEFAULT_CAPACITY = 65536
_capacity = _DEFAULT_CAPACITY
_mask = _capacity - 1
_slots: List[Optional[tuple]] = [None] * _capacity
_seq = itertools.count()
_hi = [-1]
_drained = [0]
_on = [None]  # None = resolve lazily from config/env on first use
_proc_label = [f"pid{os.getpid()}"]
_dump_dir: List[Optional[str]] = [None]
_dump_window_s = [10.0]
# duration floor (seconds): sub-floor spans cost only the clock reads.
# Stall COUNTERS (channel.STALLS) still see every wait; instants are
# exempt (parks already imply a ms-scale spin elapsed).
_min_dur = [500e-6]


def _resolve_enabled() -> bool:
    """Lazy gate: the recorder adopts the global Config's knobs (on or
    off, ring capacity, dump window, duration floor) on first use, not
    at import, so a process may set its ``RAY_TPU_FLIGHT_RECORDER*``
    environment overrides after importing the port (Config.__post_init__
    applies RAY_TPU_* per field). :func:`configure` adopts first too, so
    an explicit setting overrides the config's, never the reverse."""
    if _on[0] is None:
        # on while adopting: adopt_config's configure() must not recurse
        _on[0] = True
        try:
            from ray_tpu_torch.core.config import global_config

            adopt_config(global_config())
        except Exception:  # noqa: BLE001 — the recorder stays on
            pass
    return _on[0]


def enabled() -> bool:
    on = _on[0]
    return _resolve_enabled() if on is None else on


def configure(enabled: Optional[bool] = None,
              capacity: Optional[int] = None,
              dump_window_s: Optional[float] = None,
              min_span_us: Optional[float] = None) -> None:
    """Runtime (re)configuration — also the adoption hook when a daemon
    or worker receives the cluster Config. Changing capacity rebuilds
    the ring (drops unread records; callers do this at startup)."""
    global _capacity, _mask, _slots
    _resolve_enabled()
    if enabled is not None:
        _on[0] = bool(enabled)
    if dump_window_s is not None:
        _dump_window_s[0] = float(dump_window_s)
    if min_span_us is not None:
        _min_dur[0] = float(min_span_us) / 1e6
    if capacity is not None and capacity != _capacity:
        cap = 1
        while cap < max(1024, int(capacity)):
            cap <<= 1
        with _DEF_LOCK:
            _capacity = cap
            _mask = cap - 1
            _slots = [None] * cap
            _drained[0] = max(0, _hi[0] + 1)


def adopt_config(cfg) -> None:
    """Apply the relevant knobs of a (possibly remote) Config."""
    try:
        configure(enabled=bool(cfg.flight_recorder),
                  capacity=int(cfg.flight_recorder_events),
                  dump_window_s=float(cfg.flight_recorder_dump_window_s),
                  min_span_us=float(cfg.flight_recorder_min_span_us))
    except Exception:
        pass


def set_process_label(label: str) -> None:
    _proc_label[0] = str(label)


def set_dump_dir(session_dir: Optional[str]) -> None:
    """Arm crash dumps: faults write to <session_dir>/logs/flightrec/."""
    if session_dir:
        _dump_dir[0] = os.path.join(session_dir, "logs", "flightrec")


# bound once: skips the module-attribute lookup on every hot-path call
_mono = time.monotonic


def now(_mono=_mono) -> float:
    """Span start stamp; 0.0 when the recorder is off so a disabled
    begin/end pair costs one flag test per side."""
    on = _on[0]
    if on is None:
        on = _resolve_enabled()
    return _mono() if on else 0.0


def _record(sid: int, kind: int, t0: float, dur: float,
            tags: tuple) -> None:
    i = next(_seq)
    _slots[i & _mask] = (i, sid, kind, t0, dur, tags)
    _hi[0] = i


class Span:
    """One registered span name. ``end(t0, *tags)`` records a duration
    span closed now; ``end_at`` takes a caller-measured duration (the
    ring-wait paths time their stall anyway for the stall counters);
    ``instant`` records a point event."""

    __slots__ = ("name", "tag_keys", "sid")

    def __init__(self, name: str, tag_keys: Tuple[str, ...], sid: int):
        self.name = name
        self.tag_keys = tag_keys
        self.sid = sid

    def end(self, t0: float, *tags, _mono=_mono) -> None:
        # _record() inlined and the clock bound as a default: this and
        # end_at are THE hot path against the <=3% bench-gated budget.
        # Sub-floor spans stop at the duration compare: at microsecond
        # dispatch rates the clock reads are all the recorder may cost.
        if t0 and _on[0]:
            dur = _mono() - t0
            if dur >= _min_dur[0]:
                i = next(_seq)
                _slots[i & _mask] = (i, self.sid, KIND_SPAN, t0, dur,
                                     tags)
                _hi[0] = i

    def end_at(self, t0: float, dur: float, *tags) -> None:
        on = _on[0]
        if on is None:
            on = _resolve_enabled()
        if on and dur >= _min_dur[0]:
            i = next(_seq)
            _slots[i & _mask] = (i, self.sid, KIND_SPAN, t0, dur, tags)
            _hi[0] = i

    def instant(self, *tags) -> None:
        on = _on[0]
        if on is None:
            on = _resolve_enabled()
        if on:
            _record(self.sid, KIND_INSTANT, time.monotonic(), 0.0, tags)


def _sid_for(name: str) -> int:
    """Stable span id derived from the NAME, identical in every
    process. Registration order must not matter: actor classes can be
    cloudpickled by value, shipping the defining module's Span objects
    inside method globals — an order-based sid minted in the driver
    would collide with a different name in the executing worker's
    table. crc32 of the name is order-free; :func:`register_span`
    rejects the (vanishingly unlikely) cross-name collision."""
    return zlib.crc32(name.encode())


def register_span(name: str, tag_keys: Tuple[str, ...] = ()) -> Span:
    """Register one span name with its (fixed) tag key set. Idempotent
    for an identical re-registration (module reload); a conflicting tag
    set raises — one name, one tag set, registered once."""
    tag_keys = tuple(tag_keys)
    with _DEF_LOCK:
        have = _DEFS.get(name)
        if have is not None:
            if have.tag_keys != tag_keys:
                raise ValueError(
                    f"span {name!r} already registered with tag_keys="
                    f"{have.tag_keys!r} (got {tag_keys!r})")
            return have
        sid = _sid_for(name)
        for sp in _DEFS.values():
            if sp.sid == sid:
                raise ValueError(
                    f"span id collision: {name!r} vs {sp.name!r}")
        sp = Span(name, tag_keys, sid)
        _DEFS[name] = sp
        return sp


# --------------------------------------------------------------------------- #
# Drain / snapshot / payloads
# --------------------------------------------------------------------------- #


def _collect(lo: int, hi: int) -> List[tuple]:
    out = []
    for i in range(max(lo, hi - _mask), hi + 1):
        rec = _slots[i & _mask]
        if rec is not None and rec[0] == i:  # torn/overwritten guard
            out.append(rec)
    return out


def _names_table() -> Dict[int, dict]:
    with _DEF_LOCK:
        return {sp.sid: {"name": sp.name, "tag_keys": list(sp.tag_keys)}
                for sp in _DEFS.values()}


def _payload(events: List[tuple]) -> dict:
    return {
        "pid": os.getpid(),
        "proc": _proc_label[0],
        "anchor_mono": _ANCHOR_MONO,
        "anchor_wall": _ANCHOR_WALL,
        "names": _names_table(),
        "events": [list(r) for r in events],
    }


def drain() -> Optional[dict]:
    """Consume records since the last drain (the worker/daemon report
    path). None when nothing new."""
    hi = _hi[0]
    if hi < _drained[0]:
        return None
    events = _collect(_drained[0], hi)
    _drained[0] = hi + 1
    if not events:
        return None
    return _payload(events)


def snapshot_payload(window_s: Optional[float] = None) -> dict:
    """Non-consuming view of everything still in the ring (the export
    path for the local process); optionally clipped to the last
    ``window_s`` seconds."""
    events = _collect(0, _hi[0])
    if window_s is not None:
        cutoff = time.monotonic() - window_s
        events = [r for r in events if r[3] + r[4] >= cutoff]
    return _payload(events)


def snapshot_payload_since(seq: int) -> dict:
    """Non-consuming view of local records with seq >= ``seq``. The
    incremental-fold path: a reader remembers :func:`next_seq` before a
    window and reads only the records made since."""
    return _payload(_collect(max(0, seq), _hi[0]))


def next_seq() -> int:
    """The seq the next record will take (a mark for
    :func:`snapshot_payload_since`)."""
    return _hi[0] + 1


def reset_for_tests() -> None:
    global _seq
    _seq = itertools.count()
    _hi[0] = -1
    _drained[0] = 0
    for i in range(len(_slots)):
        _slots[i] = None


# --------------------------------------------------------------------------- #
# Crash flight recorder
# --------------------------------------------------------------------------- #


def dump(reason: str, window_s: Optional[float] = None) -> Optional[str]:
    """Write the last N seconds of local spans to
    ``<session_dir>/logs/flightrec/`` (armed via :func:`set_dump_dir`).
    Best-effort by contract: the callers are death paths."""
    d = _dump_dir[0]
    if d is None or not enabled():
        return None
    try:
        os.makedirs(d, exist_ok=True)
        payload = snapshot_payload(window_s or _dump_window_s[0])
        payload["reason"] = reason
        payload["wall_ts"] = time.time()
        path = os.path.join(
            d, f"{_proc_label[0].replace(':', '_').replace('/', '_')}"
               f"-{os.getpid()}-{int(time.time() * 1000)}.json")
        with open(path, "w") as f:
            json.dump(payload, f)
        return path
    except Exception:
        return None


# --------------------------------------------------------------------------- #
# Trace export: payloads -> Chrome/Perfetto events -> attribution
# --------------------------------------------------------------------------- #


def build_span_events(payloads: List[dict]) -> List[Dict[str, Any]]:
    """Chrome-trace events from collected span payloads. Each payload
    carries its process anchors plus ``source`` / ``node_hex`` /
    ``offset_s`` stamped by the collector; the per-node offset merges
    every clock onto the head's wall timeline. Tracks: one pid per
    node, one tid per (process, span-or-channel)."""
    events: List[Dict[str, Any]] = []
    for p in payloads:
        names = {int(k): v for k, v in (p.get("names") or {}).items()}
        base = (p.get("anchor_wall", 0.0) - p.get("anchor_mono", 0.0)
                - p.get("offset_s", 0.0))
        pid = f"node:{(p.get('node_hex') or 'head')[:6]}"
        proc = p.get("proc") or f"pid{p.get('pid', '?')}"
        for rec in p.get("events") or ():
            seq, sid, kind, t0, dur, tags = rec
            d = names.get(sid)
            if d is None:
                continue
            name = d["name"]
            args = dict(zip(d.get("tag_keys") or (), tags or ()))
            # channels get their own track (per-channel lanes make
            # backpressure visible); everything else tracks per span
            # name within the process
            chan = args.get("channel")
            tid = (f"{proc} {name} {chan}" if chan
                   else f"{proc} {name}")
            ev = {"cat": "span", "name": name,
                  "ts": (t0 + base) * 1e6,
                  "pid": pid, "tid": tid,
                  "args": dict(args, source=p.get("source", proc))}
            if kind == KIND_INSTANT:
                ev.update({"ph": "i", "s": "t"})
            else:
                ev.update({"ph": "X", "dur": max(0.0, dur * 1e6)})
            events.append(ev)
    return events

"""The port's config knobs: a copy of the fields of
``ray_tpu/core/config.py``'s ``Config`` that the port reads, with the same
names, defaults and ``RAY_TPU_<FIELD>`` environment overrides, so one
environment variable governs both packages.

Only the observability knobs are here (the flight recorder, the program
observatory, device telemetry and the serve counters), each read by the
module named beside it; the runtime's knobs (among them the recorder's
``flight_recorder_report_interval_ms``, read by the runtime's report
loop) come with the runtime's port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


def _env(name: str, default, typ):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return typ(raw)


@dataclass
class Config:
    # per-process device telemetry (util/device_telemetry.py): memory
    # gauges from torch.cuda.memory_stats. Off, a collection publishes
    # nothing and start_device_telemetry starts no thread; the interval
    # is the collector thread's
    device_telemetry_enabled: bool = True
    device_telemetry_interval_ms: int = 10_000
    # the program observatory (util/program_observatory.py): per-process
    # registry of observed programs (first-call wall time, counted FLOPs,
    # bytes and peak bytes, input fingerprints). The kill switch exists
    # so the observation cost can be measured against a run without it
    xla_observatory_enabled: bool = True
    # roofline ceiling overrides for the program report, in FLOP/s and
    # bytes/s per card; 0 = from the card's name (the H100 table) or the
    # nominal trend-only CPU values
    xla_peak_flops: float = 0.0
    xla_peak_hbm_bytes: float = 0.0
    # serve observability: tokens generated and inter-token latency of
    # the decode scheduler (serve/observability.py)
    serve_observability_enabled: bool = True
    # flight recorder (util/flight_recorder.py): per-process span ring,
    # adopting these knobs on first use. The hot path is a flag test when
    # off and two clock reads and a tuple store when on
    flight_recorder: bool = True
    # ring capacity in span records per process (rounded up to a power
    # of two)
    flight_recorder_events: int = 65536
    # seconds of trailing spans a crash dump keeps
    flight_recorder_dump_window_s: float = 10.0
    # duration floor: spans shorter than this skip the ring, leaving
    # only the clock reads on the hot path; step-scale spans (train
    # steps, decode iterations) sit far above it. 0 records everything
    flight_recorder_min_span_us: float = 500.0

    def __post_init__(self):
        for f in fields(self):
            cur = getattr(self, f.name)
            setattr(self, f.name, _env(f.name, cur, type(cur)))


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config

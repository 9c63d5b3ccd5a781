"""CUDA device telemetry: memory gauges and compile-plane event counters
(port of ``ray_tpu/util/device_telemetry.py``).

Per process, this collector publishes:

- ``port_device_bytes_in_use`` / ``port_device_peak_bytes_in_use``
  gauges from ``torch.cuda.memory_stats(i)``
  (``allocated_bytes.all.current`` and ``allocated_bytes.all.peak``, what
  ``memory_allocated`` and ``max_memory_allocated`` read), tagged
  ``node`` and ``device`` (``cuda:<i>``);
- ``port_compile_events_total{event}`` counters and
  ``port_compile_event_duration_seconds`` histograms of the port's own
  compile-plane events, each reported where it happens
  (:func:`record_compile_event`): ``kernel.build`` and ``kernel.load``
  in ``ops/_build.py``, ``program.first_call`` in the program
  observatory. JAX's ``jax.monitoring`` listeners and the import hook
  that installs them have no counterpart: nothing in the port compiles
  behind its back.

Laziness is load-bearing, as in JAX: :func:`collect_once` does nothing
until this process has initialised CUDA, never initialises it itself,
and publishes only the cards this process has allocated on (a card's
allocator statistics are host-side counters; reading them opens no
context). Under ``train/launch.py`` each rank owns one card, and a rank
must not open a context on another rank's card.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import threading
from typing import List, Optional

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

_BYTES_IN_USE = Gauge("port_device_bytes_in_use",
                      "accelerator memory currently allocated (bytes)")
_PEAK_BYTES = Gauge("port_device_peak_bytes_in_use",
                    "peak accelerator memory allocated (bytes)")
_COMPILE_EVENTS = Counter(
    "port_compile_events_total",
    "compile-plane events (kernel builds and loads, the program "
    "observatory's first calls)")
_COMPILE_DURATIONS = Histogram(
    "port_compile_event_duration_seconds",
    "compile-plane event durations (kernel build, first-call analysis)",
    boundaries=[0.01, 0.1, 1, 10, 60])

# node hex prefix stamped onto the event series: counters SUM across
# sources, so without this tag two processes' counts would merge into one
# anonymous series
_node_tag = [""]


def set_node_tag(node_hex: str) -> None:
    if node_hex:
        _node_tag[0] = node_hex[:8]


def clear_node_tag() -> None:
    """Forget the node tag once this process's runtime has shut down: its
    node is gone, and later events belong to no node."""
    _node_tag[0] = ""


def _event_tags(event: str) -> dict:
    tags = {"event": str(event)}
    if _node_tag[0]:
        tags["node"] = _node_tag[0]
    return tags


def record_compile_event(event: str,
                         duration_s: Optional[float] = None) -> None:
    """Count one compile-plane event and, given its duration, observe it.
    Never raises into the caller."""
    try:
        tags = _event_tags(event)
        _COMPILE_EVENTS.inc(1.0, tags=tags)
        if duration_s is not None:
            _COMPILE_DURATIONS.observe(float(duration_s), tags=tags)
    except Exception:  # noqa: BLE001 — telemetry never breaks its caller
        pass


class CudaDevice:
    """One card's allocator statistics, in the form
    :func:`collect_device_stats` reads (``type``, ``index`` and
    ``memory_stats()``)."""

    type = "cuda"

    def __init__(self, index: int):
        self.index = index

    def memory_stats(self) -> dict:
        import torch

        return torch.cuda.memory_stats(self.index)


def collect_device_stats(devices: List, node_hex: str = "") -> int:
    """Publish the memory gauges of the given devices; returns how many
    reported stats. A device whose peak is 0 (this process never
    allocated on it) or that reports nothing is skipped."""
    node = node_hex[:8] or "local"
    n = 0
    for d in devices:
        try:
            stats = d.memory_stats()
        except Exception:  # noqa: BLE001 — a device without stats
            stats = None
        if not stats or not stats.get("allocated_bytes.all.peak"):
            continue
        tags = {"node": node,
                "device": f"{getattr(d, 'type', 'dev')}:"
                          f"{getattr(d, 'index', n)}"}
        _BYTES_IN_USE.set(float(stats.get("allocated_bytes.all.current",
                                          0)), tags=tags)
        _PEAK_BYTES.set(float(stats["allocated_bytes.all.peak"]), tags=tags)
        n += 1
    return n


# nvidia-smi query fields -> the keys of a card's reading
_CARD_FIELDS = (("index", "index"), ("name", "name"),
                ("memory.used", "memory_used_mib"),
                ("memory.total", "memory_total_mib"),
                ("utilization.gpu", "utilization_pct"),
                ("power.draw", "power_draw_w"),
                ("power.limit", "power_limit_w"))


def query_cards(timeout: float = 5.0) -> List[dict]:
    """This node's cards as ``nvidia-smi`` reads them (name, memory used
    and total in MiB, utilization, power draw and limit), without a CUDA
    context: the node agent's view of the cards its workers hold. Cards
    outside ``CUDA_VISIBLE_DEVICES`` (when it lists indices) are left
    out; where ``nvidia-smi`` is missing or fails, an empty list."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    query = ",".join(q for q, _ in _CARD_FIELDS)
    try:
        out = subprocess.run(
            [exe, f"--query-gpu={query}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    keep = set(visible) if visible and all(v.isdigit() for v in visible) \
        else None
    cards = []
    for line in out.stdout.splitlines():
        vals = [v.strip() for v in line.split(",")]
        if len(vals) != len(_CARD_FIELDS) or (keep and vals[0] not in keep):
            continue
        card: dict = {}
        for (_, key), val in zip(_CARD_FIELDS, vals):
            if key == "name":
                card[key] = val
                continue
            try:
                card[key] = int(val) if key == "index" else float(val)
            except ValueError:  # "[N/A]"
                card[key] = None
        cards.append(card)
    return cards


def _knobs():
    from ray_tpu_torch.core.config import global_config

    return global_config()


def collect_once(node_hex: str = "") -> int:
    """One collection tick over the cards this process has allocated on.
    A no-op until the process has initialised CUDA, and with the
    ``device_telemetry_enabled`` knob off."""
    # a process that never imported torch has no CUDA context: the
    # runtime's workers start this collector before any task runs
    torch = sys.modules.get("torch")
    if not _knobs().device_telemetry_enabled or torch is None \
            or not torch.cuda.is_initialized():
        return 0
    devices = [CudaDevice(i) for i in range(torch.cuda.device_count())]
    return collect_device_stats(devices, node_hex)


def start_device_telemetry(node_hex: str = ""
                           ) -> Optional[threading.Event]:
    """Start the per-process collector thread, one collection every
    ``device_telemetry_interval_ms``; returns its stop event, or None
    (no thread) with the ``device_telemetry_enabled`` knob off, as the
    JAX package's callers gate it."""
    knobs = _knobs()
    if not knobs.device_telemetry_enabled:
        return None
    set_node_tag(node_hex)
    interval_s = max(0.05, knobs.device_telemetry_interval_ms / 1000.0)
    stop = threading.Event()

    def loop():
        while not stop.wait(interval_s):
            try:
                collect_once(node_hex)
            except Exception:  # noqa: BLE001 — telemetry never takes a
                pass           # process down

    threading.Thread(target=loop, daemon=True,
                     name="device-telemetry").start()
    return stop

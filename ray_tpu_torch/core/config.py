"""Config/flag system (a copy of ``ray_tpu/core/config.py``).

Analog of the reference's ``src/ray/common/ray_config_def.h`` (216 RAY_CONFIG
entries overridable by ``RAY_<name>`` env vars) — a single typed registry of
every runtime tunable, overridable with ``RAY_TPU_<NAME>`` environment
variables, snapshotted at cluster start and shipped to workers. The port
keeps the JAX package's field names, defaults and overrides, so one
environment variable governs both packages.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields, asdict
from typing import Any, Dict


def _env(name: str, default, typ):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return typ(raw)


# Bootstrap-time environment variables read OUTSIDE the Config snapshot.
# These are consulted before a cluster (and therefore a Config) exists —
# connect addresses, credentials, per-process identity — so they cannot be
# Config fields: a daemon adopts the head's Config at registration, which
# would clobber per-node values like the advertised IP.  graftlint's
# config-hygiene check requires every direct RAY_TPU_* read in the tree to
# appear here (and in docs/configuration.md); everything else must go
# through a Config field + global_config().
BOOTSTRAP_ENV_VARS = {
    "RAY_TPU_ADDRESS": "head address ray_tpu_torch.init() connects to",
    "RAY_TPU_CLUSTER_KEY": "cluster auth key (hex) for client connects",
    "RAY_TPU_NODE_IP": "routable IP this node advertises to peers",
    "RAY_TPU_JOB_TOKEN": "dashboard job-submission auth token",
    "RAY_TPU_USAGE_STATS_ENABLED": "opt-in usage-stats reporting",
    "RAY_TPU_WORKFLOW_STORAGE": "workflow checkpoint storage URI",
    "RAY_TPU_RUNTIME_ENV_PLUGINS": "entry points for runtime_env plugins",
}


@dataclass
class Config:
    # ---- object store / plasma (reference: ray_config_def.h:199,345,398,614) ----
    max_direct_call_object_size: int = 100 * 1024  # inline vs shared-mem threshold
    object_store_memory: int = 512 * 1024 * 1024  # default shm arena bytes
    object_store_full_delay_ms: int = 10
    object_transfer_chunk_size: int = 5 * 1024 * 1024
    object_spilling_enabled: bool = True
    object_spilling_dir: str = ""  # defaults to session dir /spill
    min_spilling_size: int = 1 * 1024 * 1024
    max_io_workers: int = 4
    # arena usage fraction past which the store emits a WARNING cluster
    # event naming the top consumers by creation callsite (<= 0 disables)
    object_store_high_watermark: float = 0.8

    # ---- object data plane (node-to-node transfer; object_transfer.py) ----
    # pooled, reusable authenticated connections per peer object server
    # (reference: ObjectManager keeps persistent gRPC channels per remote;
    # a fresh TCP+HMAC handshake per pull was the round-5 hot-path tax)
    object_pool_enabled: bool = True
    object_pool_connections_per_peer: int = 4
    object_pool_idle_timeout_s: float = 60.0
    # striped multi-peer pulls: objects >= threshold with >=2 holders are
    # split into per-holder stripes pulled in parallel into disjoint arena
    # slices (reference: chunked parallel pulls, pull_manager.h)
    object_stripe_threshold: int = 8 * 1024 * 1024
    object_stripe_max_peers: int = 4
    # cross-host compiled-graph rings (core/net_ring.py): Go-Back-N
    # retransmission cadence — a message whose ack made no progress for
    # this long is re-sent (the recovery path after a dropped data/ack
    # message or a reconnected session; the model-checked re-ack rule
    # makes every retransmission idempotent)
    net_ring_retransmit_ms: int = 50

    # ---- scheduler (reference: ray_config_def.h:179,185,190) ----
    scheduler_spread_threshold: float = 0.5
    scheduler_top_k_fraction: float = 0.2
    scheduler_top_k_absolute: int = 1
    raylet_report_resources_period_ms: int = 100

    # ---- workers ----
    num_workers_soft_limit: int = -1  # -1 => num_cpus
    worker_maximum_startup_concurrency: int = 0  # 0 => num_cpus
    worker_prestart_count: int = 2  # eagerly forked at node start (reference:
    # worker_pool.h:163 num_prestarted_python_workers)
    worker_register_timeout_s: float = 60.0
    worker_lease_idle_timeout_s: float = 5.0
    # plain CPU tasks staged per worker beyond the running one (lease
    # pipelining, reference: normal_task_submitter.h worker_to_lease_entry_
    # + max_tasks_in_flight; hides the done->dispatch round trip)
    worker_pipeline_depth: int = 2

    # ---- direct (head-bypass) task path ----
    # Eligible plain CPU tasks execute via the submitter's node + one-hop
    # peer spillback, with batched event reports to the head (reference:
    # normal_task_submitter.cc — the GCS is out of the normal-task path)
    direct_task_enabled: bool = True
    # actor method calls go caller->actor-node directly (head keeps the
    # lifecycle FSM only); off = every a.m.remote() routes via the head
    direct_actor_enabled: bool = True
    # spill to a peer when the local queue exceeds factor * max_workers
    direct_spill_queue_factor: float = 4.0
    # executor nodes batch (object-location + observability) events to the
    # head: flush at this many events or this age, whichever first
    direct_event_batch_size: int = 200
    direct_event_flush_ms: int = 20
    # direct tasks may hold at most this fraction of a node's worker slots
    # while head-dispatched (resource-bound) work is waiting — prevents a
    # direct-task flood from starving scheduler-placed tasks
    direct_slot_fraction: float = 0.85
    # idle nodes pull queued direct tasks from the deepest-queued peer
    # (work stealing — spillback is otherwise submit-time-only); 0 = off
    direct_steal_enabled: bool = True
    direct_steal_min_queue: int = 2  # only steal from peers at least this deep
    direct_steal_interval_ms: int = 50
    # published (cross-process) streams that reached EOF with the local
    # handle dropped are retained for remote subscribers — bounded FIFO:
    # past this many, the oldest purge and stragglers see owner-gone
    # (the owner-side analog of the old head stream-record TTL)
    published_stream_retain_max: int = 256

    # ---- tasks / fault tolerance (reference: ray_config_def.h:138,414,835) ----
    task_retry_delay_ms: int = 0
    lineage_pinning_enabled: bool = True
    # owner-side lineage for direct-path store-resident results: specs
    # retained for reconstruction after the sealing node dies (reference:
    # object_recovery_manager.h + max_lineage_bytes-style cap); 0 = off
    direct_lineage_max: int = 4096
    # actor re-creation backoff: the first restart waits delay_ms, each
    # further restart doubles it up to max_delay_ms (reference:
    # gcs_actor_manager restart backoff); delay_ms=0 restarts immediately
    actor_restart_delay_ms: int = 0
    actor_restart_max_delay_ms: int = 10_000
    # head restart: how long a daemon keeps re-dialing a bounced head
    # before giving up and shutting down, and how long the restarted head
    # waits for known daemons to re-register before declaring them dead
    # (their actors then fail over per max_restarts)
    head_rejoin_timeout_s: float = 30.0
    daemon_rejoin_grace_s: float = 10.0
    # node prober: period * threshold = grace before a silent daemon is
    # declared dead (generous default — pongs share the daemon's handler
    # pool, so a saturated 1-core host must not look dead)
    health_check_period_ms: int = 2000
    health_check_failure_threshold: int = 10

    # ---- head record GC (reference: task-event cap semantics,
    # ray_config_def.h task_events_max_num_task_in_gcs area) ----
    # settled head task records fold into the capped event ring after this
    # TTL (kept while their results are referenced — lineage — or while
    # the actor they created is alive); 0 disables the sweeper
    task_record_ttl_s: float = 120.0
    task_record_gc_period_s: float = 15.0

    # ---- observability ----
    log_to_driver: bool = True  # tail worker stdout/stderr to the driver
    task_events_enabled: bool = True
    task_events_max_buffered: int = 100_000
    metrics_report_interval_ms: int = 10_000
    event_log_enabled: bool = True
    # structured cluster event log (util/events.py -> GCS ring + JSONL).
    # emit() delivers inline; the flush cadence only governs re-delivery
    # after a failed send, so it stays low-frequency (per-worker wakeups
    # add jitter to latency-sensitive loops)
    cluster_events_max_buffered: int = 10_000
    cluster_event_flush_ms: int = 1000
    cluster_events_log_max_bytes: int = 64 * 1024 * 1024
    # head-side metrics time-series rings (/api/metrics/history)
    metrics_history_enabled: bool = True
    metrics_history_interval_ms: int = 5_000
    metrics_history_max_samples: int = 360
    # per-process JAX/TPU device telemetry (HBM gauges + jax.monitoring)
    device_telemetry_enabled: bool = True
    device_telemetry_interval_ms: int = 10_000
    # XLA compile observatory (util/xla_observatory.py): per-process
    # registry of observed jitted executables (compile wall time,
    # cost/memory analyses, aval fingerprints) feeding the standard
    # metrics/span channels. The kill switch exists so bench.py
    # --xla-bench can measure the observation cost (BENCH_XLA.json,
    # <=1% of the spmd step)
    xla_observatory_enabled: bool = True
    # recompile-storm detector (train/health.py): >= trigger NEW-aval
    # recompiles of one program within a monitor tick raises one
    # WARNING naming the program and the shape churn; it clears after
    # clear_ticks consecutive quiet ticks (hysteresis — no flapping)
    xla_storm_trigger_recompiles: int = 3
    xla_storm_clear_ticks: int = 2
    # roofline ceiling overrides for the xla report, in FLOP/s and
    # bytes/s per chip; 0 = auto-detect from the device kind (TPU
    # table) or fall back to nominal trend-only CPU values
    xla_peak_flops: float = 0.0
    xla_peak_hbm_bytes: float = 0.0
    # object/memory observability (core/ref_tracker.py): per-process
    # ObjectRef accounting joined head-side into the `ray memory` analog
    # (util/state.memory_summary, /api/memory). The kill switch exists so
    # bench_objects.py --check can measure the accounting's own cost.
    ref_accounting_enabled: bool = True
    # capture creator callsites (file:line:function) at ref creation —
    # a sys._getframe walk per put/submit, so opt-in (the `ray memory`
    # RAY_record_ref_creation_sites analog)
    record_ref_creation_sites: bool = False
    # worker -> head ref-table report cadence (rides the worker channel
    # one-way, same shape as the metrics report)
    ref_report_interval_ms: int = 1000
    # serve request-path observability: request ids + per-stage latency
    # histograms + JSONL access logs + slow-request events (serve/
    # observability.py). One switch for the whole layer so the bench can
    # measure its overhead; the access log has its own gate
    serve_observability_enabled: bool = True
    serve_access_log_enabled: bool = True
    serve_access_log_max_bytes: int = 64 * 1024 * 1024
    # requests slower end-to-end than this emit a WARNING cluster event
    # with the stage breakdown; per-deployment override via
    # @serve.deployment(slow_request_threshold_s=...); <= 0 disables
    serve_slow_request_threshold_s: float = 1.0
    # flight recorder (util/flight_recorder.py): always-on per-process
    # span rings behind `python -m ray_tpu timeline`. The hot path is a
    # flag test when off and ~two clock reads + a tuple store when on
    # (overhead bench-gated in BENCH_TRACE.json)
    flight_recorder: bool = True
    # ring capacity in span records per process (rounded up to a power
    # of two; one record is one fixed-size tuple slot)
    flight_recorder_events: int = 65536
    # seconds of trailing spans a crash dump keeps (fault-injection
    # crashes and attributed-death paths write
    # session_dir/logs/flightrec/<proc>-<pid>-<ts>.json)
    flight_recorder_dump_window_s: float = 10.0
    # worker/daemon -> head span-drain cadence (rides the worker channel
    # one-way like the metrics report; drops are harmless — the next
    # drain re-ships nothing, spans are consumed on drain)
    flight_recorder_report_interval_ms: int = 2000
    # goodput observatory (util/goodput.py + train/health.py): a head
    # service folds the span/metrics planes into a badput ledger and
    # runs the straggler/regression/TTRT detectors on this cadence
    health_monitor_enabled: bool = True
    health_monitor_interval_ms: int = 5_000
    # straggler detector: a host (or MPMD stage) whose mean step-span
    # duration exceeds the cluster median by trigger_x raises an
    # edge-triggered WARNING; it clears below clear_x. The gap between
    # the two is the hysteresis band — a host oscillating across one
    # threshold cannot flap events. min_spans is the evidence floor.
    straggler_trigger_x: float = 1.5
    straggler_clear_x: float = 1.2
    straggler_min_spans: int = 4
    # regression detector: recent-window mean vs rolling baseline on
    # the head's metrics-history rings (train step time, tokens/s,
    # serve dispatch latency). trigger/clear are degradation factors
    # with the same hysteresis contract as the straggler knobs;
    # min_samples points must exist before a series is judged and the
    # last `window` of them form the recent mean.
    regression_trigger_x: float = 1.3
    regression_clear_x: float = 1.1
    regression_min_samples: int = 8
    regression_window: int = 3
    # time-to-recovered-throughput: after a death event, throughput is
    # "recovered" once back within this fraction of the pre-fault
    # rolling baseline (0.2 = within 20%)
    ttrt_recovery_fraction: float = 0.2
    # cluster stack dump (`python -m ray_tpu stack`): how long each
    # process samples its threads for the one-shot collapsed dump
    stack_dump_duration_ms: int = 200
    # duration floor: spans shorter than this skip the ring, leaving
    # only the clock reads on the hot path — what keeps the recorder
    # inside the <=3% dag-bench overhead gate at microsecond dispatch
    # rates. The default sits above the ring-wait jitter of an
    # oversubscribed host (waits stretch into the hundreds of us there,
    # and recording every one re-inflates the hot path exactly when the
    # box is slowest); step-scale spans (pipeline fwd/bwd, SPMD phases,
    # bubbles, batch drains) sit at ms scale, far above it, and the
    # ring STALL COUNTERS still aggregate every wait regardless.
    # Lower it (or set 0: record everything) to trace micro behavior.
    flight_recorder_min_span_us: float = 500.0

    # ---- serve compiled dispatch plane (serve/compiled_dispatch.py) ----
    # route unary requests over long-lived compiled graphs (one ring-pair
    # lane per replica, microsecond dispatch) instead of eager remote();
    # the eager handle path stays as automatic fallback (streaming,
    # worker/client-side handles, oversized payloads, lane build failure)
    serve_compiled_dispatch: bool = True
    # per-replica admission window: ring slots per lane = bounded
    # in-flight per replica = continuous-batch ceiling. Structural
    # backpressure: a full window overflows to the eager path (within
    # the budget) instead of queueing. Per-deployment override via
    # @serve.deployment(max_inflight=...)
    serve_max_inflight: int = 8
    # per-deployment concurrency budget at the dispatching process:
    # once this many requests are in flight AND every replica window is
    # full, new requests shed with serve.BackPressureError instead of
    # queueing without bound. 0 = unlimited (never shed). Override via
    # @serve.deployment(concurrency_budget=...)
    serve_concurrency_budget: int = 0
    # ring slot size per lane message; requests/replies larger than this
    # fall back to the eager path for that call
    serve_channel_slot_bytes: int = 1 * 1024 * 1024
    # prewarmed worker pool per node: keep this many IDLE pre-forked
    # workers on standby so a serve scale-out consumes a warm process
    # instead of paying the fork+import cold start on the ramp step
    # (kills the scale-out p99 tail). 0 = off.
    serve_prewarm_pool_size: int = 0

    # ---- fault injection (reference: testing_asio_delay_us :824) ----
    testing_delay_ms: str = ""  # "handler1=ms,handler2=ms" injected latency
    # artificially slow EVERY control RPC the head serves (ms/op). The
    # head-freeness proof: with this at >=50, direct actor-call p50 and
    # cross-process stream items/s must not move (bench_core --actor-bench)
    test_head_delay_ms: int = 0
    # deterministic chaos harness (core/fault_injection.py): named failure
    # points armed with crash/raise/drop/fail/delay actions at exact hit
    # counts, e.g. "worker.exec.boom=crash@2;wire.send.sync=drop@1+".
    # Ships with the Config snapshot, so one env var arms every process.
    test_fault_spec: str = ""

    # ---- debug assertions ----
    # dynamic lock-order checking (core/lock_debug.py): runtime locks
    # created through lock_debug.tracked_* keep a thread-local acquisition
    # stack and a global order graph, raising LockOrderViolation the
    # moment two locks are ever taken in both orders — the runtime
    # counterpart of graftlint's static lock-order check. Test-only: adds
    # a graph probe per acquire, so off by default.
    debug_lock_order: bool = False

    # ---- TPU (reference: custom_unit_instance_resources :735) ----
    # Resources tracked per unit instance (index-assignable like CUDA devices).
    unit_instance_resources: str = "TPU,GPU,neuron_cores,NPU,HPU"

    # ---- collective ----
    collective_timeout_s: float = 300.0

    # ---- sharded training (train/spmd.py) ----
    # mesh axis spec for the SPMD train loop, e.g. "data=4,fsdp=2";
    # empty = pure data-parallel over all local devices. The same
    # config runs devices=1 and devices=N — with one device every
    # collective folds to the identity.
    train_mesh: str = ""
    # donate the carried train state on the jit step (params/optimizer
    # buffers alias their outputs — in-place update instead of a full
    # state copy per step). Toggle exists so benches can price it.
    train_donate: bool = True
    # batches kept in flight by the sharded to_jax ingest path
    # (per-shard device_put double-buffering: host→device transfer of
    # batch N+1 overlaps compute on batch N)
    train_ingest_prefetch: int = 2
    # fsdp param gather schedule for the shard_map step: "streamed"
    # gathers each scanned layer inside the scan, prefetching layer i+1
    # while layer i computes (ZeRO-3 prefetch; O(tree/L) peak param
    # residency); "upfront" bulk-gathers the whole tree first. Folds to
    # upfront on meshes without an fsdp axis.
    train_gather: str = "streamed"

    def __post_init__(self):
        for f in fields(self):
            cur = getattr(self, f.name)
            setattr(self, f.name, _env(f.name, cur, type(cur)))

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Config":
        cfg = cls()
        for k, v in json.loads(s).items():
            setattr(cfg, k, v)
        return cfg

    def delay_for(self, handler: str) -> float:
        """Fault-injection latency (seconds) for a named handler, 0 if none."""
        if not self.testing_delay_ms:
            return 0.0
        for part in self.testing_delay_ms.split(","):
            if "=" in part:
                name, ms = part.split("=", 1)
                if name == handler:
                    return float(ms) / 1000.0
        return 0.0


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def set_global_config(cfg: Config):
    global _global_config
    _global_config = cfg

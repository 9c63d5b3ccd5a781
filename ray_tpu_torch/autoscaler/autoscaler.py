"""The reconciler: demand in, launch/terminate decisions out.

Reference shape: autoscaler v2's Reconciler
(python/ray/autoscaler/v2/instance_manager/reconciler.py via
autoscaler.py:42 update()) — each tick reads (1) pending resource demand,
(2) current instance states, and computes a target; plus v1's idle-node
termination (_private/autoscaler.py StandardAutoscaler._update). Demand
here comes straight from the head scheduler's pending queues
(core/scheduler.py pending_demand()), not a gossip pipeline — the
single-head design makes load reports exact.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider


@dataclass
class AutoscalerConfig:
    min_workers: int = 0
    max_workers: int = 4
    idle_timeout_s: float = 30.0
    interval_s: float = 1.0
    # fraction of outstanding demand to satisfy per tick (v1's
    # upscaling_speed: 1.0 = launch for all unplaced work at once)
    upscaling_speed: float = 1.0
    # resources each launched worker contributes (capacity planning unit)
    node_config: Dict = field(default_factory=lambda: {"num_cpus": 2})


class Autoscaler:
    """Periodic reconciler bound to a Head + NodeProvider."""

    def __init__(self, head, provider: NodeProvider,
                 config: Optional[AutoscalerConfig] = None):
        self.head = head
        self.provider = provider
        self.config = config or AutoscalerConfig()
        self._idle_since: Dict[str, float] = {}   # node_hex -> ts
        self._stopped = threading.Event()
        self.num_launches = 0
        self.num_terminations = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    # ---- sizing math ------------------------------------------------------
    def _node_capacity(self) -> Dict[str, float]:
        cap = {}
        nc = self.config.node_config
        if nc.get("num_cpus"):
            cap["CPU"] = float(nc["num_cpus"])
        if nc.get("num_gpus"):
            cap["GPU"] = float(nc["num_gpus"])
        for k, v in (nc.get("resources") or {}).items():
            cap[k] = float(v)
        return cap or {"CPU": 1.0}

    def _workers_for_demand(self, demand: List[Dict[str, float]]) -> int:
        """Bin-pack pending asks onto fresh nodes of node_config capacity
        (first-fit; the v2 resource_demand_scheduler analog)."""
        cap = self._node_capacity()
        bins: List[Dict[str, float]] = []
        for ask in demand:
            ask = {k: v for k, v in ask.items() if v > 0}
            if not ask:
                continue
            if any(ask.get(k, 0) > cap.get(k, 0) for k in ask):
                continue  # infeasible on this node shape: skip (and log?)
            placed = False
            for b in bins:
                if all(b.get(k, 0) >= v for k, v in ask.items()):
                    for k, v in ask.items():
                        b[k] = b[k] - v
                    placed = True
                    break
            if not placed:
                fresh = dict(cap)
                for k, v in ask.items():
                    fresh[k] = fresh.get(k, 0) - v
                bins.append(fresh)
        return len(bins)

    # ---- reconcile tick ---------------------------------------------------
    def update(self) -> None:
        """One reconcile pass (public for tests; the loop calls it).

        Size accounting: ``provider_count`` (instances the provider holds,
        joined or still booting) vs ``alive_workers`` (nodes registered in
        GCS). in-flight = provider_count - alive_workers, so repeated
        ticks don't double-launch while daemons boot.
        """
        cfg = self.config
        now = time.monotonic()
        provider_count = len(self.provider.non_terminated_nodes())
        head_hex = self.head.head_node.hex
        alive_workers = [n for n in self.head.gcs.alive_nodes()
                         if n.hex != head_hex]

        from ray_tpu_torch.util import events as events_mod

        demand = self.head.scheduler.pending_demand()
        want = int(math.ceil(
            self._workers_for_demand(demand) * cfg.upscaling_speed))
        target = max(cfg.min_workers,
                     min(cfg.max_workers, len(alive_workers) + want))
        # ---- scale up ----
        launching = max(0, target - provider_count)
        if launching:
            events_mod.emit(
                "INFO", events_mod.SOURCE_AUTOSCALER,
                f"scaling up: launching {launching} node(s) "
                f"(demand={len(demand)} asks, alive={len(alive_workers)}, "
                f"target={target})", entity_id="autoscaler",
                launching=launching, target=target,
                pending_demand=len(demand))
        for _ in range(launching):
            self.provider.create_node(dict(cfg.node_config))
            self.num_launches += 1

        # ---- scale down (idle nodes beyond min_workers) ----
        idle = set(self.head.scheduler.idle_nodes())
        idle.discard(head_hex)
        for h in list(self._idle_since):
            if h not in idle:
                del self._idle_since[h]
        for h in idle:
            self._idle_since.setdefault(h, now)
        expendable = len(alive_workers) - cfg.min_workers
        if expendable > 0 and not demand:
            victims = sorted(
                (h for h, t0 in self._idle_since.items()
                 if now - t0 >= cfg.idle_timeout_s),
                key=lambda h: self._idle_since[h])[:expendable]
            for h in victims:
                pid = self._provider_id_for(h)
                if pid is not None:
                    idle_s = now - self._idle_since[h]
                    events_mod.emit(
                        "INFO", events_mod.SOURCE_AUTOSCALER,
                        f"terminating idle node {h[:8]} "
                        f"(idle {idle_s:.1f}s >= {cfg.idle_timeout_s}s)",
                        entity_id=h, provider_id=pid, idle_s=idle_s)
                    self.provider.terminate_node(pid)
                    self.num_terminations += 1
                    del self._idle_since[h]

    def _provider_id_for(self, node_hex: str) -> Optional[str]:
        """Map a cluster node id to a provider instance id via labels."""
        info = self.head.gcs.nodes.get(node_hex)
        if info is None or not getattr(info, "alive", False):
            return None
        pid = (info.labels or {}).get("provider_id")
        if pid and pid in self.provider.non_terminated_nodes():
            return pid
        return None

    def _loop(self) -> None:
        import logging

        log = logging.getLogger("ray_tpu_torch.autoscaler")
        last_err = None
        while not self._stopped.wait(self.config.interval_s):
            try:
                self.update()
                last_err = None
            except Exception as e:  # next tick retries; log distinct errors
                if repr(e) != last_err:
                    last_err = repr(e)
                    log.exception("autoscaler reconcile failed "
                                  "(will keep retrying): %s", e)

    def stop(self, terminate_nodes: bool = True) -> None:
        self._stopped.set()
        self._thread.join(timeout=2.0)  # event-paced loop: exits promptly
        if terminate_nodes:
            self.provider.shutdown()

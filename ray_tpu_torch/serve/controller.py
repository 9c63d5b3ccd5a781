"""ServeController — reconciles deployment state to target replica sets.

Port of ``ray_tpu/serve/controller.py``: replica spawn (each replica an
actor with the deployment's ``ray_actor_options``, so ``num_gpus=1``
puts it on a card), health polling, rolling updates, autoscaling, the
long-poll version and the route and replica-set tables.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util import events as _events


def _emit(severity: str, message: str, entity_id: str = "",
          **attrs) -> None:
    _events.emit(severity, _events.SOURCE_SERVE, message,
                 entity_id=entity_id, **attrs)


@ray_tpu_torch.remote
class ServeController:
    """One detached actor per Serve instance. Runs a reconciliation thread:
    scale replica sets to target counts, replace unhealthy replicas,
    apply autoscaling decisions from replica queue stats."""

    def __init__(self):
        self._deployments: Dict[str, dict] = {}  # name -> record
        self._routes: Dict[str, str] = {}        # route_prefix -> name
        self._lock = threading.RLock()
        self._version = 0  # bumped on any change; long-poll wakes watchers
        self._version_cv = threading.Condition(self._lock)
        self._shutdown = False
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- deploy
    def deploy(self, name: str, serialized_callable, init_args, init_kwargs,
               config: dict) -> None:
        with self._lock:
            old = self._deployments.get(name)
            rec = {
                "name": name,
                "callable": serialized_callable,
                "init_args": init_args,
                "init_kwargs": init_kwargs,
                "config": config,
                "replicas": old["replicas"] if old else [],
                "target": config.get("num_replicas", 1),
                "version": config.get("version", "1"),
                "last_scale_up": 0.0,
                "last_scale_down": 0.0,
            }
            self._deployments[name] = rec
            # code/version changes roll gradually in the reconciler:
            # replicas carry the version they were spawned with; stale
            # ones are replaced one per cycle AFTER a surge replica of
            # the new version exists (maxSurge=1, maxUnavailable=0 —
            # reference: deployment_state.py rolling updates)
            route = config.get("route_prefix")
            if route:
                self._routes[route] = name
            auto = config.get("autoscaling")
            if auto:
                rec["target"] = max(auto["min_replicas"], 1)
            self._version += 1; self._version_cv.notify_all()
        _emit("INFO", f"deployment {name!r} "
              f"{'updated' if old else 'deployed'} "
              f"(target={rec['target']}, version={rec['version']})",
              entity_id=name, target=rec["target"],
              version=rec["version"])

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            rec = self._deployments.pop(name, None)
            if rec:
                for r in rec["replicas"]:
                    self._kill_replica(r)
            self._routes = {k: v for k, v in self._routes.items()
                            if v != name}
            self._version += 1; self._version_cv.notify_all()
        if rec:
            _emit("INFO", f"deployment {name!r} deleted", entity_id=name)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            for rec in self._deployments.values():
                for r in rec["replicas"]:
                    self._kill_replica(r)
            self._deployments.clear()
            self._routes.clear()
            self._version += 1; self._version_cv.notify_all()
        # reconcile loop re-checks _shutdown within its 0.1s tick; reap
        # it outside the lock (the loop takes _lock per reconcile)
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)

    # ------------------------------------------------------------ queries
    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            rec = self._deployments.get(name)
            return [r["actor"] for r in rec["replicas"]] if rec else []

    def get_replica_set(self, name: str) -> dict:
        """Replicas + the routing-relevant deployment options in ONE call
        (the router refresh path; avoids a separate option RPC on the
        first request of every handle)."""
        with self._lock:
            rec = self._deployments.get(name)
            if rec is None:
                return {"replicas": [], "retry_on_replica_failure": True,
                        "slow_request_threshold_s": None,
                        "max_inflight": None, "concurrency_budget": None,
                        "compiled_dispatch": None, "decode": False}
            return {
                "replicas": [r["actor"] for r in rec["replicas"]],
                "retry_on_replica_failure": rec["config"].get(
                    "retry_on_replica_failure", True),
                # None -> the caller falls back to the global config
                # default (serve_slow_request_threshold_s)
                "slow_request_threshold_s": rec["config"].get(
                    "slow_request_threshold_s"),
                # compiled dispatch plane knobs (None -> config default):
                # the router re-syncs its lanes from these on every
                # version bump, which is how a reconfigure/autoscale
                # lands on the compiled plane
                "max_inflight": rec["config"].get("max_inflight"),
                "concurrency_budget": rec["config"].get(
                    "concurrency_budget"),
                "compiled_dispatch": rec["config"].get(
                    "compiled_dispatch"),
                # generative decode: the handle streams tokens over the
                # compiled stream lanes instead of the eager path
                "decode": bool(rec["config"].get("decode")),
            }

    def get_version(self) -> int:
        return self._version

    def wait_for_version(self, cur: int, timeout: float = 30.0) -> int:
        """Long-poll: block until the config version moves past ``cur``
        (reference: _private/long_poll.py:177 LongPollHost) so routers and
        proxies learn of replica/route changes in milliseconds instead of
        a polling period. Requires the controller's max_concurrency > 1."""
        with self._version_cv:
            self._version_cv.wait_for(
                lambda: self._version != cur or self._shutdown, timeout)
            return self._version

    def get_route_meta(self) -> Dict[str, dict]:
        """Per-route metadata the proxy needs (stream flag, timeout)."""
        with self._lock:
            out = {}
            for prefix, name in self._routes.items():
                cfg = self._deployments.get(name, {}).get("config", {})
                out[prefix] = {
                    "name": name,
                    "stream": bool(cfg.get("stream")),
                    "timeout": float(cfg.get("request_timeout_s", 60.0)),
                    # decode routes stream server-sent events; bytes_body
                    # routes hand the raw body to __call__ (TAG_BYTES
                    # fast lane on the compiled plane)
                    "decode": bool(cfg.get("decode")),
                    "bytes_body": bool(cfg.get("bytes_body")),
                }
            return out

    def list_deployments(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "target": rec["target"],
                    "num_replicas": len(rec["replicas"]),
                    "version": rec["version"],
                    "route_prefix": rec["config"].get("route_prefix"),
                }
                for name, rec in self._deployments.items()
            }

    def get_deployment_option(self, name: str, key: str, default=None):
        with self._lock:
            rec = self._deployments.get(name)
            return rec["config"].get(key, default) if rec else default

    def deployment_ready(self, name: str) -> bool:
        with self._lock:
            rec = self._deployments.get(name)
            if rec is None:
                return False
            return len(rec["replicas"]) >= rec["target"] > 0

    # ------------------------------------------------------- reconciler
    def _kill_replica(self, r: dict) -> None:
        try:
            ray_tpu_torch.kill(r["actor"])
        except Exception:
            pass

    def _spawn_replica(self, rec: dict) -> dict:
        import uuid

        from .replica import ServeReplica

        opts = dict(rec["config"].get("ray_actor_options") or {})
        opts.setdefault("max_concurrency",
                        rec["config"].get("max_ongoing_requests", 100))
        # replica tag: names the replica in queue-depth gauges, access-log
        # file names, and slow-request events
        tag = f"{rec['name']}#{uuid.uuid4().hex[:6]}"
        actor = ServeReplica.options(**opts).remote(
            rec["callable"], rec["init_args"], rec["init_kwargs"],
            rec["config"].get("user_config"), rec["name"], tag)
        return {"actor": actor, "created": time.time(), "healthy": True,
                "version": rec["version"], "callable": rec["callable"],
                "tag": tag}

    def _autoscale(self, rec: dict, avg: Optional[float]) -> None:
        """Pure decision step: ``avg`` (ongoing requests per replica) was
        collected by _poll_replicas OUTSIDE the controller lock."""
        auto = rec["config"].get("autoscaling")
        if not auto or avg is None:
            return
        target = rec["target"]
        now = time.time()
        if avg > auto["target_ongoing_requests"] \
                and target < auto["max_replicas"] \
                and now - rec["last_scale_up"] > auto["upscale_delay_s"]:
            rec["target"] = target + 1
            rec["last_scale_up"] = now
            _emit("INFO", f"deployment {rec['name']!r} autoscaling up: "
                  f"target {target} -> {target + 1} "
                  f"(avg ongoing {avg:.1f})", entity_id=rec["name"],
                  target=target + 1, avg_ongoing=avg)
        elif avg < auto["target_ongoing_requests"] / 2 \
                and target > auto["min_replicas"] \
                and now - rec["last_scale_down"] > auto["downscale_delay_s"]:
            rec["target"] = target - 1
            rec["last_scale_down"] = now
            _emit("INFO", f"deployment {rec['name']!r} autoscaling down: "
                  f"target {target} -> {target - 1} "
                  f"(avg ongoing {avg:.1f})", entity_id=rec["name"],
                  target=target - 1, avg_ongoing=avg)

    def _replica_stale(self, rec: dict, r: dict) -> bool:
        return (r.get("version") != rec["version"]
                or r.get("callable") != rec["callable"])

    def _probe_ready(self, replicas: List[dict]) -> None:
        """Non-blocking readiness: a replica is ready once it answers one
        health ping. Gates stale-replica retirement so a broken new
        version never takes down the serving set (reference:
        deployment_state.py waits for the surge replica to be healthy)."""
        for r in replicas:
            if r.get("ready"):
                continue
            ref = r.get("ping_ref")
            if ref is None:
                r["ping_ref"] = r["actor"].check_health.remote()
                continue
            done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if done:
                try:
                    r["ready"] = bool(ray_tpu_torch.get(ref, timeout=1))
                except Exception:
                    r["ready"] = False
                r["ping_ref"] = None
                if not r["ready"]:
                    r["ping_ref"] = r["actor"].check_health.remote()

    def _poll_replicas(self) -> dict:
        """Phase 1 of reconcile: every cluster round-trip (autoscale load
        stats, readiness pings) runs WITHOUT the controller lock held —
        holding it across ray_tpu_torch.get/wait blocks deploy()/status() and
        the long-poll broadcast for seconds (graftlint:
        blocking-under-lock).  Replica dicts are mutated lock-free the
        same way _health_check already does; the worst race is probing a
        replica the reconcile phase is about to retire."""
        with self._lock:
            if self._shutdown:
                return {}
            work = []
            for name, rec in self._deployments.items():
                replicas = list(rec["replicas"])
                fresh = [r for r in replicas
                         if not self._replica_stale(rec, r)]
                wants_stats = bool(rec["config"].get("autoscaling")
                                   and replicas)
                has_stale = len(fresh) < len(replicas)
                work.append((name, replicas, fresh, wants_stats, has_stale))
        stats: dict = {}
        for name, replicas, fresh, wants_stats, has_stale in work:
            if wants_stats:
                try:
                    vals = ray_tpu_torch.get(
                        [r["actor"].get_num_ongoing_requests.remote()
                         for r in replicas], timeout=2)
                    stats[name] = sum(vals) / max(len(vals), 1)
                except Exception:
                    pass
            if has_stale:
                self._probe_ready(fresh)
        return stats

    def _reconcile_once(self) -> None:
        stats = self._poll_replicas()
        with self._lock:
            if self._shutdown:
                return
            for name, rec in self._deployments.items():
                self._autoscale(rec, stats.get(name))
                replicas = rec["replicas"]
                stale = [r for r in replicas if self._replica_stale(rec, r)]
                fresh = [r for r in replicas if r not in stale]
                target = rec["target"]
                if stale:
                    # rolling update (maxSurge=1): spawn a fresh replica
                    # up to target+1 total; retire one stale per cycle
                    # only when enough fresh replicas are READY to keep
                    # the serving set covered (readiness was refreshed by
                    # _poll_replicas, outside this lock)
                    ready = [r for r in fresh if r.get("ready")]
                    if target == 0:
                        # scaled to zero mid-roll: nothing to cover, just
                        # retire the stale set
                        dead = stale[0]
                        replicas.remove(dead)
                        self._kill_replica(dead)
                        self._version += 1; self._version_cv.notify_all()
                        continue
                    if len(fresh) < target and len(replicas) <= target:
                        replicas.append(self._spawn_replica(rec))
                        self._version += 1; self._version_cv.notify_all()
                    elif (len(ready) >= min(target, len(fresh))
                          and len(ready) > 0
                          and (len(replicas) > target
                               or len(fresh) >= target)):
                        dead = stale[0]
                        replicas.remove(dead)
                        self._kill_replica(dead)
                        self._version += 1; self._version_cv.notify_all()
                    continue
                diff = target - len(replicas)
                if diff > 0:
                    for _ in range(diff):
                        replicas.append(self._spawn_replica(rec))
                    self._version += 1; self._version_cv.notify_all()
                    _emit("INFO", f"deployment {rec['name']!r} scaled up: "
                          f"+{diff} replica(s) -> {len(replicas)}",
                          entity_id=rec["name"],
                          num_replicas=len(replicas))
                elif diff < 0:
                    for _ in range(-diff):
                        dead = replicas.pop()
                        self._kill_replica(dead)
                    self._version += 1; self._version_cv.notify_all()
                    _emit("INFO", f"deployment {rec['name']!r} scaled "
                          f"down: {-diff} replica(s) -> {len(replicas)}",
                          entity_id=rec["name"],
                          num_replicas=len(replicas))

    def _health_check(self) -> None:
        with self._lock:
            recs = list(self._deployments.values())
        for rec in recs:
            bad = []
            for r in list(rec["replicas"]):
                if time.time() - r["created"] < 10.0:
                    # creation grace: a replica still cold-starting (worker
                    # fork + deserialize) must not be killed for missing a
                    # ping — that causes a perpetual kill/respawn loop
                    continue
                try:
                    ok = ray_tpu_torch.get(r["actor"].check_health.remote(),
                                     timeout=5)
                except Exception:
                    ok = False
                if not ok:
                    bad.append(r)
            if bad:
                with self._lock:
                    for r in bad:
                        if r in rec["replicas"]:
                            rec["replicas"].remove(r)
                            self._kill_replica(r)
                    self._version += 1; self._version_cv.notify_all()
                _emit("WARNING",
                      f"deployment {rec['name']!r}: {len(bad)} replica(s) "
                      f"failed health check, restarting",
                      entity_id=rec["name"], unhealthy=len(bad))

    def _reconcile_loop(self) -> None:
        last_health = 0.0
        while not self._shutdown:
            try:
                self._reconcile_once()
                if time.time() - last_health > 2.0:
                    self._health_check()
                    last_health = time.time()
            except Exception:
                pass
            time.sleep(0.1)

    def ping(self) -> str:
        return "pong"

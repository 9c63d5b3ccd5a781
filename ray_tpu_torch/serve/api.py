"""serve public API: run/start/shutdown/status/get_deployment_handle.

Port of ``ray_tpu/serve/api.py``. Two differences: ``shutdown`` has no
compiled dispatch lanes to close (the port has no compiled plane yet),
and a deployment whose replica asks for resources no node has (say
``num_gpus=1`` on a host without a card) is refused when it is deployed,
with the reservation error, where the reference leaves its replica
pending on the scheduler's infeasible queue and its requests waiting.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Union

import cloudpickle

import ray_tpu_torch

from .config import HTTPOptions
from .deployment import Application, Deployment
from .handle import DeploymentHandle
from .proxy import HTTPProxy

_controller = None
_proxy: Optional[HTTPProxy] = None
_grpc = None  # GRPCIngress when start() is given grpc_options


def start(http_options: Optional[HTTPOptions] = None,
          detached: bool = True, grpc_options=None):
    """Start the Serve instance (controller actor + HTTP proxy; with
    ``grpc_options`` also the generic gRPC ingress)."""
    global _controller, _proxy, _grpc
    if _controller is None:
        from .controller import ServeController

        # Generous concurrency: every handle/proxy parks one long-poll
        # watcher (wait_for_version) for up to ~25s, so the budget must
        # scale with watcher count — the reference LongPollHost is async
        # for the same reason. Threads spawn lazily; idle slots are free.
        _controller = ServeController.options(
            name="SERVE_CONTROLLER", max_concurrency=256).remote()
        ray_tpu_torch.get(_controller.ping.remote())
    opts = http_options or HTTPOptions()
    if opts.proxy_location == "EveryNode":
        # proxies are per-node actors; no driver-resident proxy (the
        # reference's ProxyLocation semantics — a second head proxy would
        # just shadow the actor one on an unadvertised port). Gated on
        # the manager, not _proxy, so a failed start() can be retried.
        if _proxy_manager is None:
            _spawn_node_proxies(opts)
    elif _proxy is None:
        _proxy = HTTPProxy(_controller, opts.host, opts.port)
    if grpc_options is not None and _grpc is None:
        from .grpc_ingress import GRPCIngress

        _grpc = GRPCIngress(_controller, grpc_options.host,
                            grpc_options.port,
                            default_timeout_s=grpc_options.request_timeout_s)
    return _controller


def get_grpc_ingress():
    """The running GRPCIngress (None unless start() got grpc_options)."""
    return _grpc


_proxy_manager = None


class _ProxyManager:
    """Reconciles one ProxyActor per alive node (reference:
    _private/proxy_state.py — the controller's continuous proxy
    reconciliation, not a one-shot spawn): nodes joining later get a
    proxy on the next tick; dead/unresponsive proxies are respawned.
    Node proxies bind 0.0.0.0 so external load balancers can reach them
    on the node's address."""

    def __init__(self, controller, tick_s: float = 5.0):
        import threading

        self._controller = controller
        self._proxies: dict = {}  # node_id -> actor handle
        self._tick_s = tick_s
        self._stop = threading.Event()
        # one reconcile at a time: the ticker and direct callers must not
        # double-spawn a node's proxy; shutdown excludes reconciles too
        self._lock = threading.Lock()
        try:
            self.reconcile(raise_on_error=True)  # first pass fails loudly
        except BaseException:
            # don't leak the proxies that DID spawn: a retried start()
            # would stack a second set beside the orphans
            for a in self._proxies.values():
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
            self._proxies.clear()
            raise
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-proxy-reconciler")
        self._thread.start()

    def _spawn(self, node_id: str):
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)

        from .proxy import ProxyActor

        cls = ray_tpu_torch.remote(ProxyActor)
        a = cls.options(
            num_cpus=0,
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=node_id, soft=False)).remote(
            self._controller, "0.0.0.0", 0)
        if not ray_tpu_torch.get(a.ready.remote(), timeout=30):
            ray_tpu_torch.kill(a)
            raise RuntimeError(
                f"proxy on node {node_id} failed to bind (server thread "
                f"died during startup)")
        return a

    def reconcile(self, raise_on_error: bool = False) -> None:
        import logging

        log = logging.getLogger("ray_tpu_torch.serve")
        with self._lock:
            if self._stop.is_set():
                return
            alive = {n["NodeID"] for n in ray_tpu_torch.nodes()
                     if n.get("Alive")}
            for nid, a in list(self._proxies.items()):
                dead = nid not in alive
                if not dead:
                    try:
                        ray_tpu_torch.get(a.ready.remote(), timeout=10)
                    except Exception:
                        dead = True
                if dead:
                    self._proxies.pop(nid, None)
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:
                        pass
            errors = []
            for nid in alive - set(self._proxies):
                # one bad node must not starve the others of proxies
                try:
                    self._proxies[nid] = self._spawn(nid)
                except Exception as e:  # noqa: BLE001
                    errors.append((nid, e))
                    log.warning("proxy spawn failed on node %s "
                                "(next tick retries): %r", nid, e)
            if errors and raise_on_error:
                raise RuntimeError(
                    f"proxy spawn failed on {len(errors)} node(s): "
                    f"{errors[0][1]!r}")

    def _loop(self) -> None:
        import logging

        log = logging.getLogger("ray_tpu_torch.serve")
        while not self._stop.wait(self._tick_s):
            try:
                self.reconcile()
            except Exception as e:  # noqa: BLE001
                log.warning("proxy reconcile failed (retrying): %r", e)

    def addresses(self) -> list:
        out = []
        for nid, a in list(self._proxies.items()):
            try:
                out.append(ray_tpu_torch.get(a.address.remote(), timeout=10))
            except Exception:
                pass  # next reconcile respawns it
        return out

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=15)  # no reconcile may outlive shutdown
        with self._lock:
            proxies, self._proxies = dict(self._proxies), {}
        for a in proxies.values():
            try:
                ray_tpu_torch.get(a.shutdown.remote(), timeout=5)
            except Exception:
                pass
            finally:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass


def _spawn_node_proxies(opts) -> None:
    global _proxy_manager
    if _proxy_manager is None:
        _proxy_manager = _ProxyManager(_controller)


def get_proxy_addresses():
    """[{node_id, host, port}] — per-node proxies under EveryNode (one
    entry per node, keyed by real node id), else the head proxy."""
    if _proxy_manager is not None:
        return _proxy_manager.addresses()
    if _proxy is not None:
        ctx = ray_tpu_torch.get_runtime_context()
        return [{"node_id": ctx.get_node_id(), "host": _proxy.host,
                 "port": _proxy.port}]
    return []


def _deploy_one(app_or_dep, route_prefix: Optional[str],
                name_prefix: str = "") -> str:
    """Deploy an Application (and its dependencies); returns the
    ingress deployment name."""
    controller = _controller
    if isinstance(app_or_dep, Deployment):
        app = app_or_dep.bind()
    else:
        app = app_or_dep

    # deploy dependencies first, bottom-up; replace bound children with
    # handles in the parent's init args
    def resolve(node: Application) -> str:
        args = []
        for a in node.args:
            if isinstance(a, Application):
                child = resolve(a)
                args.append(DeploymentHandle(controller, child))
            else:
                args.append(a)
        kwargs = {}
        for k, v in node.kwargs.items():
            if isinstance(v, Application):
                child = resolve(v)
                kwargs[k] = DeploymentHandle(controller, child)
            else:
                kwargs[k] = v
        dep = node.deployment
        cfg = dep.config_dict()
        if node is app:
            cfg["route_prefix"] = (route_prefix
                                   if route_prefix is not None
                                   else cfg.get("route_prefix") or "/")
        else:
            cfg["route_prefix"] = None
        name = name_prefix + dep.name
        _refuse_infeasible(name, cfg)
        ray_tpu_torch.get(controller.deploy.remote(
            name, cloudpickle.dumps(dep.func_or_class),
            tuple(args), kwargs, cfg))
        return name

    return resolve(app)


def _refuse_infeasible(name: str, cfg: dict) -> None:
    """Raise PlacementGroupError when no alive node's total resources can
    ever hold one replica of ``name`` (the scheduler's own infeasibility
    rule, ``core/scheduler.py:_infeasible_locked``)."""
    from ray_tpu_torch.core.resources import parse_task_resources

    opts = cfg.get("ray_actor_options") or {}
    ask = {k: v for k, v in parse_task_resources(
        num_cpus=opts.get("num_cpus"), num_tpus=opts.get("num_tpus"),
        num_gpus=opts.get("num_gpus"), resources=opts.get("resources"),
        memory=opts.get("memory"), default_num_cpus=0.0,
    ).to_dict().items() if v > 0}
    totals = [n["Resources"] for n in ray_tpu_torch.nodes() if n["Alive"]]
    if ask and not any(all(t.get(k, 0) >= v for k, v in ask.items())
                       for t in totals):
        raise ray_tpu_torch.PlacementGroupError(
            f"cannot reserve 1 x {ask} for a replica of deployment "
            f"{name!r}: no node has it (nodes: {totals})")


def run(target, *,
        name: str = "default", route_prefix: Optional[str] = "/",
        blocking: bool = False,
        _wait_timeout: float = 30.0) -> DeploymentHandle:
    """Deploy an application (or a deployment graph) and return a handle
    to its ingress."""
    from .dag import DAGNode

    start()
    if isinstance(target, DAGNode):
        ingress = _deploy_graph(target, route_prefix,
                                wait_timeout=_wait_timeout)
    else:
        ingress = _deploy_one(target, route_prefix)
    deadline = time.time() + _wait_timeout
    while time.time() < deadline:
        if ray_tpu_torch.get(_controller.deployment_ready.remote(ingress)):
            break
        time.sleep(0.05)
    handle = DeploymentHandle(_controller, ingress)
    if blocking:  # pragma: no cover - interactive use
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return handle


def _deploy_graph(output, route_prefix: Optional[str],
                  wait_timeout: float = 30.0) -> str:
    """Compile + deploy a call-DAG (reference:
    _private/deployment_graph_build.py). Atomic property: every stage is
    deployed AND ready before the ingress (the route flip) deploys, so
    requests never enter a half-updated pipeline."""
    from .dag import build_graph_app

    stage_apps, make_ingress = build_graph_app(output)
    handles: Dict[str, DeploymentHandle] = {}
    for stage_name, app in stage_apps.items():
        dep = app.deployment.options(name=stage_name)
        _deploy_one(Application(dep, app.args, app.kwargs), None)
        handles[stage_name] = DeploymentHandle(_controller, stage_name)
    deadline = time.time() + wait_timeout
    for stage_name in stage_apps:
        while not ray_tpu_torch.get(
                _controller.deployment_ready.remote(stage_name)):
            if time.time() >= deadline:
                # Never flip the route onto a half-ready pipeline: the
                # atomic-deploy property means a slow stage aborts the
                # ingress deploy — and tears down the stages already
                # deployed so failed graph deploys don't leak replicas.
                for s in stage_apps:
                    try:
                        ray_tpu_torch.get(
                            _controller.delete_deployment.remote(s))
                    except Exception:
                        pass
                raise TimeoutError(
                    f"deployment graph stage {stage_name!r} not ready "
                    f"within {wait_timeout}s; ingress not deployed and "
                    f"all graph stages torn down")
            time.sleep(0.05)
    return _deploy_one(make_ingress(handles), route_prefix)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    if _controller is None:
        raise RuntimeError("serve is not running")
    return DeploymentHandle(_controller, deployment_name)


def status() -> Dict[str, Any]:
    """Per-deployment state + request-path aggregates. Beyond the
    replica/target/version fields, each deployment carries ``latency_ms``
    (p50/p95/p99/avg end-to-end), ``requests``/``errors``/``timeouts``
    counts, ``error_rate``, and summed replica ``queue_depth`` — computed
    from the head's merged metrics registry (serve/observability.py)."""
    if _controller is None:
        return {}
    st = ray_tpu_torch.get(_controller.list_deployments.remote())
    try:
        from .observability import serve_stats

        stats = serve_stats()
        for name, rec in st.items():
            if name in stats:
                rec.update(stats[name])
    except Exception:
        pass  # aggregates are best-effort; deployment state is not
    return st


def delete(name: str) -> None:
    if _controller is not None:
        ray_tpu_torch.get(_controller.delete_deployment.remote(name))


def shutdown() -> None:
    global _controller, _proxy, _grpc, _proxy_manager
    if _grpc is not None:
        _grpc.shutdown()
        _grpc = None
    if _proxy_manager is not None:
        _proxy_manager.shutdown()
        _proxy_manager = None
    if _proxy is not None:
        _proxy.shutdown()
        _proxy = None
    if _controller is not None:
        try:
            ray_tpu_torch.get(_controller.shutdown.remote(), timeout=10)
            ray_tpu_torch.kill(_controller)
        except Exception:
            pass
        _controller = None

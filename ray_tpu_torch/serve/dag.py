"""Serve deployment graphs: InputNode / method-call .bind() DSL.

Reference: python/ray/serve/dag.py + _private/deployment_graph_build.py —
model composition authored as a call DAG over bound deployments, compiled
into per-stage deployments plus a generated ingress (the DAGDriver) that
executes the graph per request through deployment handles.

Authoring:

    with InputNode() as inp:
        emb = Embedder.bind()                 # Application (instance)
        cls = Classifier.bind()
        out = cls.classify.bind(emb.embed.bind(inp))
    handle = serve.run(out)

Compilation (``build_graph_app``): every distinct bound deployment
becomes one deployment; the call DAG becomes an execution plan shipped to
a generated ingress deployment. Stages deploy bottom-up and the ingress
(route flip) deploys only after every stage is ready — the atomic-deploy
property: requests never route into a half-updated pipeline. Stage
handles use the normal long-poll discovery, so rolling updates of one
stage swap replicas under live traffic.

Per request, the driver launches each call node as soon as its inputs
resolve and materializes results lazily — parallel branches of a diamond
overlap instead of serializing.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from .deployment import Application, Deployment


class InputNode:
    """Placeholder for the request payload (reference: serve InputNode)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __repr__(self) -> str:
        return "InputNode()"


class DAGNode:
    """One method call on a bound deployment (reference: dag.py
    DeploymentMethodNode)."""

    def __init__(self, app: Application, method: str, args: Tuple,
                 kwargs: Dict[str, Any]):
        self.app = app
        self.method = method
        self.args = args
        self.kwargs = kwargs

    def __repr__(self) -> str:
        return f"DAGNode({self.app.deployment.name}.{self.method})"

    # nested chaining: a DAGNode's result can feed another .bind()
    def __getattr__(self, name: str):
        raise AttributeError(
            f"DAGNode has no attribute {name!r}; chain calls by passing "
            f"this node as an argument to another method .bind()")


class _MethodBinder:
    def __init__(self, app: Application, method: str):
        self._app = app
        self._method = method

    def bind(self, *args, **kwargs) -> DAGNode:
        return DAGNode(self._app, self._method, args, kwargs)


def _app_getattr(self: Application, name: str):
    # Scope the DSL: only names resolvable as methods of the deployed
    # class become binders — a typo raises AttributeError like any other
    # object, and hasattr(app, x) stays meaningful. Classes that resolve
    # methods dynamically (__getattr__ delegation) are accepted as-is;
    # methods assigned on the instance in __init__ are invisible here —
    # use the explicit ``app.bind_method(name)`` escape hatch for those.
    if name.startswith("_"):
        raise AttributeError(name)
    target = getattr(self.deployment, "_target", None)
    if isinstance(target, type):
        if callable(getattr(target, name, None)):
            return _MethodBinder(self, name)
        if hasattr(target, "__getattr__"):  # dynamic method resolution
            return _MethodBinder(self, name)
    raise AttributeError(
        f"{type(self).__name__} has no attribute {name!r} (graph "
        f"authoring exposes methods of "
        f"{getattr(target, '__name__', target)!r}; for methods assigned "
        f"on the instance use app.bind_method({name!r}))")


def _app_bind_method(self: Application, name: str) -> _MethodBinder:
    """Explicit binder for methods the class resolves only at runtime
    (e.g. assigned in __init__): ``app.bind_method("embed").bind(x)``."""
    return _MethodBinder(self, name)


# graph authoring surface on Application: `app.method.bind(...)`
Application.__getattr__ = _app_getattr  # type: ignore[attr-defined]
Application.bind_method = _app_bind_method  # type: ignore[attr-defined]


class DAGDriver:
    """Generated ingress executing the compiled plan per request.

    ``plan`` entries: (node_id, stage_key, method, arg_spec) in topo
    order; arg_spec items are ("input",) | ("node", node_id) |
    ("value", constant). ``handles``: stage_key -> DeploymentHandle
    (long-poll-discovering, so stage rolling updates are transparent).
    """

    def __init__(self, plan: List[tuple], handles: Dict[str, Any],
                 output_id: int):
        self._plan = plan
        self._handles = handles
        self._output = output_id

    def __call__(self, request=None):
        responses: Dict[int, Any] = {}

        def materialize(v):
            # DeploymentResponse resolves lazily (parallel branches of a
            # diamond overlap; a consumer blocks only on ITS inputs)
            return v.result() if hasattr(v, "result") else v

        for node_id, stage, method, arg_spec, kw_spec in self._plan:
            args = []
            for item in arg_spec:
                kind = item[0]
                if kind == "input":
                    args.append(request)
                elif kind == "node":
                    args.append(materialize(responses[item[1]]))
                else:
                    args.append(item[1])
            kwargs = {}
            for k, item in kw_spec.items():
                kind = item[0]
                if kind == "input":
                    kwargs[k] = request
                elif kind == "node":
                    kwargs[k] = materialize(responses[item[1]])
                else:
                    kwargs[k] = item[1]
            h = self._handles[stage].options(method_name=method)
            responses[node_id] = h.remote(*args, **kwargs)
        return materialize(responses[self._output])


def _collect(node, apps: Dict[int, Application],
             nodes: List[DAGNode], seen: set) -> None:
    if isinstance(node, DAGNode):
        if id(node) in seen:
            return
        seen.add(id(node))
        for a in list(node.args) + list(node.kwargs.values()):
            _collect(a, apps, nodes, seen)
        apps.setdefault(id(node.app), node.app)
        nodes.append(node)  # post-order = topological
    elif isinstance(node, Application):
        apps.setdefault(id(node), node)


def build_graph_app(output: DAGNode, *, driver_name: str = "DAGDriver"):
    """Compile a call DAG into (stage_apps, make_ingress) where
    ``stage_apps`` maps stage name -> Application to deploy and
    ``make_ingress(handles)`` returns the ingress Application bound to
    the stage handles. Used by serve.run for graph targets."""
    apps: Dict[int, Application] = {}
    nodes: List[DAGNode] = []
    _collect(output, apps, nodes, set())
    if not nodes:
        raise ValueError("deployment graph has no call nodes")

    # distinct bound deployments -> stage names (disambiguate duplicates)
    stage_names: Dict[int, str] = {}
    used: Dict[str, int] = {}
    for app_id, app in apps.items():
        base = app.deployment.name
        n = used.get(base, 0)
        used[base] = n + 1
        stage_names[app_id] = base if n == 0 else f"{base}_{n}"

    node_ids = {id(n): i for i, n in enumerate(nodes)}

    def spec_of(v):
        if isinstance(v, InputNode):
            return ("input",)
        if isinstance(v, DAGNode):
            return ("node", node_ids[id(v)])
        if isinstance(v, Application):
            raise TypeError(
                "pass Applications to __init__ composition (bind args), "
                "not as call arguments; call a method on it instead")
        return ("value", v)

    plan = []
    for i, n in enumerate(nodes):
        plan.append((i, stage_names[id(n.app)], n.method,
                     [spec_of(a) for a in n.args],
                     {k: spec_of(v) for k, v in n.kwargs.items()}))

    stage_apps = {stage_names[aid]: app for aid, app in apps.items()}

    def make_ingress(handles: Dict[str, Any]) -> Application:
        dep = Deployment(DAGDriver, driver_name)
        return dep.bind(plan, handles, node_ids[id(output)])

    return stage_apps, make_ingress

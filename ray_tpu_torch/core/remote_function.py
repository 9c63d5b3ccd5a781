"""@remote functions.

Analog of ``python/ray/remote_function.py`` in the reference: wraps a Python
function, registers its cloudpickle payload in the GCS function table once
(reference: function_manager.py export), and turns ``.remote(...)`` calls into
TaskSpec submissions. Small args are inlined into the spec; args above the
inline threshold are promoted to the object store and passed by reference
(reference: core_worker.cc:2166 + max_direct_call_object_size).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from . import serialization
from .config import global_config
from .ids import ObjectID, TaskID
from .object_ref import ObjectRef
from .resources import parse_task_resources
from .task_spec import SchedulingStrategy, TaskSpec


def _function_id(payload: bytes) -> str:
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


def prepare_args(runtime, args, kwargs) -> Tuple[list, dict, List[ObjectRef]]:
    """Returns (args, kwargs, keepalive). ``keepalive`` holds the ObjectRefs
    of promoted large args — the caller must keep it alive until after
    submission, when the head pins them via spec.pinned_args (otherwise GC
    could delete the object between put and submit)."""
    cfg = global_config()
    keepalive: List[ObjectRef] = []

    def conv(a):
        if isinstance(a, ObjectRef):
            keepalive.append(a)  # pin user refs too: the caller may drop
            return ("ref", a.id)  # theirs while the task is still pending
        s = serialization.serialize(a)
        if s.total_bytes > cfg.max_direct_call_object_size:
            ref = runtime.put(a)
            keepalive.append(ref)
            return ("ref", ref.id)
        return ("v", s.to_bytes())

    out_args = [conv(a) for a in args]
    out_kwargs = {k: conv(v) for k, v in kwargs.items()}
    return out_args, out_kwargs, keepalive


def resolve_scheduling_strategy(strategy) -> SchedulingStrategy:
    if strategy is None or strategy == "DEFAULT":
        return SchedulingStrategy("DEFAULT")
    if strategy == "SPREAD":
        return SchedulingStrategy("SPREAD")
    if isinstance(strategy, SchedulingStrategy):
        return strategy
    # duck-typed public strategies from util.scheduling_strategies
    kind = type(strategy).__name__
    if kind == "NodeAffinitySchedulingStrategy":
        nid = strategy.node_id
        return SchedulingStrategy("NODE_AFFINITY",
                                  node_id=nid if isinstance(nid, str) else nid,
                                  soft=strategy.soft)
    if kind == "PlacementGroupSchedulingStrategy":
        pg = strategy.placement_group
        return SchedulingStrategy(
            "PLACEMENT_GROUP",
            placement_group_id=pg.id,
            bundle_index=strategy.placement_group_bundle_index
            if strategy.placement_group_bundle_index is not None else -1,
            capture_child_tasks=strategy.placement_group_capture_child_tasks or False,
        )
    raise ValueError(f"unsupported scheduling strategy {strategy!r}")


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        # Pickling is deferred to first .remote(): at decoration time the
        # defining module may still be mid-import, which would force
        # cloudpickle to capture by value with an incomplete globals dict
        # (later-defined helpers would raise NameError on the worker).
        self._payload: Optional[bytes] = None
        self._function_id: Optional[str] = None
        self._registered_with = None
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def _materialize_payload(self) -> None:
        if self._payload is None:
            self._payload = cloudpickle.dumps(self._fn)
            self._function_id = _function_id(self._payload)

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(overrides)
        clone = RemoteFunction.__new__(RemoteFunction)
        clone._fn = self._fn
        clone._options = merged
        clone._payload = self._payload
        clone._function_id = self._function_id
        clone._registered_with = self._registered_with
        clone.__name__ = self.__name__
        clone.__doc__ = self.__doc__
        return clone

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self.__name__}() cannot be called directly; "
            f"use {self.__name__}.remote()."
        )

    def __getstate__(self):
        # picklable across processes/storage: drop the runtime binding
        # (re-registers lazily on the other side)
        d = self.__dict__.copy()
        d["_registered_with"] = None
        return d

    def bind(self, *args, **kwargs):
        """Author a task-DAG node for workflows (reference: dag_node.py
        bind / workflow DAG authoring)."""
        from ray_tpu_torch.workflow.api import FunctionNode

        return FunctionNode(self, args, kwargs)

    def _ensure_registered(self, runtime) -> None:
        self._materialize_payload()
        if self._registered_with is not runtime:
            runtime.register_function(self._function_id, self._payload)
            self._registered_with = runtime

    def remote(self, *args, **kwargs):
        from .runtime import get_current_runtime

        runtime = get_current_runtime()
        if runtime is None:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        self._ensure_registered(runtime)
        opt = self._options
        out_args, out_kwargs, keepalive = prepare_args(runtime, args, kwargs)
        from .runtime_env import pack_runtime_env

        runtime_env = pack_runtime_env(opt.get("runtime_env"), runtime)
        num_returns = opt.get("num_returns", 1)
        streaming = num_returns in ("streaming", "dynamic")
        if streaming:
            num_returns = 1  # primary return carries the final item count
        spec = TaskSpec(
            task_id=runtime.next_task_id(),
            job_id=runtime.runtime_context()["job_id"],
            function_id=self._function_id,
            function_name=self.__name__,
            args=out_args,
            kwargs=out_kwargs,
            num_returns=num_returns,
            streaming=streaming,
            resources=parse_task_resources(
                num_cpus=opt.get("num_cpus"),
                num_tpus=opt.get("num_tpus"),
                num_gpus=opt.get("num_gpus"),
                resources=opt.get("resources"),
                memory=opt.get("memory"),
                default_num_cpus=1.0,
            ),
            max_retries=opt.get("max_retries", 3),
            retry_exceptions=bool(opt.get("retry_exceptions", False)),
            scheduling_strategy=resolve_scheduling_strategy(
                opt.get("scheduling_strategy")),
            runtime_env=runtime_env,
            pinned_args=[r.id for r in keepalive],
        )
        # explicit soft-locality hint (e.g. the data executor dispatching a
        # map task to the node holding its input block); the head's
        # arg-size inference only runs when this is unset
        loc = opt.get("locality_hex")
        if loc is not None:
            spec.locality_hex = loc
        from ray_tpu_torch.util.tracing import current_context

        spec.trace_ctx = current_context()
        refs = runtime.submit_task(spec)
        if streaming:
            from .object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, refs[0])
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs

"""Actor API: @remote classes, handles, method calls.

Analog of ``python/ray/actor.py`` in the reference: ``ActorClass.remote()``
registers the class payload, submits an actor-creation task (scheduled with
the actor's lifetime resources — reference: gcs_actor_scheduler), and returns
a serializable ``ActorHandle``. Method calls become ordered actor tasks routed
directly to the actor's dedicated worker (reference:
transport/actor_task_submitter.cc; ordering preserved by the FIFO channel).
Supports named/detached actors, max_restarts/max_task_retries fault
tolerance, max_concurrency thread pools, and asyncio actors.
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Any, Dict, Optional

import cloudpickle

from .ids import ActorID
from .remote_function import prepare_args, resolve_scheduling_strategy
from .runtime_env import pack_runtime_env
from .resources import parse_task_resources
from .task_spec import TaskSpec


def _class_id(payload: bytes) -> str:
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, **overrides) -> "ActorMethod":
        m = ActorMethod(self._handle, self._name,
                        overrides.get("num_returns", self._num_returns))
        return m

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(self._name, args, kwargs,
                                           self._num_returns)

    def bind(self, *args):
        """Author a compiled-graph node (reference: dag_node.py bind)."""
        from ray_tpu_torch.dag import _bind

        return _bind(self, *args)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._name}() cannot be called directly; "
            f"use .{self._name}.remote()."
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str,
                 method_num_returns: Optional[Dict[str, int]] = None,
                 max_task_retries: int = 0):
        object.__setattr__(self, "_actor_id", actor_id)
        object.__setattr__(self, "_class_name", class_name)
        object.__setattr__(self, "_method_num_returns", method_num_returns or {})
        object.__setattr__(self, "_max_task_retries", max_task_retries)

    def __getattr__(self, name: str):
        if (name.startswith("__") and name.endswith("__")
                and name not in ("__ray_terminate__", "__collective_init__",
                                 "__compiled_exec__", "__compiled_setup__",
                                 "__compiled_poison__")):
            raise AttributeError(name)
        return ActorMethod(self, name, self._method_num_returns.get(name, 1))

    def _submit_method(self, method_name: str, args, kwargs, num_returns):
        from .runtime import get_current_runtime

        runtime = get_current_runtime()
        if runtime is None:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        streaming = num_returns in ("streaming", "dynamic")
        if streaming:
            num_returns = 1
        out_args, out_kwargs, keepalive = prepare_args(runtime, args, kwargs)
        spec = TaskSpec(
            task_id=runtime.next_task_id(),
            job_id=runtime.runtime_context()["job_id"],
            function_id="",
            function_name=f"{self._class_name}.{method_name}",
            args=out_args,
            kwargs=out_kwargs,
            num_returns=num_returns,
            streaming=streaming,
            resources=parse_task_resources(num_cpus=0, default_num_cpus=0.0),
            # actor-task retries follow the actor's max_task_retries
            # (reference: ray_option_utils max_task_retries semantics)
            max_retries=self._max_task_retries,
            actor_id=self._actor_id,
            pinned_args=[r.id for r in keepalive],
        )
        from ray_tpu_torch.util.tracing import current_context

        spec.trace_ctx = current_context()
        refs = runtime.actor_method_call(spec)
        if streaming:
            from .object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, refs[0])
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._method_num_returns,
                              self._max_task_retries))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        # deferred to first .remote() — see RemoteFunction.__init__ for why
        self._payload: Optional[bytes] = None
        self._class_id: Optional[str] = None
        self._registered_with = None
        self.__name__ = cls.__name__
        # async actor iff any public method is a coroutine function
        self._is_async = any(
            asyncio.iscoroutinefunction(getattr(cls, m))
            for m in dir(cls)
            if not m.startswith("_") and callable(getattr(cls, m, None))
        )
        self._method_num_returns = {
            m: getattr(getattr(cls, m), "__ray_num_returns__")
            for m in dir(cls)
            if hasattr(getattr(cls, m, None), "__ray_num_returns__")
        }

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._options)
        merged.update(overrides)
        clone = ActorClass.__new__(ActorClass)
        clone.__dict__.update(self.__dict__)
        clone._options = merged
        return clone

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()."
        )

    def remote(self, *args, **kwargs) -> ActorHandle:
        from .runtime import get_current_runtime
        import pickle

        runtime = get_current_runtime()
        if runtime is None:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        if self._payload is None:
            self._payload = cloudpickle.dumps(self._cls)
            self._class_id = _class_id(self._payload)
        if self._registered_with is not runtime:
            runtime.register_function(self._class_id, self._payload)
            self._registered_with = runtime
        opt = self._options
        actor_id = ActorID.from_random()
        out_args, out_kwargs, keepalive = prepare_args(runtime, args, kwargs)
        explicit_cpus = opt.get("num_cpus")
        num_cpus = explicit_cpus
        if num_cpus is None:
            # reference semantics (ray_option_utils actor defaults): 1 CPU
            # to *schedule* the creation, 0 CPUs held while alive — the
            # implicit CPU is returned once __init__ succeeds (see
            # retained_resources below)
            num_cpus = 1 if not (opt.get("num_tpus") or opt.get("num_gpus")
                                 or opt.get("resources")) else 0
        spec = TaskSpec(
            task_id=runtime.next_task_id(),
            job_id=runtime.runtime_context()["job_id"],
            function_id=self._class_id,
            function_name=f"{self.__name__}.__init__",
            args=out_args,
            kwargs=out_kwargs,
            num_returns=1,
            resources=parse_task_resources(
                num_cpus=num_cpus,
                num_tpus=opt.get("num_tpus"),
                num_gpus=opt.get("num_gpus"),
                resources=opt.get("resources"),
                memory=opt.get("memory"),
                default_num_cpus=1.0,
            ),
            # lifetime reservation: only EXPLICIT asks persist — the
            # implicit scheduling CPU returns after creation
            retained_resources=parse_task_resources(
                num_cpus=explicit_cpus if explicit_cpus is not None else 0,
                num_tpus=opt.get("num_tpus"),
                num_gpus=opt.get("num_gpus"),
                resources=opt.get("resources"),
                memory=opt.get("memory"),
                default_num_cpus=0.0,
            ),
            max_retries=0,
            scheduling_strategy=resolve_scheduling_strategy(
                opt.get("scheduling_strategy")),
            runtime_env=pack_runtime_env(opt.get("runtime_env"), runtime),
            actor_id=actor_id,
            is_actor_creation=True,
            actor_max_concurrency=opt.get("max_concurrency", 1),
            actor_is_async=self._is_async,
            pinned_args=[r.id for r in keepalive],
        )
        name = opt.get("name")
        namespace = opt.get("namespace", "default")
        max_restarts = opt.get("max_restarts", 0)
        detached = opt.get("lifetime") == "detached"
        max_task_retries = opt.get("max_task_retries", 0)
        if hasattr(runtime, "create_actor_record"):
            runtime.create_actor_record(spec, name, namespace, max_restarts,
                                        detached, max_task_retries)
        else:
            runtime.rpc.call(
                "rpc", "create_actor",
                pickle.dumps((spec, name, namespace, max_restarts, detached,
                              max_task_retries)))
        return ActorHandle(actor_id, self.__name__, self._method_num_returns,
                           max_task_retries)


def method(num_returns: int = 1):
    """Decorator for actor methods with multiple returns (reference:
    python/ray/actor.py ``@ray.method``)."""

    def deco(fn):
        fn.__ray_num_returns__ = num_returns
        return fn

    return deco

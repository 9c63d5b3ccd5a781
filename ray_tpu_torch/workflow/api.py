"""Workflow DAG authoring + durable execution engine (port of
``ray_tpu/workflow/api.py``).

Reference shape: python/ray/workflow/api.py (run/run_async/resume/
get_output/list_all/cancel/delete), workflow_executor.py (step loop),
step ids + object checkpoints under a storage root
(workflow_storage.py). Engine differences here: steps run as ordinary
ray_tpu_torch tasks with driver-side orchestration (submit-ready/wait/commit),
checkpoints are files under ``<storage>/<workflow_id>/steps/``, and the
DAG itself is cloudpickled at first run so ``resume()`` needs no user code.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch

import cloudpickle


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    RESUMABLE = "RESUMABLE"
    CANCELED = "CANCELED"
    PENDING = "PENDING"


_default_storage: Optional[str] = None
_running: Dict[str, "_Execution"] = {}
_lock = threading.Lock()


def init(storage: Optional[str] = None) -> None:
    """Set the workflow storage root (reference: workflow.init)."""
    global _default_storage
    if storage:
        _default_storage = os.path.abspath(storage)


def _storage_root() -> str:
    root = (_default_storage
            or os.environ.get("RAY_TPU_WORKFLOW_STORAGE")
            or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_workflows"))
    os.makedirs(root, exist_ok=True)
    return root


# --------------------------------------------------------------------------- #
# DAG authoring
# --------------------------------------------------------------------------- #


class FunctionNode:
    """A task node in a workflow DAG, authored via ``fn.bind(*args)``.

    The node id is derived from the function name + the structure of its
    arguments (upstream nodes contribute their ids), so re-building the
    same DAG in a fresh process yields the same ids — the property resume
    relies on.
    """

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict[str, Any],
                 step_options: Optional[Dict[str, Any]] = None):
        self._fn = remote_fn
        self._args = args
        self._kwargs = kwargs
        self._options = dict(step_options or {})
        self._id = self._derive_id()

    def _derive_id(self) -> str:
        import pickle

        def sig(a):
            if isinstance(a, FunctionNode):
                return b"node:" + a._id.encode()
            # full-content hash (repr would truncate/elide, silently
            # collapsing distinct steps into one node id)
            try:
                return b"val:" + pickle.dumps(a)
            except Exception:
                try:
                    return b"val:" + cloudpickle.dumps(a)
                except Exception:
                    return b"val:" + repr(a).encode()

        h = hashlib.sha1()
        h.update(getattr(self._fn, "__name__", "fn").encode())
        for a in self._args:
            h.update(sig(a))
        for k in sorted(self._kwargs):
            h.update(k.encode())
            h.update(sig(self._kwargs[k]))
        return (f"{getattr(self._fn, '__name__', 'fn')}_"
                f"{h.hexdigest()[:10]}")

    def options(self, **overrides) -> "FunctionNode":
        return FunctionNode(self._fn, self._args, self._kwargs,
                            {**self._options, **overrides})

    def upstream(self) -> List["FunctionNode"]:
        out = []
        for a in list(self._args) + list(self._kwargs.values()):
            if isinstance(a, FunctionNode):
                out.append(a)
        return out

    def execute_eager(self):
        """Run the whole sub-DAG without durability (testing aid)."""
        args = [a.execute_eager() if isinstance(a, FunctionNode) else a
                for a in self._args]
        kwargs = {k: (v.execute_eager() if isinstance(v, FunctionNode)
                      else v) for k, v in self._kwargs.items()}
        return ray_tpu_torch.get(self._fn.remote(*args, **kwargs))

    def __repr__(self):
        return f"FunctionNode({self._id})"


@dataclass
class Continuation:
    """Returned by a step to hand the workflow off to another DAG."""

    node: FunctionNode


def continuation(node: FunctionNode) -> Continuation:
    return Continuation(node)


def bind(remote_fn, *args, **kwargs) -> FunctionNode:
    return FunctionNode(remote_fn, args, kwargs)


# --------------------------------------------------------------------------- #
# Events (reference: workflow/api.py wait_for_event + EventListener)
# --------------------------------------------------------------------------- #


class EventListener:
    """Subclass and implement poll_for_event(); the workflow step blocks
    (as an ordinary task) until it returns. Reference:
    python/ray/workflow/event_listener.py — the async listener contract,
    here a sync poll since steps are plain tasks."""

    def poll_for_event(self, *args, **kwargs):
        raise NotImplementedError


class TimerListener(EventListener):
    """Fires after N seconds (reference: workflow.sleep's listener)."""

    def poll_for_event(self, seconds: float):
        import time as _t

        _t.sleep(seconds)
        return seconds


def wait_for_event(listener_cls, *args, **kwargs) -> FunctionNode:
    """A DAG node that completes when the listener observes its event.

    Like any step, the observed event value is CHECKPOINTED: a resumed
    workflow does not wait again for an event it already saw.
    """
    if not (isinstance(listener_cls, type)
            and issubclass(listener_cls, EventListener)):
        raise TypeError("wait_for_event expects an EventListener subclass")

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _wait_for_event(*a, **kw):
        return listener_cls().poll_for_event(*a, **kw)

    _wait_for_event.__name__ = f"event_{listener_cls.__name__}"
    return FunctionNode(_wait_for_event, args, kwargs)


def sleep(seconds: float) -> FunctionNode:
    """Durable sleep step (reference: workflow.sleep) — checkpointed, so
    a resume after the timer fired does not sleep again."""
    return wait_for_event(TimerListener, seconds)


# --------------------------------------------------------------------------- #
# Storage layout
# --------------------------------------------------------------------------- #


class _Store:
    def __init__(self, workflow_id: str, root: Optional[str] = None,
                 create: bool = False):
        self.dir = os.path.join(root or _storage_root(), workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")
        if create:
            os.makedirs(self.steps_dir, exist_ok=True)

    def _meta_path(self):
        return os.path.join(self.dir, "meta.json")

    def write_meta(self, **updates) -> dict:
        meta = self.read_meta()
        meta.update(updates)
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path())
        return meta

    def read_meta(self) -> dict:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def save_dag(self, node: FunctionNode) -> None:
        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            f.write(cloudpickle.dumps(node))

    def load_dag(self) -> FunctionNode:
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return cloudpickle.loads(f.read())

    def step_path(self, step_id: str) -> str:
        return os.path.join(self.steps_dir, step_id + ".pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self.step_path(step_id))

    def save_step(self, step_id: str, value: Any) -> None:
        tmp = self.step_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(cloudpickle.dumps(value))
        os.replace(tmp, self.step_path(step_id))

    def load_step(self, step_id: str) -> Any:
        with open(self.step_path(step_id), "rb") as f:
            return cloudpickle.loads(f.read())

    def save_result(self, value: Any) -> None:
        with open(os.path.join(self.dir, "result.pkl"), "wb") as f:
            f.write(cloudpickle.dumps(value))

    def load_result(self) -> Any:
        with open(os.path.join(self.dir, "result.pkl"), "rb") as f:
            return cloudpickle.loads(f.read())


# --------------------------------------------------------------------------- #
# Execution engine
# --------------------------------------------------------------------------- #


class _Execution:
    def __init__(self, workflow_id: str, store: _Store):
        self.workflow_id = workflow_id
        self.store = store
        self.cancel_event = threading.Event()

    def run_dag(self, root: FunctionNode, id_prefix: str = "") -> Any:
        """Execute a DAG; returns the root node's (continuation-resolved)
        value. Steps whose checkpoint exists are loaded, not re-run."""
        # collect nodes (topological via DFS) and dependency edges
        nodes: Dict[str, FunctionNode] = {}
        order: List[str] = []

        def visit(n: FunctionNode):
            nid = id_prefix + n._id
            if nid in nodes:
                return
            nodes[nid] = n
            for up in n.upstream():
                visit(up)
            order.append(nid)

        visit(root)
        done: Dict[str, Any] = {}
        inflight: Dict[Any, str] = {}  # ObjectRef -> node id

        def ready(nid: str) -> bool:
            n = nodes[nid]
            return all(id_prefix + u._id in done for u in n.upstream())

        def resolve_args(n: FunctionNode):
            args = [done[id_prefix + a._id] if isinstance(a, FunctionNode)
                    else a for a in n._args]
            kwargs = {k: (done[id_prefix + v._id]
                          if isinstance(v, FunctionNode) else v)
                      for k, v in n._kwargs.items()}
            return args, kwargs

        pending = [nid for nid in order]
        while pending or inflight:
            if self.cancel_event.is_set():
                raise WorkflowCanceledError(self.workflow_id)
            launched = []
            for nid in pending:
                if self.store.has_step(nid):
                    done[nid] = self.store.load_step(nid)
                    launched.append(nid)
                elif ready(nid):
                    n = nodes[nid]
                    args, kwargs = resolve_args(n)
                    opts = {k: v for k, v in n._options.items()
                            if k != "name"}
                    fn = n._fn.options(**opts) if opts else n._fn
                    ref = fn.remote(*args, **kwargs)
                    inflight[ref] = nid
                    launched.append(nid)
            pending = [nid for nid in pending if nid not in launched]
            if not inflight:
                if pending:
                    continue
                break
            ready_refs, _ = ray_tpu_torch.wait(
                list(inflight.keys()), num_returns=1, timeout=1.0)
            for ref in ready_refs:
                nid = inflight.pop(ref)
                value = ray_tpu_torch.get(ref)
                if isinstance(value, Continuation):
                    # dynamic workflow: execute the continuation sub-DAG,
                    # its result becomes this step's checkpointed value
                    value = self.run_dag(value.node, id_prefix=nid + ".")
                self.store.save_step(nid, value)
                done[nid] = value
        return done[id_prefix + root._id]


class WorkflowError(RuntimeError):
    pass


class WorkflowCanceledError(WorkflowError):
    def __init__(self, workflow_id: str):
        super().__init__(f"workflow {workflow_id} canceled")


class WorkflowNotFoundError(WorkflowError):
    pass


def _execute(workflow_id: str, store: _Store, dag: FunctionNode):
    ex = _Execution(workflow_id, store)
    with _lock:
        _running[workflow_id] = ex
    store.write_meta(status=WorkflowStatus.RUNNING, error=None,
                     started_at=time.time())
    try:
        result = ex.run_dag(dag)
        store.save_result(result)
        store.write_meta(status=WorkflowStatus.SUCCESSFUL,
                         finished_at=time.time())
        return result
    except WorkflowCanceledError:
        store.write_meta(status=WorkflowStatus.CANCELED,
                         finished_at=time.time())
        raise
    except Exception as e:  # any step failure -> resumable
        store.write_meta(status=WorkflowStatus.FAILED, error=repr(e),
                         finished_at=time.time())
        raise
    finally:
        with _lock:
            _running.pop(workflow_id, None)


# --------------------------------------------------------------------------- #
# Public API (reference: python/ray/workflow/api.py)
# --------------------------------------------------------------------------- #


def run(dag: FunctionNode, *, workflow_id: Optional[str] = None,
        storage: Optional[str] = None) -> Any:
    """Execute a workflow DAG durably; blocks for the result."""
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    store = _Store(workflow_id, storage and os.path.abspath(storage),
                   create=True)
    store.save_dag(dag)
    store.write_meta(workflow_id=workflow_id, created_at=time.time(),
                     status=WorkflowStatus.PENDING)
    return _execute(workflow_id, store, dag)


def run_async(dag: FunctionNode, *, workflow_id: Optional[str] = None,
              storage: Optional[str] = None):
    """Like :func:`run` but returns a ``concurrent.futures.Future``."""
    from concurrent.futures import Future

    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    store = _Store(workflow_id, storage and os.path.abspath(storage),
                   create=True)
    store.save_dag(dag)
    store.write_meta(workflow_id=workflow_id, created_at=time.time(),
                     status=WorkflowStatus.PENDING)
    fut: Future = Future()

    def target():
        try:
            fut.set_result(_execute(workflow_id, store, dag))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    t = threading.Thread(target=target, name=f"workflow-{workflow_id}",
                         daemon=True)
    t.start()
    return fut


def resume(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    """Re-run a FAILED/RESUMABLE/CANCELED workflow from its checkpoints."""
    store = _Store(workflow_id, storage and os.path.abspath(storage))
    meta = store.read_meta()
    if not meta:
        raise WorkflowNotFoundError(workflow_id)
    if meta.get("status") == WorkflowStatus.SUCCESSFUL:
        return store.load_result()
    dag = store.load_dag()
    return _execute(workflow_id, store, dag)


def resume_all(*, storage: Optional[str] = None) -> List[Tuple[str, Any]]:
    out = []
    for wid, status in list_all(storage=storage):
        if status in (WorkflowStatus.FAILED, WorkflowStatus.RESUMABLE,
                      WorkflowStatus.RUNNING):
            try:
                out.append((wid, resume(wid, storage=storage)))
            except Exception:
                pass
    return out


def get_output(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    store = _Store(workflow_id, storage and os.path.abspath(storage))
    meta = store.read_meta()
    if not meta:
        raise WorkflowNotFoundError(workflow_id)
    if meta.get("status") != WorkflowStatus.SUCCESSFUL:
        raise WorkflowError(
            f"workflow {workflow_id} status={meta.get('status')}")
    return store.load_result()


def get_status(workflow_id: str, *, storage: Optional[str] = None) -> str:
    store = _Store(workflow_id, storage and os.path.abspath(storage))
    meta = store.read_meta()
    if not meta:
        raise WorkflowNotFoundError(workflow_id)
    status = meta.get("status", WorkflowStatus.PENDING)
    # a FAILED workflow with checkpoints is resumable
    if status == WorkflowStatus.FAILED:
        return WorkflowStatus.RESUMABLE
    return status


def get_metadata(workflow_id: str, *, storage: Optional[str] = None) -> dict:
    store = _Store(workflow_id, storage and os.path.abspath(storage))
    meta = store.read_meta()
    if not meta:
        raise WorkflowNotFoundError(workflow_id)
    try:
        meta["completed_steps"] = len(os.listdir(store.steps_dir))
    except OSError:
        meta["completed_steps"] = 0
    return meta


def list_all(*, storage: Optional[str] = None) -> List[Tuple[str, str]]:
    root = storage and os.path.abspath(storage) or _storage_root()
    out = []
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return out
    for wid in entries:
        meta_path = os.path.join(root, wid, "meta.json")
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    out.append((wid, json.load(f).get(
                        "status", WorkflowStatus.PENDING)))
            except (OSError, ValueError):
                pass
    return out


def cancel(workflow_id: str, *, storage: Optional[str] = None) -> None:
    with _lock:
        ex = _running.get(workflow_id)
    if ex is not None:
        ex.cancel_event.set()
    else:
        store = _Store(workflow_id, storage and os.path.abspath(storage))
        if not store.read_meta():
            raise WorkflowNotFoundError(workflow_id)
        store.write_meta(status=WorkflowStatus.CANCELED)


def delete(workflow_id: str, *, storage: Optional[str] = None) -> None:
    root = storage and os.path.abspath(storage) or _storage_root()
    path = os.path.join(root, workflow_id)
    if not os.path.isdir(path):
        raise WorkflowNotFoundError(workflow_id)
    shutil.rmtree(path)

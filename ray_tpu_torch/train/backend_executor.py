"""BackendExecutor + worker group + torch backend (port of
``ray_tpu/train/backend_executor.py``).

Analog of the reference's ``train/_internal/backend_executor.py:67`` (start
:129: create placement group :213-236, spawn WorkerGroup actors, wire the
framework process group) and ``worker_group.py:102``. :class:`TorchBackend`
is the reference's torch backend (``train/torch/config.py:154
_TorchBackend`` → dist.init_process_group), where the JAX package's
``JaxBackend`` calls ``jax.distributed.initialize``: every worker joins
one ``torch.distributed`` process group, NCCL when the workers hold cards
(one each: the runtime narrows ``CUDA_VISIBLE_DEVICES`` to it), gloo on
the CPU.

Gang scheduling: one bundle per worker inside a single placement group;
worker loss tears down and recreates the whole group (SPMD programs cannot
survive partial membership — SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, set_context


def _await_dead(actors, timeout: float) -> None:
    """Wait (bounded) until the head records every actor DEAD: its
    process exited and its resources are free. A client driver, which
    has no head to ask, returns at once."""
    from ray_tpu_torch.core.runtime import get_current_runtime

    head = getattr(get_current_runtime(), "head", None)
    if head is None:
        return
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        states = [head.actor_location(a._actor_id) for a in actors]
        if all(s is None or s["state"] == "DEAD" for s in states):
            return
        time.sleep(0.05)


class Backend:
    """Framework-backend plugin interface (reference: train/backend.py:16)."""

    def on_start(self, worker_metadata: List[dict]) -> List[dict]:
        """Compute per-worker env/setup payloads before training starts."""
        return [{} for _ in worker_metadata]

    def on_shutdown(self) -> None:
        pass


class TorchBackend(Backend):
    """Wire a ``torch.distributed`` process group across the worker gang.

    Worker 0 is the master: every worker gets ``MASTER_ADDR`` (worker 0's
    IP), ``MASTER_PORT`` (a free port picked on worker 0's node),
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, and joins the group in
    :meth:`TrainWorker.setup`: NCCL when every worker was given a GPU,
    else gloo.
    """

    # seconds a collective of the group may wait for its peers
    TIMEOUT_S = 600.0

    def __init__(self, train_overrides: Optional[Dict[str, Any]] = None):
        # per-gang Config field overrides (e.g. {"train_mesh": "fsdp=4"})
        # applied on every worker before the loop starts — the per-run
        # counterpart of the cluster-wide RAY_TPU_TRAIN_* knobs the
        # Config snapshot ships
        self.train_overrides = dict(train_overrides or {})

    def on_start(self, worker_metadata: List[dict]) -> List[dict]:
        n = len(worker_metadata)
        base: Dict[str, Any] = {}
        if self.train_overrides:
            base["config_overrides"] = self.train_overrides
        backend = "nccl" if all(m.get("accelerator_ids", {}).get("GPU")
                                for m in worker_metadata) else "gloo"
        master = worker_metadata[0]
        addr, port = master.get("ip") or "127.0.0.1", master["free_port"]
        local_rank: Dict[str, int] = {}
        out = []
        for i, m in enumerate(worker_metadata):
            node = m.get("node_id", "")
            local_rank[node] = local_rank.get(node, -1) + 1
            out.append({
                **base,
                "env": {"MASTER_ADDR": addr, "MASTER_PORT": str(port),
                        "RANK": str(i), "WORLD_SIZE": str(n),
                        "LOCAL_RANK": str(local_rank[node])},
                "torch_distributed": {
                    "backend": backend, "world_size": n, "rank": i,
                    "init_method": f"tcp://{addr}:{port}",
                    "timeout_s": self.TIMEOUT_S},
            })
        return out


class TrainWorker:
    """Actor running one rank of the gang (reference: worker actors created
    by WorkerGroup; the train thread + session live here)."""

    def __init__(self, world_size: int, world_rank: int, local_rank: int,
                 node_rank: int, experiment_name: str, trial_dir: str):
        self.meta = dict(world_size=world_size, world_rank=world_rank,
                         local_rank=local_rank, node_rank=node_rank)
        self.experiment_name = experiment_name
        self.trial_dir = trial_dir
        self.ctx: Optional[TrainContext] = None
        self._thread: Optional[threading.Thread] = None
        self._done = False
        self._error: Optional[str] = None

    def get_metadata(self) -> dict:
        import socket

        ctx = ray_tpu_torch.get_runtime_context()
        # a free port on this node, for the process group's master
        with socket.socket() as sock:
            sock.bind(("", 0))
            free_port = sock.getsockname()[1]
        return {"ip": ctx.get_node_ip(), "hostname": socket.gethostname(),
                "node_id": ctx.get_node_id(),
                "accelerator_ids": ctx.get_accelerator_ids(),
                "free_port": free_port}

    def setup(self, backend_payload: dict,
              latest_checkpoint_path: Optional[str],
              dataset_shards: Optional[Dict[str, Any]]) -> bool:
        for k, v in backend_payload.get("env", {}).items():
            os.environ[k] = v
        overrides = backend_payload.get("config_overrides")
        if overrides:
            from ray_tpu_torch.core.config import global_config, set_global_config

            cfg = global_config()
            # validate the whole payload BEFORE touching the live
            # config — global_config() is the shared singleton, so a
            # mid-loop raise would leave it half-overridden
            unknown = [k for k in overrides if not hasattr(cfg, k)]
            if unknown:
                raise ValueError(f"unknown Config field(s) {unknown!r} "
                                 f"in backend config_overrides")
            for k, v in overrides.items():
                setattr(cfg, k, v)
            set_global_config(cfg)
        td = backend_payload.get("torch_distributed")
        if td is not None:
            import datetime

            import torch
            import torch.distributed as dist

            if td["backend"] == "nccl" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"worker {td['rank']} was given "
                    f"CUDA_VISIBLE_DEVICES="
                    f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r} and cannot "
                    f"open a card for NCCL")
            dist.init_process_group(
                td["backend"], init_method=td["init_method"],
                world_size=td["world_size"], rank=td["rank"],
                timeout=datetime.timedelta(seconds=td["timeout_s"]))
        ckpt = (Checkpoint(latest_checkpoint_path)
                if latest_checkpoint_path else None)
        self.ctx = TrainContext(
            world_size=self.meta["world_size"],
            world_rank=self.meta["world_rank"],
            local_rank=self.meta["local_rank"],
            local_world_size=1,
            node_rank=self.meta["node_rank"],
            experiment_name=self.experiment_name,
            latest_checkpoint=ckpt,
            dataset_shards=dataset_shards,
            trial_dir=self.trial_dir,
        )
        return True

    def start_training(self, train_fn_payload: bytes, config: dict) -> bool:
        import cloudpickle

        train_fn = cloudpickle.loads(train_fn_payload)
        set_context(self.ctx)

        def run():
            try:
                import inspect

                sig = inspect.signature(train_fn)
                if len(sig.parameters) >= 1:
                    train_fn(config)
                else:
                    train_fn()
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
            finally:
                self._done = True

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="train-loop")
        self._thread.start()
        return True

    def poll(self) -> dict:
        reports = self.ctx._drain() if self.ctx else []
        return {
            "reports": [(r.metrics, r.checkpoint_path) for r in reports],
            "done": self._done,
            "error": self._error,
        }

    def shutdown(self) -> bool:
        """Leave the process group (after the loop has ended)."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        return True


@dataclass
class WorkerGroupState:
    actors: List[Any]
    pg: Any


class BackendExecutor:
    """Drives the gang: placement group → actors → backend → train → poll.

    Reference: backend_executor.py start/start_training/pause polling,
    plus the trainer-side restart loop from base_trainer FailureConfig.
    """

    # seconds the gang's placement group may take to be reserved before
    # start() gives up with PlacementGroupError
    PLACEMENT_TIMEOUT_S = 120.0
    # how long shutdown waits for its workers' processes to be gone, so
    # fit() returns with the gang's resources back and the next gang
    # never races this one's teardown
    TEARDOWN_WAIT_S = 60.0

    def __init__(self, scaling: ScalingConfig, backend: Optional[Backend],
                 experiment_name: str, trial_dir: str):
        self.scaling = scaling
        self.backend = backend or TorchBackend()
        self.experiment_name = experiment_name
        self.trial_dir = trial_dir
        self.state: Optional[WorkerGroupState] = None
        self._finished = False

    def start(self, latest_checkpoint_path: Optional[str],
              dataset_shards_per_worker: Optional[List[Dict[str, Any]]] = None):
        n = self.scaling.num_workers
        pg = placement_group(self.scaling.bundles(),
                             strategy=self.scaling.placement_strategy)
        if not pg.ready(timeout=self.PLACEMENT_TIMEOUT_S):
            remove_placement_group(pg)
            raise ray_tpu_torch.PlacementGroupError(
                f"cannot reserve {n} x {self.scaling.worker_resources()} "
                f"(available: {ray_tpu_torch.available_resources()})")
        res = self.scaling.worker_resources()
        WorkerActor = ray_tpu_torch.remote(TrainWorker)
        actors = []
        for rank in range(n):
            strat = PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=rank)
            opts = dict(scheduling_strategy=strat,
                        num_cpus=res.get("CPU", 1))
            if "GPU" in res:
                opts["num_gpus"] = res["GPU"]
            extra = {k: v for k, v in res.items()
                     if k not in ("CPU", "TPU", "GPU")}
            if extra:
                opts["resources"] = extra
            actors.append(WorkerActor.options(**opts).remote(
                n, rank, 0, rank, self.experiment_name, self.trial_dir))
        metadata = ray_tpu_torch.get([a.get_metadata.remote() for a in actors],
                               timeout=180)
        payloads = self.backend.on_start(metadata)
        shards = dataset_shards_per_worker or [None] * n
        ray_tpu_torch.get([
            a.setup.remote(p, latest_checkpoint_path, s)
            for a, p, s in zip(actors, payloads, shards)
        ], timeout=180)
        self.state = WorkerGroupState(actors, pg)

    def run(self, train_fn, config: dict, on_report: Callable[[int, dict, Optional[str]], None],
            poll_interval: float = 0.2) -> Optional[str]:
        """Run the loop on all workers; stream reports. Returns error text."""
        import cloudpickle

        payload = cloudpickle.dumps(train_fn)
        actors = self.state.actors
        ray_tpu_torch.get([a.start_training.remote(payload, config) for a in actors],
                    timeout=120)
        done = [False] * len(actors)
        error: Optional[str] = None
        while not all(done):
            time.sleep(poll_interval)
            polls = ray_tpu_torch.get([a.poll.remote() for a in actors], timeout=120)
            for rank, p in enumerate(polls):
                for metrics, ckpt_path in p["reports"]:
                    on_report(rank, metrics, ckpt_path)
                if p["error"] and error is None:
                    error = f"worker {rank}:\n{p['error']}"
                done[rank] = p["done"]
            if error:
                break
        self._finished = error is None
        return error

    def shutdown(self):
        if self.state is None:
            return
        if self._finished:
            # every loop ended: each worker leaves the process group. After
            # a failure a peer may sit in a collective; killing it is the
            # only way out, so the group dies with the processes
            try:
                ray_tpu_torch.get([a.shutdown.remote()
                                   for a in self.state.actors], timeout=60)
            except Exception:
                pass
        for a in self.state.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        try:
            remove_placement_group(self.state.pg)
        except Exception:
            pass
        _await_dead(self.state.actors, self.TEARDOWN_WAIT_S)
        self.state = None

"""Trial + TuneController: the experiment run loop (port of
``ray_tpu/tune/controller.py``).

Reference: python/ray/tune/execution/tune_controller.py:68 (step :666) and
trainable/function_trainable.py. Trials run as actors; function trainables
run the user fn in a thread inside the actor and stream results back via a
polled queue; class trainables are stepped with explicit train() calls.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.util import events as _events

from .schedulers import FIFOScheduler, TrialScheduler
from .search import BasicVariantGenerator, Searcher


class Trainable:
    """Class trainable API (reference: trainable/trainable.py)."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.iteration = 0
        self.setup(config)

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        return False


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    trial_dir: str
    status: str = "PENDING"  # PENDING RUNNING TERMINATED ERROR
    last_result: Dict[str, Any] = field(default_factory=dict)
    results: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint_path: Optional[str] = None
    error: Optional[str] = None
    restore_from: Optional[str] = None
    actor: Any = None
    pending_ref: Any = None
    iteration: int = 0

    def metric_value(self, metric: str):
        return self.last_result.get(metric)


# --------------------------------------------------------------- actors


@ray_tpu_torch.remote
class _ClassTrainableActor:
    def __init__(self, trainable_cls, config, trial_dir):
        os.makedirs(trial_dir, exist_ok=True)
        self._trainable = trainable_cls(config)
        self._trial_dir = trial_dir

    def train(self):
        self._trainable.iteration += 1
        result = self._trainable.step() or {}
        result.setdefault("training_iteration", self._trainable.iteration)
        return result

    def save(self):
        path = os.path.join(self._trial_dir,
                            f"checkpoint_{self._trainable.iteration:06d}")
        os.makedirs(path, exist_ok=True)
        self._trainable.save_checkpoint(path)
        return path

    def restore(self, path):
        self._trainable.load_checkpoint(path)

    def stop(self):
        self._trainable.cleanup()
        return True


@ray_tpu_torch.remote
class _FunctionTrainableActor:
    """Runs fn(config) in a thread; results stream via a drained queue.

    Reference: function_trainable.py — the RESULT queue + report() API.
    """

    def __init__(self, fn, config, trial_dir, restore_path=None):
        import queue as _q

        os.makedirs(trial_dir, exist_ok=True)
        self._queue: "_q.Queue" = _q.Queue()
        self._done = False
        self._error: Optional[str] = None
        self._trial_dir = trial_dir

        from . import session as tune_session

        ctx = tune_session.TuneSession(
            trial_dir=trial_dir, queue=self._queue,
            checkpoint=Checkpoint(restore_path) if restore_path else None)

        def run():
            tune_session.set_session(ctx)
            try:
                fn(config)
            except BaseException as e:  # noqa: BLE001
                import traceback

                self._error = f"{e}\n{traceback.format_exc()}"
            finally:
                self._done = True

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def fetch(self):
        """Drain queued results; returns (results, done, error).

        ``_done`` is read BEFORE draining: the trainable thread puts
        its results and only then sets ``_done``, so done-before-drain
        guarantees every result is already in the queue when we report
        done=True.  The reverse order had a lost-result race — drain,
        then the thread puts its final report and sets the flag, then
        we read done=True and the controller stops the trial with
        results still queued (the tier-1 tune load flake)."""
        done, error = self._done, self._error
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except Exception:
                break
        return out, done, error

    def stop(self):
        return True


# ------------------------------------------------------------ controller


class TuneController:
    def __init__(self, trainable, *, param_space: Dict[str, Any],
                 searcher: Optional[Searcher] = None,
                 scheduler: Optional[TrialScheduler] = None,
                 num_samples: int = 1,
                 metric: Optional[str] = None, mode: str = "max",
                 max_concurrent_trials: Optional[int] = None,
                 stop: Optional[Dict[str, Any]] = None,
                 storage_path: Optional[str] = None,
                 name: Optional[str] = None,
                 max_failures: int = 0,
                 trial_resources: Optional[Dict[str, float]] = None,
                 checkpoint_freq: int = 0,
                 restore_state: Optional[Dict[str, Any]] = None,
                 callbacks: Optional[List] = None):
        self.callbacks = list(callbacks or [])
        self.trainable = trainable
        self._restore_state = restore_state
        self.is_function = not (isinstance(trainable, type)
                                and issubclass(trainable, Trainable))
        self.metric = metric
        self.mode = mode
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(metric, mode)
        self.searcher = searcher or BasicVariantGenerator(
            param_space, num_samples)
        if isinstance(self.searcher, BasicVariantGenerator):
            self.searcher.set_space(param_space)
        self.searcher.set_search_properties(metric, mode, param_space)
        self.stop_criteria = stop or {}
        self.max_concurrent = max_concurrent_trials or 8
        self.max_failures = max_failures
        self.trial_resources = trial_resources or {"num_cpus": 1}
        self.checkpoint_freq = checkpoint_freq
        base = storage_path or os.path.expanduser("~/ray_tpu_torch_results")
        self.exp_name = name or f"tune_{int(time.time())}"
        self.exp_dir = os.path.join(base, self.exp_name)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.trials: List[Trial] = []
        self._failures: Dict[str, int] = {}

    # -- trial lifecycle
    def _prefill_from_restore(self) -> None:
        """Recreate trials from a saved experiment_state (Tuner.restore):
        TERMINATED trials keep their results and are not re-run; others
        restart as PENDING, resuming from their last checkpoint. The
        searcher is advanced past the restored trials so deterministic
        searchers (grid/seeded random) don't regenerate them."""
        import base64

        import cloudpickle

        saved = (self._restore_state or {}).get("trials", [])
        for rec in saved:
            if "config_pkl" in rec:
                cfg = cloudpickle.loads(base64.b64decode(rec["config_pkl"]))
            else:
                continue  # legacy repr-only state: cannot reconstruct
            trial = Trial(
                trial_id=rec["trial_id"], config=cfg,
                trial_dir=os.path.join(self.exp_dir, rec["trial_id"]))
            if rec["status"] == "TERMINATED":
                trial.status = "TERMINATED"
                trial.last_result = rec.get("last_result") or {}
                trial.iteration = rec.get("iteration", 0)
                trial.checkpoint_path = rec.get("checkpoint_path")
            else:
                trial.status = "PENDING"
                trial.restore_from = rec.get("checkpoint_path")
            self.trials.append(trial)
            sug = self.searcher.suggest(trial.trial_id)
            if sug == "PENDING":
                import warnings

                warnings.warn(
                    "restore: searcher (e.g. ConcurrencyLimiter at "
                    "capacity) did not advance past a restored trial; "
                    "deterministic searchers may regenerate its config",
                    stacklevel=2)
            if trial.status == "TERMINATED":
                # free ConcurrencyLimiter-style live slots immediately:
                # restored-complete trials never reach the normal
                # completion path
                try:
                    self.searcher.on_trial_complete(
                        trial.trial_id,
                        result=trial.last_result or None)
                except Exception:
                    pass

    def _new_trial(self) -> Optional[Trial]:
        trial_id = uuid.uuid4().hex[:8]
        cfg = self.searcher.suggest(trial_id)
        if cfg is None:
            return None
        if cfg == "PENDING":
            return "PENDING"
        trial = Trial(trial_id=trial_id, config=cfg,
                      trial_dir=os.path.join(self.exp_dir, trial_id))
        self.trials.append(trial)
        return trial

    def _start_trial(self, trial: Trial) -> None:
        opts = dict(self.trial_resources)
        if self.is_function:
            trial.actor = _FunctionTrainableActor.options(**opts).remote(
                self.trainable, trial.config, trial.trial_dir,
                trial.restore_from)
            trial.pending_ref = trial.actor.fetch.remote()
        else:
            trial.actor = _ClassTrainableActor.options(**opts).remote(
                self.trainable, trial.config, trial.trial_dir)
            if trial.restore_from:
                ray_tpu_torch.get(trial.actor.restore.remote(trial.restore_from))
            trial.pending_ref = trial.actor.train.remote()
        trial.restore_from = None
        trial.status = "RUNNING"
        _events.emit("INFO", _events.SOURCE_TUNE,
                     f"trial {trial.trial_id} -> RUNNING "
                     f"(experiment {self.exp_name})",
                     entity_id=trial.trial_id, state="RUNNING",
                     experiment=self.exp_name)
        for cb in self.callbacks:
            cb.on_trial_start(trial.iteration, self.trials, trial)

    def _stop_trial(self, trial: Trial, status: str = "TERMINATED") -> None:
        trial.status = status
        _events.emit("ERROR" if status == "ERROR" else "INFO",
                     _events.SOURCE_TUNE,
                     f"trial {trial.trial_id} -> {status} "
                     f"(experiment {self.exp_name})",
                     entity_id=trial.trial_id, state=status,
                     experiment=self.exp_name,
                     iteration=trial.last_result.get(
                         "training_iteration", 0))
        if trial.actor is not None:
            try:
                if not self.is_function and status == "TERMINATED":
                    ray_tpu_torch.get(trial.actor.stop.remote(), timeout=5)
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        trial.pending_ref = None
        for cb in self.callbacks:
            if status == "TERMINATED":
                cb.on_trial_complete(trial.iteration, self.trials, trial)
            elif status == "ERROR":
                cb.on_trial_error(trial.iteration, self.trials, trial)

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    # -- PBT exploit
    def exploit_trial(self, trial: Trial, donor: Trial,
                      new_config: Dict[str, Any]) -> None:
        ckpt = donor.checkpoint_path
        if ckpt is None and not self.is_function and donor.actor is not None:
            try:
                ckpt = ray_tpu_torch.get(donor.actor.save.remote(), timeout=30)
                donor.checkpoint_path = ckpt
            except Exception:
                return
        if ckpt is None:
            return
        self._stop_trial(trial, status="PENDING")
        trial.config = new_config
        trial.restore_from = ckpt
        trial.iteration = trial.last_result.get("training_iteration", 0)
        self._start_trial(trial)

    # -- stopping criteria
    def _should_stop(self, trial: Trial, result: Dict[str, Any]) -> bool:
        for key, bound in self.stop_criteria.items():
            v = result.get(key)
            if v is not None and v >= bound:
                return True
        return False

    def _handle_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        result.setdefault("trial_id", trial.trial_id)
        result.setdefault("config", trial.config)
        result.setdefault(
            "training_iteration",
            trial.last_result.get("training_iteration", 0) + 1)
        trial.last_result = result
        trial.results.append(result)
        ckpt = result.pop("_checkpoint", None)
        if ckpt:
            trial.checkpoint_path = ckpt
        it = result.get("training_iteration", 0)
        for cb in self.callbacks:
            cb.on_trial_result(it, self.trials, trial, result)
            if ckpt:
                cb.on_checkpoint(it, self.trials, trial, ckpt)
        self.searcher.on_trial_result(trial.trial_id, result)
        decision = self.scheduler.on_trial_result(self, trial, result)
        if self._should_stop(trial, result):
            decision = TrialScheduler.STOP
        return decision

    def _handle_error(self, trial: Trial, err: str) -> None:
        n = self._failures.get(trial.trial_id, 0)
        if n < self.max_failures or self.max_failures < 0:
            self._failures[trial.trial_id] = n + 1
            _events.emit("WARNING", _events.SOURCE_TUNE,
                         f"trial {trial.trial_id} failed "
                         f"(attempt {n + 1}), retrying from checkpoint",
                         entity_id=trial.trial_id, attempt=n + 1)
            self._stop_trial(trial, status="PENDING")
            trial.restore_from = trial.checkpoint_path
            self._start_trial(trial)
        else:
            trial.error = err
            self._stop_trial(trial, status="ERROR")
            self.searcher.on_trial_complete(trial.trial_id, error=True)

    # -- checkpointing of experiment state
    @staticmethod
    def _config_pkl(t: Trial) -> str:
        """Lossless config for Tuner.restore, cached per config object —
        save_experiment_state runs every loop iteration and configs only
        change on PBT exploit."""
        import base64

        import cloudpickle

        cached = getattr(t, "_config_pkl_cache", None)
        if cached is None or cached[0] is not t.config:
            cached = (t.config, base64.b64encode(
                cloudpickle.dumps(t.config)).decode())
            t._config_pkl_cache = cached
        return cached[1]

    def save_experiment_state(self) -> None:
        state = {
            "exp_name": self.exp_name,
            "trials": [{
                "trial_id": t.trial_id, "config_repr": repr(t.config),
                "config_pkl": self._config_pkl(t),
                "status": t.status, "last_result": _json_safe(t.last_result),
                "checkpoint_path": t.checkpoint_path, "error": t.error,
                "iteration": t.iteration,
            } for t in self.trials],
        }
        with open(os.path.join(self.exp_dir, "experiment_state.json"),
                  "w") as f:
            json.dump(state, f, indent=2, default=str)

    # -- the run loop (reference: tune_controller.py step :666)
    def run(self) -> List[Trial]:
        if self._restore_state:
            self._prefill_from_restore()
        searcher_exhausted = False
        while True:
            # launch new trials
            running = [t for t in self.trials if t.status == "RUNNING"]
            while (not searcher_exhausted
                   and len(running) < self.max_concurrent):
                t = self._new_trial()
                if t is None:
                    searcher_exhausted = True
                    break
                if t == "PENDING":
                    break
                self._start_trial(t)
                running.append(t)
            # restart pending (exploited / retried / restored) trials
            for t in self.trials:
                if t.status == "PENDING" and t.actor is None \
                        and len([x for x in self.trials
                                 if x.status == "RUNNING"]) < self.max_concurrent:
                    self._start_trial(t)

            running = [t for t in self.trials if t.status == "RUNNING"]
            if not running:
                if searcher_exhausted:
                    break
                time.sleep(0.01)
                continue

            refs = {t.pending_ref: t for t in running if t.pending_ref}
            ready, _ = ray_tpu_torch.wait(list(refs.keys()),
                                    num_returns=1, timeout=1.0)
            for ref in ready:
                trial = refs[ref]
                try:
                    payload = ray_tpu_torch.get(ref)
                except Exception as e:  # actor/task failure
                    self._handle_error(trial, str(e))
                    continue
                if self.is_function:
                    results, done, error = payload
                    decision = TrialScheduler.CONTINUE
                    for r in results:
                        decision = self._handle_result(trial, r)
                        if decision == TrialScheduler.STOP:
                            break
                    if error:
                        self._handle_error(trial, error)
                    elif done or decision == TrialScheduler.STOP:
                        self._stop_trial(trial)
                        self.searcher.on_trial_complete(
                            trial.trial_id, trial.last_result)
                        self.scheduler.on_trial_complete(
                            self, trial, trial.last_result)
                    else:
                        time.sleep(0.01)
                        trial.pending_ref = trial.actor.fetch.remote()
                else:
                    decision = self._handle_result(trial, payload)
                    it = trial.last_result.get("training_iteration", 0)
                    if self.checkpoint_freq and it % self.checkpoint_freq \
                            == 0 and trial.actor is not None:
                        try:
                            trial.checkpoint_path = ray_tpu_torch.get(
                                trial.actor.save.remote(), timeout=30)
                        except Exception:
                            pass
                    if decision == TrialScheduler.STOP:
                        if trial.actor is not None:
                            try:
                                trial.checkpoint_path = ray_tpu_torch.get(
                                    trial.actor.save.remote(), timeout=30)
                            except Exception:
                                pass
                        self._stop_trial(trial)
                        self.searcher.on_trial_complete(
                            trial.trial_id, trial.last_result)
                        self.scheduler.on_trial_complete(
                            self, trial, trial.last_result)
                    elif trial.status == "RUNNING":
                        trial.pending_ref = trial.actor.train.remote()
            self.save_experiment_state()
        self.save_experiment_state()
        for cb in self.callbacks:
            cb.on_experiment_end(self.trials)
        return self.trials


def _json_safe(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = repr(v)
    return out

"""Tuner / tune.run / ResultGrid (port of ``ray_tpu/tune/tuner.py``).

Reference: python/ray/tune/tuner.py:44, tune.py:267,
result_grid.py, analysis/experiment_analysis.py.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig

from .controller import Trainable, Trial, TuneController
from .schedulers import TrialScheduler
from .search import BasicVariantGenerator, Searcher


@dataclass
class TuneConfig:
    """Reference: python/ray/tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    trial_resources: Optional[Dict[str, float]] = None
    checkpoint_freq: int = 0


@dataclass
class TuneResult:
    metrics: Dict[str, Any]
    config: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[str]
    path: str

    @property
    def metrics_dataframe(self):
        import pandas as pd

        return pd.DataFrame([self.metrics])


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, i: int) -> TuneResult:
        return self._to_result(self._trials[i])

    def _to_result(self, t: Trial) -> TuneResult:
        return TuneResult(
            metrics=t.last_result, config=t.config,
            checkpoint=Checkpoint(t.checkpoint_path)
            if t.checkpoint_path else None,
            error=t.error, path=t.trial_dir)

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._trials if t.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TuneResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set in TuneConfig or here)")
        ok = [t for t in self._trials
              if t.last_result.get(metric) is not None]
        if not ok:
            raise RuntimeError("no trial reported the metric "
                               f"{metric!r}")
        best = (max if mode == "max" else min)(
            ok, key=lambda t: t.last_result[metric])
        return self._to_result(best)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for t in self._trials:
            row = dict(t.last_result)
            for k, v in t.config.items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(self, trainable: Union[Callable, type, "Any"], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._stop = getattr(self._run_config, "stop", None)

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        rc = self._run_config
        trainable = self._trainable
        param_space = dict(self._param_space)

        # A Train trainer instance (e.g. TorchTrainer) runs as a single-trial
        # experiment whose function re-instantiates the trainer per config
        # (reference: BaseTrainer.fit wraps as a Tune Trainable :697).
        from ray_tpu_torch.train.trainer import TorchTrainer

        if isinstance(trainable, TorchTrainer):
            trainable = _make_trainer_fn(trainable)

        searcher = tc.search_alg
        if searcher is not None and hasattr(searcher, "set_space"):
            searcher.set_space(param_space)
        if searcher is not None and not isinstance(
                searcher, BasicVariantGenerator) and tc.num_samples:
            # model-based searchers suggest forever: bound the run by
            # TuneConfig.num_samples (reference: SearchGenerator wrapping
            # in tune.run)
            from .search import SearchGenerator

            searcher = SearchGenerator(searcher, param_space,
                                       tc.num_samples)
        restore_path = getattr(self, "_restore_path", None)
        if restore_path:
            # continue in the SAME experiment dir so trial dirs/checkpoints
            # of restored trials resolve
            rc.storage_path = os.path.dirname(os.path.abspath(restore_path))
            rc.name = os.path.basename(os.path.abspath(restore_path))
        controller = TuneController(
            trainable,
            param_space=param_space,
            searcher=searcher,
            scheduler=tc.scheduler,
            num_samples=tc.num_samples,
            metric=tc.metric, mode=tc.mode,
            max_concurrent_trials=tc.max_concurrent_trials,
            stop=self._stop,
            storage_path=rc.storage_path,
            name=rc.name,
            max_failures=rc.failure_config.max_failures,
            trial_resources=tc.trial_resources,
            checkpoint_freq=tc.checkpoint_freq,
            restore_state=getattr(self, "_restore_state", None),
            callbacks=rc.callbacks,
        )
        trials = controller.run()
        errored = [t for t in trials if t.error]
        if trials and len(errored) == len(trials):
            # every trial failed: returning a normal-looking ResultGrid
            # buries the errors behind private state (the round-5 stain —
            # 25/25 silently ERRORed). Raise with the first traceback so
            # the failure is visible at the call site (reference:
            # tune.run(raise_on_failed_trial=True) default).
            raise RuntimeError(
                f"all {len(trials)} trial(s) errored; first error:\n"
                f"{errored[0].error}")
        if errored:
            import warnings

            warnings.warn(
                f"{len(errored)}/{len(trials)} trial(s) errored; see "
                "ResultGrid.errors / result.error for tracebacks",
                RuntimeWarning, stacklevel=2)
        return ResultGrid(trials, tc.metric, tc.mode)

    @classmethod
    def restore(cls, path: str, trainable, *, param_space=None,
                tune_config=None, run_config=None) -> "Tuner":
        """Resume an interrupted experiment from its state file.

        Pass the ORIGINAL ``param_space``/``tune_config`` so trials not yet
        generated before the interruption are still produced; restored
        trials consume the first suggestions (deterministic searchers —
        grid, seeded random — realign; finished trials are not re-run).
        """
        state_file = os.path.join(path, "experiment_state.json")
        with open(state_file) as f:
            state = json.load(f)
        t = cls(trainable, param_space=param_space, tune_config=tune_config,
                run_config=run_config)
        t._restore_path = path
        t._restore_state = state
        return t


def _make_trainer_fn(trainer):
    base_loop = trainer.train_loop
    base_config = dict(trainer.config or {})
    scaling = trainer.scaling
    datasets = trainer.datasets

    def trainer_fn(config):
        from ray_tpu_torch.train.trainer import TorchTrainer

        merged = dict(base_config)
        merged.update(config)
        t = TorchTrainer(base_loop, train_loop_config=merged,
                         scaling_config=scaling, datasets=datasets)
        result = t.fit()
        # surface final metrics to Tune
        from . import session as tune_session

        if result.metrics:
            tune_session.report(result.metrics)

    return trainer_fn


def run(trainable, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, metric: Optional[str] = None,
        mode: str = "max", scheduler: Optional[TrialScheduler] = None,
        search_alg: Optional[Searcher] = None,
        stop: Optional[Dict[str, Any]] = None,
        storage_path: Optional[str] = None, name: Optional[str] = None,
        max_concurrent_trials: Optional[int] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        checkpoint_freq: int = 0,
        **_ignored) -> ResultGrid:
    """Functional entry point (reference: tune.py:267 tune.run)."""
    controller = TuneController(
        trainable, param_space=config or {}, searcher=search_alg,
        scheduler=scheduler, num_samples=num_samples, metric=metric,
        mode=mode, max_concurrent_trials=max_concurrent_trials, stop=stop,
        storage_path=storage_path, name=name,
        trial_resources=resources_per_trial,
        checkpoint_freq=checkpoint_freq)
    trials = controller.run()
    return ResultGrid(trials, metric, mode)


def with_parameters(fn, **params):
    """Bind large params via the object store
    (reference: tune/trainable/util.py with_parameters)."""
    import ray_tpu_torch

    refs = {k: ray_tpu_torch.put(v) for k, v in params.items()}

    def wrapped(config):
        import ray_tpu_torch as _rt

        resolved = {k: _rt.get(r) for k, r in refs.items()}
        return fn(config, **resolved)

    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    return wrapped


def with_resources(fn, resources: Dict[str, float]):
    fn.__tune_resources__ = resources
    return fn

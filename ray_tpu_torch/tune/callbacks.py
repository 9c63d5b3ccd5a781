"""Tune callbacks + per-trial loggers (port of
``ray_tpu/tune/callbacks.py``).

Reference: python/ray/tune/callback.py (Callback hook interface the
controller invokes on trial lifecycle events) and
tune/logger/{json,csv,tensorboardx}.py (per-trial result sinks). The
TensorBoard logger is omitted (no tensorboardX in this environment); the
JSON/CSV loggers produce the same ``result.json`` / ``progress.csv``
files the reference tooling reads.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class Callback:
    """Subclass and override the hooks you need."""

    def on_trial_start(self, iteration: int, trials: List, trial) -> None:
        pass

    def on_trial_result(self, iteration: int, trials: List, trial,
                        result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, iteration: int, trials: List, trial) -> None:
        pass

    def on_trial_error(self, iteration: int, trials: List, trial) -> None:
        pass

    def on_checkpoint(self, iteration: int, trials: List, trial,
                      checkpoint_path: str) -> None:
        pass

    def on_experiment_end(self, trials: List) -> None:
        pass


def _json_default(v):
    try:
        import numpy as np

        if isinstance(v, (np.integer, np.floating)):
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
    except Exception:
        pass
    return str(v)


class JsonLoggerCallback(Callback):
    """Appends each result as a JSON line to <trial_dir>/result.json
    (reference: tune/logger/json.py)."""

    def on_trial_result(self, iteration, trials, trial, result) -> None:
        if not trial.trial_dir:
            return
        os.makedirs(trial.trial_dir, exist_ok=True)
        with open(os.path.join(trial.trial_dir, "result.json"), "a") as f:
            json.dump(result, f, default=_json_default)
            f.write("\n")


class CSVLoggerCallback(Callback):
    """Appends results to <trial_dir>/progress.csv; the header is the
    first result's scalar keys (reference: tune/logger/csv.py)."""

    def __init__(self):
        self._keys: Dict[str, List[str]] = {}

    def on_trial_result(self, iteration, trials, trial, result) -> None:
        if not trial.trial_dir:
            return
        os.makedirs(trial.trial_dir, exist_ok=True)
        path = os.path.join(trial.trial_dir, "progress.csv")
        scalars = {k: v for k, v in result.items()
                   if isinstance(v, (int, float, str, bool))}
        keys = self._keys.get(trial.trial_id)
        fresh = keys is None
        if fresh:
            keys = self._keys[trial.trial_id] = sorted(scalars)
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            if fresh:
                w.writeheader()
            w.writerow(scalars)


DEFAULT_CALLBACKS = (JsonLoggerCallback, CSVLoggerCallback)

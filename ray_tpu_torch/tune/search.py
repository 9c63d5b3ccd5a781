"""Searchers: BasicVariantGenerator (grid+random), Searcher plugin API,
ConcurrencyLimiter (port of ``ray_tpu/tune/search.py``).

Reference: python/ray/tune/search/ (basic_variant.py, searcher.py,
concurrency_limiter.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from . import sample as S


class Searcher:
    """Plugin interface (reference: search/searcher.py Searcher)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric, mode, config) -> bool:
        self.metric = self.metric or metric
        self.mode = self.mode or mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid cross-product × num_samples random sampling
    (reference: basic_variant.py)."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 num_samples: int = 1, seed: Optional[int] = None,
                 points_to_evaluate: Optional[List[Dict]] = None):
        super().__init__()
        self._space = space or {}
        self._num_samples = num_samples
        self._rng = np.random.RandomState(seed)
        self._points = list(points_to_evaluate or [])
        self._queue: List[Dict[str, Any]] = []
        self._generated = False

    def set_space(self, space: Dict[str, Any]) -> None:
        self._space = space
        self._generated = False

    def _generate(self) -> None:
        self._queue = []
        for point in self._points:
            cfg = S.resolve(self._space, self._rng)
            cfg.update(point)
            self._queue.append(cfg)
        grid_variants = S.expand_grid(self._space)
        for _ in range(self._num_samples):
            for variant in grid_variants:
                self._queue.append(S.resolve(variant, self._rng))
        self._generated = True

    def total_trials(self) -> int:
        if not self._generated:
            self._generate()
        return len(self._queue) + self._consumed if hasattr(
            self, "_consumed") else len(self._queue)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._generated:
            self._generate()
        if not self._queue:
            return None
        return self._queue.pop(0)


class SearchGenerator(Searcher):
    """Adapts a Searcher producing one config per suggest() to a bounded
    number of samples."""

    def __init__(self, searcher: Searcher, space: Dict[str, Any],
                 num_samples: int):
        super().__init__(searcher.metric, searcher.mode)
        self._searcher = searcher
        self._space = space
        self._remaining = num_samples

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        return self._searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._remaining <= 0:
            return None
        cfg = self._searcher.suggest(trial_id)
        if cfg is None:
            return None
        self._remaining -= 1
        merged = S.resolve(self._space, np.random.RandomState())
        merged.update(cfg)
        return merged

    def on_trial_result(self, trial_id, result):
        self._searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._searcher.on_trial_complete(trial_id, result, error)


class ConcurrencyLimiter(Searcher):
    """Caps concurrent suggestions (reference: concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return "PENDING"  # sentinel: try again later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None and cfg != "PENDING":
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class TPESearch(Searcher):
    """Dependency-free Tree-structured Parzen Estimator (TPE-lite).

    The in-repo model-based searcher (and OptunaSearch's offline
    fallback sampler): observations split into a good fraction
    (``gamma``) and the rest; numeric dimensions score candidates by the
    density ratio l(x)/g(x) of Gaussian mixtures centered on the good /
    bad observations (log-domains fit in log10 space), categoricals by
    smoothed count ratios. TPE factorizes per dimension, so each
    dimension takes the argmax over its own candidate set
    (Bergstra et al. 2011; reference adapter surface:
    python/ray/tune/search/optuna/optuna_search.py).
    """

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 seed: Optional[int] = None, n_startup_trials: int = 12,
                 gamma: float = 0.15, n_candidates: int = 48,
                 exploration_eps: float = 0.08,
                 points_to_evaluate: Optional[List[Dict]] = None):
        super().__init__(metric, mode)
        self._space = dict(space or {})
        self._rng = np.random.RandomState(seed)
        self._n_startup = n_startup_trials
        self._gamma = gamma
        self._n_cand = n_candidates
        self._eps = exploration_eps  # random-restart probe probability
        self._points = list(points_to_evaluate or [])
        self._suggested: Dict[str, Dict[str, Any]] = {}
        self._obs: List[tuple] = []  # (config, minimized value)

    def set_space(self, space: Dict[str, Any]) -> None:
        self._space = dict(space)

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _bounds(dom):
        lo, hi = float(dom.lower), float(dom.upper)
        if getattr(dom, "log", False):
            lo, hi = np.log10(lo), np.log10(hi)
        return lo, hi

    @staticmethod
    def _to_z(dom, v):
        return float(np.log10(v)) if getattr(dom, "log", False) else float(v)

    @staticmethod
    def _from_z(dom, z):
        v = 10.0 ** z if getattr(dom, "log", False) else z
        if isinstance(dom, S.Integer):
            v = int(round(v))
            return int(np.clip(v, dom.lower, dom.upper))
        return float(np.clip(v, dom.lower, dom.upper))

    @staticmethod
    def _log_mixture(x, centers, bws):
        # log of a uniform-weight Gaussian mixture density at x
        # (per-center bandwidths: the uniform-prior component is wide)
        d = (x[:, None] - centers[None, :]) / bws[None, :]
        log_terms = -0.5 * d * d - np.log(bws[None, :] * np.sqrt(2 * np.pi))
        m = log_terms.max(axis=1)
        return m + np.log(
            np.mean(np.exp(log_terms - m[:, None]), axis=1))

    @staticmethod
    def _nn_bandwidths(z, span, scale=1.5, floor_frac=1 / 50):
        """Per-point Parzen bandwidth = distance to the nearest other
        point (as in optuna's TPE): shrinks as observations cluster, so
        refinement gets finer instead of repeating the mixture mode —
        a fixed global bandwidth makes argmax(l/g) crawl."""
        if len(z) == 1:
            return np.array([span * 0.5])
        order = np.argsort(z)
        zs = z[order]
        d = np.empty(len(z))
        for rank, i in enumerate(order):
            left = zs[rank] - zs[rank - 1] if rank > 0 else np.inf
            right = zs[rank + 1] - zs[rank] if rank < len(z) - 1 else np.inf
            d[i] = min(left, right)
        return np.clip(d * scale, span * floor_frac, span)

    def _suggest_numeric(self, dom, good, bad):
        lo, hi = self._bounds(dom)
        span = max(hi - lo, 1e-12)
        gz = np.array([self._to_z(dom, v) for v in good])
        bz = np.array([self._to_z(dom, v) for v in bad])
        g_bw = self._nn_bandwidths(gz, span)
        # l(x) includes the uniform prior as a wide component (optuna's
        # TPE does the same) so exploitation never fully kills coverage
        g_centers = np.append(gz, 0.5 * (lo + hi))
        g_bws = np.append(g_bw, span)
        # candidates: jittered good points (each with its own bandwidth)
        # plus a quarter from the prior — pure exploitation stalls
        n_prior = max(1, self._n_cand // 4)
        n_good = self._n_cand - n_prior
        ci = self._rng.randint(0, len(gz), n_good)
        cands = np.concatenate([
            gz[ci] + self._rng.normal(0.0, 1.0, n_good) * g_bw[ci],
            self._rng.uniform(lo, hi, n_prior),
        ])
        cands = np.clip(cands, lo, hi)
        score = self._log_mixture(cands, g_centers, g_bws)
        if len(bz):
            score = score - self._log_mixture(
                cands, bz, self._nn_bandwidths(bz, span))
        return self._from_z(dom, float(cands[int(np.argmax(score))]))

    def _suggest_categorical(self, dom, good, bad):
        cats = list(dom.categories)

        def smoothed(vals):
            counts = np.array(
                [1.0 + sum(1 for v in vals if v == c) for c in cats])
            return counts / counts.sum()

        score = np.log(smoothed(good)) - np.log(smoothed(bad))
        return cats[int(np.argmax(score))]

    # -- Searcher API -----------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._points:
            cfg = S.resolve(self._space, self._rng)
            cfg.update(self._points.pop(0))
        elif (len(self._obs) < self._n_startup
              or self._rng.rand() < self._eps):
            # startup phase / exploration probe: a pure prior sample
            cfg = S.resolve(self._space, self._rng)
        else:
            obs = sorted(self._obs, key=lambda o: o[1])
            n_good = max(1, int(np.ceil(self._gamma * len(obs))))
            good_cfgs = [c for c, _ in obs[:n_good]]
            bad_cfgs = [c for c, _ in obs[n_good:]]
            cfg = {}
            for key, dom in self._space.items():
                if not isinstance(dom, S.Domain):
                    cfg[key] = dom  # constant
                    continue
                good = [c[key] for c in good_cfgs if key in c]
                bad = [c[key] for c in bad_cfgs if key in c]
                if not good:
                    cfg[key] = dom.sample(self._rng)
                elif isinstance(dom, S.Categorical):
                    cfg[key] = self._suggest_categorical(dom, good, bad)
                elif isinstance(dom, (S.Float, S.Integer)):
                    cfg[key] = self._suggest_numeric(dom, good, bad)
                else:  # Function domains: no density model
                    cfg[key] = dom.sample(self._rng)
        self._suggested[trial_id] = cfg
        return dict(cfg)

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._suggested.pop(trial_id, None)
        if cfg is None or error or not result:
            return
        value = result.get(self.metric)
        if value is None:
            return
        v = float(value)
        if self.mode == "max":
            v = -v  # minimize internally
        self._obs.append((cfg, v))


class OptunaSearch(Searcher):
    """Optuna adapter (reference:
    python/ray/tune/search/optuna/optuna_search.py OptunaSearch): bridges
    tune/sample.py domains to an optuna Study via ask/tell. When optuna
    is not importable (this zero-egress image), the same adapter surface
    runs on the in-repo :class:`TPESearch` sampler, so model-based search
    works offline and swaps to real optuna transparently when present."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 seed: Optional[int] = None, n_startup_trials: int = 10,
                 points_to_evaluate: Optional[List[Dict]] = None):
        super().__init__(metric, mode)
        self._space = dict(space or {})
        self._seed = seed
        try:  # pragma: no cover - optuna absent in this image
            import optuna

            self._optuna = optuna
        except ImportError:
            self._optuna = None
            self._fallback = TPESearch(
                space, metric=metric, mode=mode, seed=seed,
                n_startup_trials=n_startup_trials,
                points_to_evaluate=points_to_evaluate)
        self._study = None
        self._trials: Dict[str, Any] = {}

    def set_space(self, space: Dict[str, Any]) -> None:
        self._space = dict(space)
        if self._optuna is None:
            self._fallback.set_space(space)

    def set_search_properties(self, metric, mode, config) -> bool:
        ok = super().set_search_properties(metric, mode, config)
        if self._optuna is None:
            self._fallback.set_search_properties(metric, mode, config)
        return ok

    # -- real-optuna path (pragma: exercised only where optuna exists) ----

    def _ensure_study(self):  # pragma: no cover - optional dep
        if self._study is None:
            sampler = self._optuna.samplers.TPESampler(seed=self._seed)
            self._study = self._optuna.create_study(
                direction="maximize" if self.mode == "max" else "minimize",
                sampler=sampler)
        return self._study

    def _ask(self):  # pragma: no cover - optional dep
        trial = self._ensure_study().ask()
        cfg = {}
        for key, dom in self._space.items():
            if isinstance(dom, S.Float):
                cfg[key] = trial.suggest_float(
                    key, dom.lower, dom.upper,
                    log=getattr(dom, "log", False))
            elif isinstance(dom, S.Integer):
                cfg[key] = trial.suggest_int(
                    key, dom.lower, dom.upper,
                    log=getattr(dom, "log", False))
            elif isinstance(dom, S.Categorical):
                cfg[key] = trial.suggest_categorical(
                    key, list(dom.categories))
            elif isinstance(dom, S.Domain):
                cfg[key] = dom.sample(np.random.RandomState(self._seed))
            else:
                cfg[key] = dom
        return trial, cfg

    # -- Searcher API -----------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._optuna is None:
            return self._fallback.suggest(trial_id)
        trial, cfg = self._ask()  # pragma: no cover - optional dep
        self._trials[trial_id] = trial
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        if self._optuna is None:
            self._fallback.on_trial_complete(trial_id, result, error)
            return
        trial = self._trials.pop(trial_id, None)  # pragma: no cover
        if trial is None:
            return
        state = self._optuna.trial.TrialState.COMPLETE
        value = None
        if error or not result or result.get(self.metric) is None:
            state = self._optuna.trial.TrialState.FAIL
        else:
            value = float(result[self.metric])
        self._ensure_study().tell(trial, value, state=state)


class HyperOptSearch(Searcher):  # pragma: no cover - optional dep
    def __init__(self, *a, **k):
        raise ImportError(
            "hyperopt is not available in this environment; use "
            "OptunaSearch (TPE-lite fallback), TPESearch, or "
            "BasicVariantGenerator")

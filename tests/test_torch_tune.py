"""The port's Tune (``ray_tpu_torch/tune``) held to the JAX package's
(``ray_tpu/tune``) on the CPU. The cases of ``tests/test_tune.py``,
``tests/test_tune_searchers.py``, the Tune cases of
``tests/test_breadth.py`` (PB2, callbacks and loggers) and
``tests/test_advice_fixes.py::test_tuner_restore_resumes`` on the port's
runtime, plus:

- parity: seeded ``BasicVariantGenerator`` and ``TPESearch``
  suggestions, and the decisions of ASHA, median stopping, PBT and PB2
  on the same scripted reports, equal to ``ray_tpu.tune``'s (which loads
  no JAX);
- ``Tuner(TorchTrainer(..., ScalingConfig(use_gpu=False)))`` on the
  default loop at ``LlamaConfig.debug()``: a grid of two learning rates,
  each trial's loss equal (bitwise, on the CPU) to a direct
  ``TorchTrainer.fit`` with the same merged config, the best trial the
  lower loss, and the experiment state written.

The trainables defined in these tests run in trial actors, which import
this module: nothing at its top imports JAX or the JAX package.
"""

import importlib
import json
import os

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.tune import (
    AsyncHyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    Trainable,
    TuneConfig,
    Tuner,
)
from ray_tpu_torch.tune.search import OptunaSearch, TPESearch


@pytest.fixture
def ray_init():
    rt.init(num_cpus=8, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()


def _tune(which: str):
    """The ``tune`` package of the port or of the JAX package."""
    return importlib.import_module(
        {"port": "ray_tpu_torch.tune", "ref": "ray_tpu.tune"}[which])


# --------------------------------------------------------------------------- #
# tests/test_tune.py
# --------------------------------------------------------------------------- #


def test_sample_domains():
    rng = np.random.RandomState(0)
    assert 0 <= tune.uniform(0, 1).sample(rng) <= 1
    v = tune.loguniform(1e-4, 1e-1).sample(rng)
    assert 1e-4 <= v <= 1e-1
    assert tune.randint(0, 10).sample(rng) in range(10)
    assert tune.choice(["a", "b"]).sample(rng) in ("a", "b")
    assert tune.quniform(0, 10, 2).sample(rng) % 2 == 0


def test_grid_expansion():
    from ray_tpu_torch.tune.sample import expand_grid

    space = {"a": tune.grid_search([1, 2, 3]),
             "b": tune.grid_search(["x", "y"]), "c": 7}
    variants = expand_grid(space)
    assert len(variants) == 6
    assert all(v["c"] == 7 for v in variants)


def test_function_trainable(ray_init, tmp_path):
    def train_fn(config):
        for i in range(5):
            tune.report({"score": config["x"] * (i + 1),
                         "training_iteration": i + 1})

    results = tune.run(
        train_fn, config={"x": tune.grid_search([1, 2, 3])},
        metric="score", mode="max", storage_path=str(tmp_path))
    assert len(results) == 3
    best = results.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == 15


def test_tuner_api(ray_init, tmp_path):
    def train_fn(config):
        tune.report({"loss": (config["lr"] - 0.1) ** 2})

    tuner = Tuner(
        train_fn,
        param_space={"lr": tune.grid_search([0.01, 0.1, 1.0])},
        tune_config=TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(storage_path=str(tmp_path), name="t"))
    grid = tuner.fit()
    assert grid.get_best_result().config["lr"] == 0.1


def test_num_samples(ray_init, tmp_path):
    def train_fn(config):
        tune.report({"v": config["x"]})

    results = tune.run(train_fn, config={"x": tune.uniform(0, 1)},
                       num_samples=5, metric="v", mode="max",
                       storage_path=str(tmp_path))
    assert len(results) == 5
    xs = [results[i].config["x"] for i in range(5)]
    assert len(set(xs)) > 1


class _Counter(Trainable):
    def setup(self, config):
        self.x = config["x"]
        self.total = 0

    def step(self):
        self.total += self.x
        return {"total": self.total}

    def save_checkpoint(self, d):
        with open(os.path.join(d, "state.txt"), "w") as f:
            f.write(str(self.total))

    def load_checkpoint(self, d):
        with open(os.path.join(d, "state.txt")) as f:
            self.total = int(f.read())


def test_class_trainable(ray_init, tmp_path):
    results = tune.run(_Counter, config={"x": tune.grid_search([1, 5])},
                       stop={"training_iteration": 4},
                       metric="total", mode="max",
                       storage_path=str(tmp_path))
    assert results.get_best_result().metrics["total"] == 20


def test_asha_stops_bad_trials():
    """Interleaved reports: the weak trial is culled at a rung while the
    strong one survives."""
    from ray_tpu_torch.tune.controller import Trial
    from ray_tpu_torch.tune.schedulers import TrialScheduler

    sched = AsyncHyperBandScheduler(
        metric="score", mode="max", time_attr="training_iteration",
        max_t=100, grace_period=2, reduction_factor=2)
    trials = {q: Trial(trial_id=f"t{q}", config={"q": q}, trial_dir="")
              for q in (1, 2, 4, 8)}
    stopped = set()
    for it in range(1, 21):
        for q in (8, 4, 2, 1):
            if q in stopped:
                continue
            decision = sched.on_trial_result(
                None, trials[q], {"score": q * it,
                                  "training_iteration": it})
            if decision == TrialScheduler.STOP:
                stopped.add(q)
    assert 8 not in stopped
    assert 1 in stopped


def test_median_stopping(ray_init, tmp_path):
    def train_fn(config):
        for i in range(10):
            tune.report({"score": config["q"],
                         "training_iteration": i + 1})

    results = tune.run(
        train_fn, config={"q": tune.grid_search([1, 1, 1, 10])},
        metric="score", mode="max",
        scheduler=MedianStoppingRule(grace_period=2,
                                     min_samples_required=2),
        storage_path=str(tmp_path))
    assert len(results) == 4


def test_experiment_state_saved(ray_init, tmp_path):
    def train_fn(config):
        tune.report({"a": 1})

    tune.run(train_fn, config={}, name="exp1", storage_path=str(tmp_path),
             metric="a", mode="max")
    assert os.path.exists(os.path.join(str(tmp_path), "exp1",
                                       "experiment_state.json"))


def test_trial_failure_marks_error(ray_init, tmp_path):
    def train_fn(config):
        if config["x"] == 1:
            raise RuntimeError("boom")
        tune.report({"ok": 1})

    results = tune.run(train_fn, config={"x": tune.grid_search([0, 1])},
                       metric="ok", mode="max",
                       storage_path=str(tmp_path))
    assert len(results.errors) == 1
    assert results.get_best_result().config["x"] == 0


def test_with_parameters(ray_init, tmp_path):
    big = np.arange(1000)

    def train_fn(config, data=None):
        tune.report({"s": float(data.sum())})

    results = tune.run(tune.with_parameters(train_fn, data=big),
                       config={}, metric="s", mode="max",
                       storage_path=str(tmp_path))
    assert results.get_best_result().metrics["s"] == float(big.sum())


class _PBTTrainable(Trainable):
    def setup(self, config):
        self.lr = config["lr"]
        self.score = 0.0

    def step(self):
        self.score += self.lr
        return {"score": self.score}

    def save_checkpoint(self, d):
        with open(os.path.join(d, "s.txt"), "w") as f:
            f.write(str(self.score))

    def load_checkpoint(self, d):
        with open(os.path.join(d, "s.txt")) as f:
            self.score = float(f.read())


def test_pbt_runs(ray_init, tmp_path):
    pbt = PopulationBasedTraining(
        time_attr="training_iteration", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 1.0, 10.0]}, seed=0)
    results = tune.run(
        _PBTTrainable, config={"lr": tune.choice([0.1, 1.0, 10.0])},
        num_samples=4, stop={"training_iteration": 6},
        metric="score", mode="max", scheduler=pbt,
        storage_path=str(tmp_path), checkpoint_freq=2)
    assert len(results) == 4
    assert results.get_best_result().metrics["score"] > 0


def test_fetch_reads_done_before_draining_queue():
    """The lost-result race: the trainable thread puts its final report
    THEN sets _done, so fetch reads _done BEFORE draining; a put+done
    landing between the drain and the flag read must not report
    done=True with results still queued."""
    import queue as _q

    from ray_tpu_torch.tune.controller import _FunctionTrainableActor

    raw = _FunctionTrainableActor._cls
    actor = object.__new__(raw)
    actor._error = None
    actor._done = False

    class RacingQueue:
        def __init__(self, owner):
            self.owner = owner
            self.items = []
            self.raced = False

        def get_nowait(self):
            if self.items:
                return self.items.pop(0)
            if not self.raced:
                self.raced = True
                self.items.append({"score": 42})
                self.owner._done = True
            raise _q.Empty

    actor._queue = RacingQueue(actor)
    results, done, error = raw.fetch(actor)
    assert done is False
    results2, done2, _ = raw.fetch(actor)
    assert done2 is True
    assert (results + results2) == [{"score": 42}]


# --------------------------------------------------------------------------- #
# tests/test_tune_searchers.py
# --------------------------------------------------------------------------- #


def _quadratic(cfg):
    return (((cfg["x"] - 0.3) / 0.2) ** 2 + ((cfg["y"] + 0.2) / 0.2) ** 2
            + ((np.log10(cfg["lr"]) + 3.0) / 0.5) ** 2)


def _space(t):
    return {"x": t.uniform(-2.0, 2.0), "y": t.uniform(-2.0, 2.0),
            "lr": t.loguniform(1e-6, 1e-1)}


SPACE = _space(tune)


def _drive(searcher, n, space=SPACE):
    searcher.set_search_properties("loss", "min", space)
    if hasattr(searcher, "set_space"):
        searcher.set_space(space)
    best = float("inf")
    for i in range(n):
        cfg = searcher.suggest(f"t{i}")
        loss = _quadratic(cfg)
        best = min(best, loss)
        searcher.on_trial_complete(f"t{i}", result={"loss": loss})
    return best


def test_tpe_beats_random_on_seeded_quadratic():
    from ray_tpu_torch.tune import sample as S

    n = 100
    tpe_bests, rand_bests = [], []
    for seed in range(8):
        tpe_bests.append(_drive(TPESearch(seed=seed), n))
        rng = np.random.RandomState(seed)
        rand_bests.append(min(_quadratic(S.resolve(SPACE, rng))
                              for _ in range(n)))
    assert np.mean(tpe_bests) < 0.8 * np.mean(rand_bests), (
        f"TPE {tpe_bests} vs random {rand_bests}")


def test_tpe_categorical_and_integer_domains():
    space = {"act": tune.choice(["relu", "tanh", "gelu"]),
             "width": tune.randint(4, 64)}

    def score(cfg):
        return (0.0 if cfg["act"] == "tanh" else 1.0) \
            + abs(cfg["width"] - 32) / 32.0

    s = TPESearch(seed=1, n_startup_trials=8)
    s.set_search_properties("loss", "min", space)
    s.set_space(space)
    for i in range(50):
        cfg = s.suggest(f"t{i}")
        s.on_trial_complete(f"t{i}", result={"loss": score(cfg)})
    tail = [s.suggest(f"p{i}") for i in range(10)]
    for i in range(10):
        s.on_trial_complete(f"p{i}", result={"loss": score(tail[i])})
    assert sum(c["act"] == "tanh" for c in tail) >= 6
    assert all(isinstance(c["width"], int) for c in tail)


def test_tpe_max_mode():
    s = TPESearch(seed=2)
    space = {"x": tune.uniform(0.0, 1.0)}
    s.set_search_properties("reward", "max", space)
    s.set_space(space)
    for i in range(40):
        cfg = s.suggest(f"t{i}")
        s.on_trial_complete(f"t{i}",
                            result={"reward": -((cfg["x"] - 0.8) ** 2)})
    xs = [s.suggest(f"p{i}")["x"] for i in range(8)]
    assert abs(np.median(xs) - 0.8) < 0.25


def test_optuna_adapter_fallback_drives_search_offline():
    bests = [_drive(OptunaSearch(seed=s), 100) for s in range(4)]
    assert np.mean(bests) < 2.5, bests


def test_optuna_adapter_in_a_real_tune_run(ray_init):
    def objective(config):
        tune.report(loss=_quadratic(config))

    tuner = tune.Tuner(
        objective, param_space=SPACE,
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    num_samples=25,
                                    search_alg=OptunaSearch(seed=0),
                                    max_concurrent_trials=2))
    results = tuner.fit()
    assert len(results) == 25
    best = results.get_best_result(metric="loss", mode="min")
    assert np.isfinite(best.metrics["loss"])
    assert best.metrics["loss"] < 40.0


# --------------------------------------------------------------------------- #
# tests/test_breadth.py (Tune) and tests/test_advice_fixes.py
# --------------------------------------------------------------------------- #


def test_pb2_gp_selection_within_bounds():
    from ray_tpu_torch.tune.schedulers import PB2

    pb2 = PB2(metric="score", mode="max",
              hyperparam_bounds={"lr": (1e-4, 1e-1)}, seed=0)

    class T:
        trial_id = "t1"
        config = {"lr": 1e-3}

    for i, s in enumerate([1.0, 2.0, 4.0, 7.0, 11.0, 16.0]):
        pb2._observe(T, i, s)
    new = pb2._mutate({"lr": 1e-3})
    assert 1e-4 <= new["lr"] <= 1e-1


def test_pb2_under_tune(ray_init, tmp_path):
    from ray_tpu_torch.tune.schedulers import PB2

    def trainable(config):
        for i in range(6):
            tune.report({"score": config["x"] * (i + 1)})

    tuner = tune.Tuner(
        trainable, param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=4,
            scheduler=PB2(perturbation_interval=2,
                          hyperparam_bounds={"x": (0.0, 1.0)})),
        run_config=RunConfig(name="pb2", storage_path=str(tmp_path)))
    results = tuner.fit()
    assert results.get_best_result("score", "max") is not None


def test_loggers_write_files(ray_init, tmp_path):
    from ray_tpu_torch.tune import CSVLoggerCallback, JsonLoggerCallback

    events = []

    class Probe(tune.Callback):
        def on_trial_start(self, it, trials, trial):
            events.append("start")

        def on_trial_complete(self, it, trials, trial):
            events.append("complete")

        def on_experiment_end(self, trials):
            events.append("end")

    def trainable(config):
        for i in range(3):
            tune.report({"loss": 1.0 / (i + 1)})

    tuner = tune.Tuner(
        trainable, param_space={"x": tune.choice([1, 2])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    num_samples=2),
        run_config=RunConfig(
            name="cb", storage_path=str(tmp_path),
            callbacks=[JsonLoggerCallback(), CSVLoggerCallback(), Probe()]))
    results = tuner.fit()
    assert events.count("start") >= 2
    assert events.count("complete") >= 2
    assert events[-1] == "end"
    found_json = found_csv = 0
    for d in [t.trial_dir for t in results._trials]:
        jp, cp = (os.path.join(d, "result.json"),
                  os.path.join(d, "progress.csv"))
        if os.path.exists(jp):
            found_json += 1
            lines = open(jp).read().strip().splitlines()
            assert len(lines) == 3
            assert "loss" in json.loads(lines[0])
        if os.path.exists(cp):
            found_csv += 1
            assert "loss" in open(cp).read().splitlines()[0]
    assert found_json == 2 and found_csv == 2


def test_tuner_restore_resumes(ray_init, tmp_path):
    """Tuner.restore continues an experiment: finished trials keep their
    results and are not re-run."""
    def trainable(config):
        tune.report({"score": config["x"] * 10})

    tuner = Tuner(trainable,
                  param_space={"x": tune.grid_search([1, 2, 3])},
                  tune_config=tune.TuneConfig(metric="score", mode="max"),
                  run_config=RunConfig(storage_path=str(tmp_path),
                                       name="exp"))
    assert len(tuner.fit()) == 3
    state_file = tmp_path / "exp" / "experiment_state.json"
    assert state_file.exists()
    state = json.loads(state_file.read_text())
    assert all("config_pkl" in t for t in state["trials"])
    restored = Tuner.restore(str(tmp_path / "exp"), trainable)
    results2 = restored.fit()
    assert len(results2) == 3
    assert sorted(r.metrics["score"] for r in results2) == [10, 20, 30]


# --------------------------------------------------------------------------- #
# Parity with ray_tpu.tune
# --------------------------------------------------------------------------- #


def _variant_suggestions(which: str, seed: int):
    t = _tune(which)
    space = {"x": t.uniform(-1.0, 1.0), "lr": t.loguniform(1e-5, 1e-1),
             "act": t.choice(["a", "b", "c"]), "n": t.randint(1, 9),
             "q": t.quniform(0, 10, 2), "g": t.grid_search([1, 2])}
    gen = t.BasicVariantGenerator(space, num_samples=3, seed=seed)
    return [gen.suggest(f"t{i}") for i in range(7)]


def _tpe_suggestions(which: str, seed: int):
    t = _tune(which)
    space = dict(_space(t), act=t.choice(["relu", "tanh"]),
                 w=t.randint(4, 64))
    s = t.TPESearch(seed=seed, n_startup_trials=6)
    s.set_search_properties("loss", "min", space)
    s.set_space(space)
    out = []
    for i in range(24):
        cfg = s.suggest(f"t{i}")
        out.append(cfg)
        s.on_trial_complete(f"t{i}", result={
            "loss": _quadratic(cfg) + (cfg["act"] == "relu")})
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_searchers_suggest_what_the_reference_suggests(seed):
    assert _variant_suggestions("port", seed) == \
        _variant_suggestions("ref", seed)
    assert _tpe_suggestions("port", seed) == _tpe_suggestions("ref", seed)


class _Recorder:
    """A controller stand-in for schedulers: trials by id, and the
    exploits PBT asks for."""

    def __init__(self, trials):
        self.trials = trials
        self.exploits = []

    def get_trial(self, trial_id):
        return self.trials.get(trial_id)

    def exploit_trial(self, trial, donor, new_config):
        self.exploits.append((trial.trial_id, donor.trial_id,
                              dict(new_config)))


def _decisions(which: str, make_scheduler, scores, iterations=12):
    """``make_scheduler(tune)``'s decisions over interleaved scripted
    reports (trial q scores ``scores(q, it)``), and the exploits it asked
    of the controller."""
    t = _tune(which)
    from_ctrl = importlib.import_module(t.__name__ + ".controller")
    sched = make_scheduler(t)
    trials = {f"t{q}": from_ctrl.Trial(trial_id=f"t{q}",
                                       config={"q": q, "lr": 0.1 * q},
                                       trial_dir="",
                                       checkpoint_path=f"/ck/{q}")
              for q in range(1, 7)}
    ctrl = _Recorder(trials)
    out, stopped = [], set()
    for it in range(1, iterations + 1):
        for tid, trial in trials.items():
            if tid in stopped:
                continue
            d = sched.on_trial_result(ctrl, trial, {
                "score": scores(trial.config["q"], it),
                "training_iteration": it})
            out.append((tid, it, d))
            if d == "STOP":
                stopped.add(tid)
    return out, ctrl.exploits


SCHEDULERS = {
    "asha": (lambda t: t.AsyncHyperBandScheduler(
        metric="score", mode="max", max_t=100, grace_period=2,
        reduction_factor=2), lambda q, it: (7 - q) * it),
    "hyperband": (lambda t: t.HyperBandScheduler(
        metric="score", mode="min", max_t=9, grace_period=1,
        reduction_factor=3), lambda q, it: (q * 7 % 5) / it),
    "median": (lambda t: t.MedianStoppingRule(
        metric="score", mode="max", grace_period=2,
        min_samples_required=2), lambda q, it: (q * 3 % 7) + 0.1 * it),
    "pbt": (lambda t: t.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 1.0, 10.0],
                              "q": t.uniform(0.0, 1.0)}, seed=0),
        lambda q, it: (q * 5 % 6) * it),
    "pb2": (lambda t: t.PB2(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_bounds={"lr": (0.01, 1.0)}, seed=1),
        lambda q, it: (q * 5 % 6) * it + 0.01 * q * it * it),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_schedulers_decide_what_the_reference_decides(name):
    make, scores = SCHEDULERS[name]
    port = _decisions("port", make, scores)
    ref = _decisions("ref", make, scores)
    assert port == ref
    if name in ("asha", "hyperband", "median"):
        assert any(d == "STOP" for _, _, d in port[0]), port
    if name in ("pbt", "pb2"):
        assert port[1], "no exploit was asked for"


# --------------------------------------------------------------------------- #
# Tuner over TorchTrainer
# --------------------------------------------------------------------------- #


def test_tuner_over_torch_trainer_matches_direct_fits(ray_init, tmp_path):
    """A grid of two learning rates over ``TorchTrainer``'s default loop
    (``LlamaConfig.debug()``, one CPU worker, 3 steps): each trial's
    final loss is the loss of a direct fit with the same merged config,
    bitwise; the best is the lower; the experiment state is saved."""
    base = {"steps": 3, "seq": 16, "batch_per_device": 2, "seed": 0}
    scaling = ScalingConfig(num_workers=1, use_gpu=False)
    lrs = [3e-4, 1e-3]
    tuner = Tuner(
        TorchTrainer(train_loop_config=base, scaling_config=scaling),
        param_space={"lr": tune.grid_search(lrs)},
        tune_config=TuneConfig(metric="loss", mode="min",
                               max_concurrent_trials=1),
        run_config=RunConfig(storage_path=str(tmp_path), name="sweep"))
    grid = tuner.fit()
    assert len(grid) == 2 and not grid.errors
    got = {grid[i].config["lr"]: grid[i].metrics["loss"] for i in range(2)}
    direct = {}
    for lr in lrs:
        result = TorchTrainer(
            train_loop_config={**base, "lr": lr}, scaling_config=scaling,
            run_config=RunConfig(storage_path=str(tmp_path),
                                 name=f"direct_{lr}")).fit()
        assert result.error is None
        direct[lr] = result.metrics["loss"]
    assert got == direct
    assert grid.get_best_result("loss", "min").config["lr"] == \
        min(direct, key=direct.get)
    assert (tmp_path / "sweep" / "experiment_state.json").exists()

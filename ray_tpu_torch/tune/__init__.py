"""Hyperparameter optimisation engine (port of ``ray_tpu/tune``): the
JAX package's Tune on the port's runtime, whose ``Tuner`` runs a
``TorchTrainer`` as a trainable (one trial actor a config, holding no
card itself; the trainer's workers take the cards).

Reference: python/ray/tune/ (Tuner, TuneController, searchers, schedulers).
"""

from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("tune")
del _rlu


from ray_tpu_torch.tune.controller import Trainable, Trial, TuneController  # noqa: F401
from ray_tpu_torch.tune.sample import (  # noqa: F401
    choice,
    grid_search,
    lograndint,
    loguniform,
    qloguniform,
    qrandint,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.callbacks import (  # noqa: F401
    Callback,
    CSVLoggerCallback,
    JsonLoggerCallback,
)
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    PB2,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator,
    ConcurrencyLimiter,
    OptunaSearch,
    Searcher,
    TPESearch,
)
from ray_tpu_torch.tune.session import get_checkpoint, get_trial_dir, report  # noqa: F401
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    ResultGrid,
    TuneConfig,
    Tuner,
    run,
    with_parameters,
    with_resources,
)

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "run", "Trainable", "Trial",
    "TuneController", "report", "get_checkpoint", "get_trial_dir",
    "uniform", "quniform", "loguniform", "qloguniform", "randint",
    "qrandint", "lograndint", "randn", "choice", "sample_from",
    "grid_search", "Searcher", "BasicVariantGenerator",
    "ConcurrencyLimiter", "OptunaSearch", "TPESearch",
    "TrialScheduler", "FIFOScheduler",
    "AsyncHyperBandScheduler", "HyperBandScheduler", "MedianStoppingRule",
    "PopulationBasedTraining", "PB2", "Callback", "JsonLoggerCallback",
    "CSVLoggerCallback", "with_parameters", "with_resources",
]

"""Distributed training orchestration — the Ray Train analog (port of
``ray_tpu/train``).

Reference surface (python/ray/train): Trainer.fit, ScalingConfig,
RunConfig, FailureConfig, CheckpointConfig, Checkpoint, session
report/get_context/get_dataset_shard. ``TorchTrainer`` gang-schedules one
worker actor a card and joins them in one ``torch.distributed`` process
group; its default loop is ``spmd.spmd_train_loop``.

The sharded steps (``spmd``) and the MPMD pipeline trainer
(``pipeline``: ``MPMDPipelineTrainer``, stage actors on one card each
over compiled-graph device edges) load torch and the model stack, so
their names resolve on first use: the runtime imports this package
(the health monitor) in processes that never train.
"""

from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("train")
del _rlu


from ray_tpu_torch.train.backend_executor import (  # noqa: F401,E402
    Backend,
    BackendExecutor,
    TorchBackend,
)
from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401,E402
from ray_tpu_torch.train.config import (  # noqa: F401,E402
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (  # noqa: F401,E402
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.trainer import Result, TorchTrainer  # noqa: F401,E402

_SPMD = ("build_train_mesh", "llama_partition_rules",
         "make_shard_and_gather_fns", "make_spmd_train_step",
         "match_partition_rules", "spmd_train_loop")


# the MPMD pipeline trainer (train/pipeline.py), resolved the same way
_PIPELINE = ("MPMDPipelineTrainer", "PipelineStageActor", "init_mlp_params",
             "reference_llama_losses", "reference_train_losses",
             "split_llama_stages", "split_stages")


def __getattr__(name: str):
    if name in _SPMD:
        from ray_tpu_torch.train import spmd

        return getattr(spmd, name)
    if name in _PIPELINE:
        from ray_tpu_torch.train import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

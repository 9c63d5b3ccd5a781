"""Per-trial session for function trainables: tune.report /
get_checkpoint (port of ``ray_tpu/tune/session.py``). Outside a trial it
bridges to the port's train session (``train/session.py``).

Reference: ray.tune's use of the shared train/tune session
(python/ray/air/_internal/session.py).
"""

from __future__ import annotations

import os
import shutil
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class TuneSession:
    trial_dir: str
    queue: Any
    checkpoint: Optional[Checkpoint] = None


_session: Optional[TuneSession] = None


def set_session(s: Optional[TuneSession]) -> None:
    global _session
    _session = s


def get_session() -> Optional[TuneSession]:
    return _session


def report(metrics: Optional[Dict[str, Any]] = None,
           checkpoint: Optional[Checkpoint] = None,
           **kwargs: Any) -> None:
    """Report metrics (+ optional checkpoint) from inside a trial fn.

    Accepts both styles the reference supports: the new dict form
    ``tune.report({"loss": x})`` and the legacy kwargs form
    ``tune.report(loss=x)`` (mixing merges, kwargs win).
    """
    merged: Dict[str, Any] = dict(metrics or {})
    merged.update(kwargs)
    metrics = merged
    s = _session
    if s is None:
        # Fall back to the Train session (TorchTrainer inside Tune)
        from ray_tpu_torch.train import session as train_session

        train_session.report(metrics, checkpoint=checkpoint)
        return
    result = dict(metrics)
    if checkpoint is not None:
        # persist into the trial dir so it outlives the actor
        dest = os.path.join(s.trial_dir,
                            f"checkpoint_{uuid.uuid4().hex[:6]}")
        shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
        result["_checkpoint"] = dest
    result.setdefault("timestamp", time.time())
    s.queue.put(result)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _session
    if s is None:
        from ray_tpu_torch.train import session as train_session

        return train_session.get_checkpoint()
    return s.checkpoint


def get_trial_dir() -> Optional[str]:
    return _session.trial_dir if _session else None

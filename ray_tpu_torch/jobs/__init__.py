"""Job submission: drive entrypoint scripts against a running cluster
(port of ``ray_tpu/jobs/``).

Reference: python/ray/dashboard/modules/job/ — ``JobManager`` spawns the
entrypoint as a child process whose driver connects to the existing
cluster; ``JobSubmissionClient`` is the REST client
(python/ray/dashboard/modules/job/sdk.py). Same split here: the manager
(jobs/manager.py) execs entrypoints with ``RAY_TPU_ADDRESS`` pointing at
the head's client server, and the REST surface lives on the dashboard
HTTP server (dashboard/__init__.py, /api/jobs/*).
"""

from ray_tpu_torch.jobs.manager import (  # noqa: F401
    JobInfo,
    JobManager,
    JobStatus,
    JobSubmissionClient,
)

__all__ = ["JobManager", "JobStatus", "JobInfo", "JobSubmissionClient"]

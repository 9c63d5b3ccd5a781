"""Durable workflows: DAGs of tasks with per-step checkpointing + resume
(port of ``ray_tpu/workflow/``).

The reference's Workflow library (python/ray/workflow/api.py:54 ``run``,
workflow_executor.py, workflow_state_from_storage.py) executes a task DAG
with every step's result persisted, so a crashed driver resumes where it
left off. Same semantics here, rebuilt on ray_tpu_torch primitives:

- ``fn.bind(...)`` authors a :class:`FunctionNode` DAG (ids are
  content-derived, so a rebuilt DAG maps onto its stored progress);
- :func:`run` executes it with steps as ray_tpu_torch tasks, results
  checkpointed to the workflow storage after each step;
- :func:`resume` reloads the pickled DAG and replays from checkpoints —
  finished steps are *loaded*, not re-run;
- a step may return :func:`continuation` (another DAG) — the dynamic
  workflow pattern (reference: workflow/api.py Continuation).

Usage::

    @ray_tpu_torch.remote
    def add(a, b): return a + b

    result = workflow.run(add.bind(add.bind(1, 2), 3), workflow_id="w1")
"""

from ray_tpu_torch.workflow.api import (  # noqa: F401
    Continuation,
    EventListener,
    FunctionNode,
    TimerListener,
    WorkflowStatus,
    cancel,
    continuation,
    delete,
    get_metadata,
    get_output,
    get_status,
    init,
    list_all,
    resume,
    resume_all,
    run,
    run_async,
    sleep,
    wait_for_event,
)

__all__ = [
    "run", "run_async", "resume", "resume_all", "get_output", "get_status",
    "get_metadata", "list_all", "cancel", "delete", "init", "continuation",
    "Continuation", "FunctionNode", "WorkflowStatus", "EventListener",
    "TimerListener", "wait_for_event", "sleep",
]

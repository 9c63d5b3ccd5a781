"""The port's workflows (``ray_tpu_torch/workflow/``) held to the JAX
package's cases (``tests/test_workflow.py``): durable DAG execution,
resume, continuations, events; ``RemoteFunction.bind`` builds the
workflow's ``FunctionNode``. Nothing here imports JAX.
"""

import os

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import workflow


@pytest.fixture(scope="module")
def port_runtime():
    rt.init(num_cpus=4, num_gpus=0)
    yield
    rt.shutdown()


@pytest.fixture
def wf_storage(tmp_path, port_runtime):
    storage = str(tmp_path / "wf")
    workflow.init(storage)
    yield storage
    workflow.api._default_storage = None


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def double(x):
    return 2 * x


class TestWorkflowBasics:
    def test_bind_builds_a_function_node(self):
        node = add.bind(1, 2)
        assert isinstance(node, workflow.FunctionNode)

    def test_linear_dag(self, wf_storage):
        dag = double.bind(add.bind(1, 2))
        assert workflow.run(dag, workflow_id="lin") == 6
        assert workflow.get_status("lin") == workflow.WorkflowStatus.SUCCESSFUL
        assert workflow.get_output("lin") == 6

    def test_diamond_dag(self, wf_storage):
        a = add.bind(1, 1)
        left = double.bind(a)
        right = add.bind(a, 10)
        dag = add.bind(left, right)
        # a=2, left=double(a)=4, right=a+10=12
        assert workflow.run(dag, workflow_id="dia") == 16

    def test_run_async(self, wf_storage):
        fut = workflow.run_async(add.bind(2, 3), workflow_id="async1")
        assert fut.result(timeout=60) == 5

    def test_list_and_delete(self, wf_storage):
        workflow.run(add.bind(1, 1), workflow_id="gone")
        assert ("gone", workflow.WorkflowStatus.SUCCESSFUL) in \
            workflow.list_all()
        workflow.delete("gone")
        assert "gone" not in [w for w, _ in workflow.list_all()]
        with pytest.raises(workflow.api.WorkflowNotFoundError):
            workflow.get_status("gone")

    def test_metadata_counts_steps(self, wf_storage):
        workflow.run(double.bind(add.bind(3, 4)), workflow_id="meta")
        md = workflow.get_metadata("meta")
        assert md["completed_steps"] == 2
        assert md["status"] == workflow.WorkflowStatus.SUCCESSFUL


class TestWorkflowResume:
    def test_failure_then_resume_skips_done_steps(self, wf_storage,
                                                  tmp_path):
        marker = str(tmp_path / "fail_once")
        count_file = str(tmp_path / "count")

        @rt.remote(max_retries=0)
        def counted(x):
            with open(count_file, "a") as f:
                f.write("x")
            return x + 1

        @rt.remote(max_retries=0)
        def flaky(x):
            if not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write("1")
                raise RuntimeError("boom")
            return x * 10

        dag = flaky.bind(counted.bind(4))
        with pytest.raises(Exception):
            workflow.run(dag, workflow_id="res")
        assert workflow.get_status("res") == \
            workflow.WorkflowStatus.RESUMABLE
        # resume: counted's checkpoint is loaded, not re-executed
        assert workflow.resume("res") == 50
        with open(count_file) as f:
            assert f.read() == "x"
        assert workflow.get_status("res") == \
            workflow.WorkflowStatus.SUCCESSFUL

    def test_resume_successful_returns_result(self, wf_storage):
        workflow.run(add.bind(20, 22), workflow_id="done")
        assert workflow.resume("done") == 42


class TestWorkflowContinuation:
    def test_dynamic_recursion(self, wf_storage):
        @rt.remote
        def factorial(n, acc=1):
            if n <= 1:
                return acc
            return workflow.continuation(factorial.bind(n - 1, acc * n))

        assert workflow.run(factorial.bind(5), workflow_id="fact") == 120
        # continuation steps are checkpointed too
        assert workflow.get_metadata("fact")["completed_steps"] >= 5


class TestWorkflowEvents:
    def test_wait_for_event_and_sleep(self, wf_storage):
        class FileEvent(workflow.EventListener):
            def poll_for_event(self, path):
                import time as _t

                while not os.path.exists(path):
                    _t.sleep(0.05)
                with open(path) as f:
                    return f.read()

        import tempfile
        import threading
        import time as _t

        marker = os.path.join(tempfile.gettempdir(),
                              f"torch_wf_event_{os.getpid()}")
        if os.path.exists(marker):
            os.remove(marker)

        def fire():
            _t.sleep(0.5)
            with open(marker, "w") as f:
                f.write("fired")

        threading.Thread(target=fire, daemon=True).start()
        dag = add.bind(workflow.wait_for_event(FileEvent, marker), "!")
        try:
            assert workflow.run(dag, workflow_id="ev") == "fired!"
        finally:
            if os.path.exists(marker):
                os.remove(marker)

    def test_sleep_is_checkpointed(self, wf_storage):
        import time as _t

        dag = double.bind(workflow.sleep(0.3))
        t0 = _t.monotonic()
        assert workflow.run(dag, workflow_id="zz") == 0.6
        assert _t.monotonic() - t0 >= 0.3
        # resume: the timer step loads from its checkpoint, no re-sleep
        t1 = _t.monotonic()
        assert workflow.resume("zz") == 0.6
        assert _t.monotonic() - t1 < 0.25

"""The port's own runtime (``ray_tpu_torch/core``, a copy of the JAX
package's) held to the cases of ``tests/test_core_api.py`` and
``tests/test_actors.py``: tasks, actors and objects, on the CPU, plus the
GPU accounting and binding that the port adds (a CPU node that
advertises GPUs it does not have; no card is opened).

Every blocking call has a timeout: this suite runs without
pytest-timeout. Nothing here imports JAX: the runtime's workers import
this module to run the functions and classes defined in it.
"""

import os
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy

T = 60  # seconds any one blocking call may take


@pytest.fixture(scope="module")
def _shutdown_at_the_end():
    try:
        yield
    finally:
        if rt.is_initialized():
            rt.shutdown()


@pytest.fixture
def cluster(_shutdown_at_the_end):
    """One four-CPU cluster, shared by the task and actor cases (started
    again after a case that needed its own)."""
    if not rt.is_initialized():
        rt.init(num_cpus=4, num_gpus=0)


@pytest.fixture
def gpu_cluster(_shutdown_at_the_end):
    """A cluster of its own per case, for cases that set the environment
    its workers inherit."""
    if rt.is_initialized():
        rt.shutdown()
    try:
        yield rt.init
    finally:
        if rt.is_initialized():
            rt.shutdown()


# --------------------------------------------------------------------------- #
# tasks (tests/test_core_api.py)
# --------------------------------------------------------------------------- #


@rt.remote
def add_one(x):
    return x + 1


@rt.remote
def kw_sum(a, b=10, *, c=100):
    return a + b + c


@rt.remote(num_returns=3)
def three():
    return 1, 2, 3


@rt.remote
def double(x):
    return x * 2


@rt.remote
def nested_get(d):
    return rt.get(d["ref"], timeout=T) + 1


@rt.remote
def outer(x):
    return rt.get(add_one.remote(x * 10), timeout=T)


@rt.remote
def echo(x):
    return x.sum(), x


@rt.remote
def boom():
    raise ValueError("boom!")


@rt.remote
def sleepy(s):
    time.sleep(s)
    return s


@rt.remote
def context_ids():
    c = rt.get_runtime_context()
    return c.get_job_id(), c.get_node_id(), c.get_task_id()


def _chain():
    r = double.remote(1)
    for _ in range(5):
        r = double.remote(r)
    return rt.get(r, timeout=T)


TASK_CASES = {
    "simple": (lambda: rt.get(add_one.remote(1), timeout=T), 2),
    "kwargs_defaults": (lambda: rt.get(kw_sum.remote(1), timeout=T), 111),
    "kwargs_given": (lambda: rt.get(kw_sum.remote(1, b=2, c=3), timeout=T),
                     6),
    "multiple_returns": (lambda: rt.get(list(three.remote()), timeout=T),
                         [1, 2, 3]),
    "dependencies": (_chain, 64),
    "nested_ref_in_arg": (lambda: rt.get(nested_get.remote(
        {"ref": add_one.remote(6)}), timeout=T), 8),
    "nested_submission": (lambda: rt.get(outer.remote(4), timeout=T), 41),
    "options_override": (lambda: rt.get(add_one.options(num_cpus=2).remote(
        1), timeout=T), 2),
    "many_small_tasks": (lambda: rt.get([add_one.remote(i)
                                         for i in range(200)], timeout=T),
                         list(range(1, 201))),
}


@pytest.mark.parametrize("case", list(TASK_CASES))
def test_task(cluster, case):
    run, want = TASK_CASES[case]
    assert run() == want


def test_task_error_propagation(cluster):
    with pytest.raises(rt.TaskError, match="boom!"):
        rt.get(boom.remote(), timeout=T)


@pytest.mark.parametrize("value", [1, "s", {"a": [1, 2]}, None,
                                   np.arange(10)],
                         ids=["int", "str", "dict", "none", "small_array"])
def test_put_get_roundtrip(cluster, value):
    out = rt.get(rt.put(value), timeout=T)
    if isinstance(value, np.ndarray):
        np.testing.assert_array_equal(out, value)
    else:
        assert out == value


def test_put_get_through_the_arena(cluster):
    # 8 MB, far over the 100 KB inline limit: the shared-memory arena
    arr = np.arange(1_000_000, dtype=np.float64)
    out = rt.get(rt.put(arr), timeout=T)
    # a zero-copy read is a read-only view over the arena
    assert not out.flags.writeable
    np.testing.assert_array_equal(out, arr)


def test_large_args_and_returns(cluster):
    arr = np.ones((512, 1024), dtype=np.float32)  # 2 MB each way
    s, back = rt.get(echo.remote(arr), timeout=T)
    assert s == arr.size
    np.testing.assert_array_equal(back, arr)


def test_wait(cluster):
    rt.get(sleepy.remote(0), timeout=T)  # a warm worker
    fast, slow = sleepy.remote(0), sleepy.remote(5)
    ready, not_ready = rt.wait([fast, slow], num_returns=1, timeout=3)
    assert ready == [fast] and not_ready == [slow]


def test_get_timeout(cluster):
    with pytest.raises(rt.GetTimeoutError):
        rt.get(sleepy.remote(10), timeout=0.3)


def test_retry_on_worker_crash(cluster):
    @rt.remote(max_retries=2)
    def flaky(path):
        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)  # the worker dies on the first attempt
        return "recovered"

    path = os.path.join(tempfile.mkdtemp(), "marker")
    assert rt.get(flaky.remote(path), timeout=T) == "recovered"


def test_runtime_context(cluster):
    job, node, task = rt.get(context_ids.remote(), timeout=T)
    assert job and node and task


def test_cluster_resources(cluster):
    total = rt.cluster_resources()
    assert total["CPU"] == 4.0 and "GPU" not in total


# --------------------------------------------------------------------------- #
# actors (tests/test_actors.py)
# --------------------------------------------------------------------------- #


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.n = start
        self.items = []

    def inc(self, k=1):
        self.n += k
        return self.n

    def add(self, x):
        self.items.append(x)
        return len(self.items)

    def get_items(self):
        return self.items

    def fail(self):
        raise RuntimeError("actor method failed")

    @rt.method(num_returns=2)
    def two(self):
        return 1, 2


@rt.remote
def bump(counter, k):
    return rt.get(counter.inc.remote(k), timeout=T)


def test_basic_actor(cluster):
    c = Counter.remote(10)
    assert rt.get(c.inc.remote(), timeout=T) == 11
    assert rt.get(c.inc.remote(5), timeout=T) == 16


def test_actor_ordering(cluster):
    a = Counter.remote()
    for i in range(20):
        a.add.remote(i)
    assert rt.get(a.get_items.remote(), timeout=T) == list(range(20))


def test_actor_error_keeps_the_actor(cluster):
    b = Counter.remote()
    with pytest.raises(rt.TaskError, match="actor method failed"):
        rt.get(b.fail.remote(), timeout=T)
    assert rt.get(b.inc.remote(), timeout=T) == 1


def test_actor_handle_in_task(cluster):
    c = Counter.remote()
    assert rt.get(bump.remote(c, 99), timeout=T) == 99


def test_actor_num_returns(cluster):
    a, b = Counter.remote().two.remote()
    assert rt.get([a, b], timeout=T) == [1, 2]


def test_named_actor(cluster):
    Counter.options(name="port-registry").remote(5)
    h = rt.get_actor("port-registry")
    assert rt.get(h.inc.remote(1), timeout=T) == 6


def test_kill_actor(cluster):
    a = Counter.remote()
    assert rt.get(a.inc.remote(), timeout=T) == 1
    rt.kill(a)
    time.sleep(0.5)
    with pytest.raises((rt.ActorDiedError, rt.TaskError)):
        rt.get(a.inc.remote(), timeout=10)


def test_actor_creation_failure(cluster):
    @rt.remote
    class Broken:
        def __init__(self):
            raise ValueError("cannot construct")

        def ping(self):
            return "?"

    with pytest.raises((rt.TaskError, rt.ActorDiedError)):
        rt.get(Broken.remote().ping.remote(), timeout=30)


@rt.remote
class Rendezvous:
    """An async actor (one coroutine method) whose sync ``meet`` returns
    only once ``n`` calls are inside it at the same time."""

    def __init__(self, n):
        import threading

        self.barrier = threading.Barrier(n, timeout=20)

    async def ping(self):
        return "pong"

    def meet(self, i):
        self.barrier.wait()
        return i


@pytest.mark.parametrize("concurrency", [1, 3])
def test_async_actor_sync_methods_run_on_max_concurrency_threads(
        cluster, concurrency):
    """The JAX package's runtime runs an async actor's sync methods on
    one thread whatever its max_concurrency (its serve replica then runs
    one stream at a time); the port's on max_concurrency threads."""
    a = Rendezvous.options(max_concurrency=concurrency).remote(concurrency)
    assert rt.get(a.ping.remote(), timeout=T) == "pong"
    refs = [a.meet.remote(i) for i in range(concurrency)]
    assert rt.get(refs, timeout=T) == list(range(concurrency))


def test_placement_group(cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    try:
        assert pg.ready(timeout=T)
        actors = [Counter.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=i)).remote(i)
            for i in range(2)]
        assert rt.get([a.inc.remote() for a in actors], timeout=T) == [1, 2]
        for a in actors:
            rt.kill(a)
    finally:
        remove_placement_group(pg)


def test_placement_group_beyond_the_cluster_is_not_ready(cluster):
    pg = placement_group([{"GPU": 1}])
    try:
        assert not pg.ready(timeout=1.0)
    finally:
        remove_placement_group(pg)


# --------------------------------------------------------------------------- #
# GPUs: detection, accounting and binding (no card is opened)
# --------------------------------------------------------------------------- #


@rt.remote(num_gpus=1)
class GpuHolder:
    def visible(self):
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                rt.get_runtime_context().get_accelerator_ids().get("GPU"))


@pytest.mark.parametrize("inherited,want", [
    (None, ["0", "1"]),
    # a driver started with cards 4 and 5 visible: each worker gets ONE of
    # them, not the inherited list (a setdefault would keep "4,5" for both)
    ("4,5", ["4", "5"]),
], ids=["no_inherited_list", "inherited_4_5"])
def test_gpu_actors_see_one_card_each(gpu_cluster, monkeypatch, inherited,
                                      want):
    if inherited is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", inherited)
    gpu_cluster(num_cpus=4, num_gpus=2)
    assert rt.cluster_resources()["GPU"] == 2.0
    holders = [GpuHolder.remote() for _ in range(2)]
    seen = rt.get([h.visible.remote() for h in holders], timeout=T)
    assert sorted(v for v, _ in seen) == want
    assert sorted(ids[0] for _, ids in seen) == ["0", "1"]
    # both cards are held: a third holder waits
    third = GpuHolder.remote()
    ready, _ = rt.wait([third.visible.remote()], timeout=1.0)
    assert ready == []
    rt.kill(holders[0])
    assert rt.get(third.visible.remote(), timeout=T)[0] in want


@pytest.mark.parametrize("visible,want", [("0,1,2", 3.0), ("", None),
                                          ("3,-1,4", 1.0)],
                         ids=["three", "none", "stops_at_invalid"])
def test_gpus_detected_from_the_visible_list(gpu_cluster, monkeypatch,
                                             visible, want):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    gpu_cluster(num_cpus=2)
    assert rt.cluster_resources().get("GPU") == want

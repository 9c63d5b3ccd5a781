"""The port's ``util/multiprocessing.py`` (a ``multiprocessing.Pool``
over the cluster) and ``util/joblib_backend.py`` (joblib's ``Parallel``
over that pool), with the ``ActorPool`` and ``Queue`` they sit beside,
held to the JAX package's cases (``tests/test_util_extras.py``).
Nothing here imports JAX."""

import os

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import ActorPool, Queue
from ray_tpu_torch.util.queue import Empty, Full


@rt.remote
class _Doubler:
    def double(self, x):
        return x * 2


@pytest.fixture(scope="module")
def port_runtime():
    rt.init(num_cpus=4, num_gpus=0)
    yield
    rt.shutdown()


def test_multiprocessing_pool(port_runtime):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(2) as p:
        assert p.map(lambda x: x * x, range(10)) == [x * x for x in range(10)]
        assert p.starmap(lambda a, b: a + b, [(1, 2), (3, 4)]) == [3, 7]
        assert sorted(p.imap_unordered(lambda x: -x, range(5))) == \
            [-4, -3, -2, -1, 0]
        assert list(p.imap(lambda x: x + 1, range(4))) == [1, 2, 3, 4]
        r = p.apply_async(lambda a: a + 1, (41,))
        assert r.get(timeout=30) == 42
        assert p.apply(lambda a, b: a * b, (6, 7)) == 42


def test_joblib_backend(port_runtime):
    """joblib Parallel over cluster workers (reference: ray.util.joblib)."""
    import joblib

    from ray_tpu_torch.util.joblib_backend import register_ray_tpu

    register_ray_tpu()

    def work(x):
        import os as _os

        return x * 3, _os.getpid()

    with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
        out = joblib.Parallel()(joblib.delayed(work)(i) for i in range(6))
    assert [v for v, _ in out] == [0, 3, 6, 9, 12, 15]
    assert os.getpid() not in {p for _, p in out}  # ran in workers


def test_actor_pool_map_ordered(port_runtime):
    pool = ActorPool([_Doubler.remote(), _Doubler.remote()])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [x * 2 for x in range(8)]


def test_actor_pool_unordered(port_runtime):
    pool = ActorPool([_Doubler.remote(), _Doubler.remote()])
    out = sorted(pool.map_unordered(
        lambda a, v: a.double.remote(v), range(6)))
    assert out == [x * 2 for x in range(6)]


def test_actor_pool_submit_get_next(port_runtime):
    pool = ActorPool([_Doubler.remote()])
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)
    assert pool.get_next() == 20
    assert pool.get_next() == 40
    assert not pool.has_next()


def test_queue_basic(port_runtime):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    with pytest.raises(Full):
        q.put(3, block=False)
    assert q.qsize() == 2
    assert q.get() == 1
    assert q.get() == 2
    with pytest.raises(Empty):
        q.get(block=False)
    q.shutdown()


def test_queue_shared_across_workers(port_runtime):
    q = Queue()

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i * 10)
        return n

    assert rt.get(producer.remote(q, 3)) == 3
    assert [q.get(timeout=10) for _ in range(3)] == [0, 10, 20]
    q.shutdown()

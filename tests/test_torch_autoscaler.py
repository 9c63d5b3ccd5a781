"""The port's autoscaler (``ray_tpu_torch/autoscaler/``) held to the JAX
package's cases (``tests/test_autoscaler.py``): the sizing math,
demand-driven scale-up with REAL node daemons and idle scale-down; then
what the port adds: a node config's ``num_gpus`` hands each daemon its
own cards through ``core/accelerators.py:bind_gpus``, and the injected-
callables provider (the JAX package's ``TPUSliceProvider``) under its
port name. The JAX package's ``TPUQueuedResourceProvider`` is not ported
(no TPU queued resources on a GPU host), nor are its cases. Nothing
here imports JAX."""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalerConfig,
                                      CallbackNodeProvider,
                                      LocalNodeProvider)


def _as(node_config):
    # sizing math only; no head/provider interaction
    a = Autoscaler.__new__(Autoscaler)
    a.config = AutoscalerConfig(node_config=node_config)
    return a


def test_binpack_simple():
    assert _as({"num_cpus": 4})._workers_for_demand([{"CPU": 1}] * 6) == 2


def test_binpack_mixed():
    a = _as({"num_cpus": 2, "resources": {"mem": 8}})
    demand = [{"CPU": 1, "mem": 6}, {"CPU": 1, "mem": 6}, {"CPU": 2}]
    assert a._workers_for_demand(demand) == 3


def test_infeasible_skipped():
    assert _as({"num_cpus": 2})._workers_for_demand([{"CPU": 64}]) == 0


def test_empty():
    assert _as({"num_cpus": 2})._workers_for_demand([]) == 0


def test_binpack_gpus():
    a = _as({"num_cpus": 4, "num_gpus": 2})
    assert a._node_capacity() == {"CPU": 4.0, "GPU": 2.0}
    assert a._workers_for_demand([{"GPU": 1}] * 5) == 3
    assert a._workers_for_demand([{"GPU": 4}]) == 0


@pytest.fixture
def head():
    rt.init(num_cpus=1, num_gpus=0)
    from ray_tpu_torch.core import api as _api

    h = _api._get_head()
    yield h
    rt.shutdown()


def test_scale_up_runs_pending_then_scale_down(head):
    addr = head.start_node_server()
    provider = LocalNodeProvider(addr, head.cluster_key_hex)
    scaler = Autoscaler(head, provider, AutoscalerConfig(
        min_workers=0, max_workers=2, idle_timeout_s=2.0,
        interval_s=0.5, node_config={"num_cpus": 2}))
    try:
        # the head has 1 CPU; each task wants 2 -> unplaceable until a
        # worker node (2 CPUs) joins
        @rt.remote(num_cpus=2)
        def hog(i):
            time.sleep(0.2)
            return i

        refs = [hog.remote(i) for i in range(3)]
        assert sorted(rt.get(refs, timeout=120)) == [0, 1, 2]
        assert scaler.num_launches >= 1
        assert provider.non_terminated_nodes()
        deadline = time.time() + 60
        while time.time() < deadline and provider.non_terminated_nodes():
            time.sleep(0.5)
        assert provider.non_terminated_nodes() == []
        assert scaler.num_terminations >= 1
    finally:
        scaler.stop(terminate_nodes=True)


def test_local_provider_gives_each_node_its_own_cards(head, monkeypatch):
    """Two daemons of one GPU each on a host whose process inherited
    ``CUDA_VISIBLE_DEVICES=4,5``: each daemon advertises one card, and a
    ``num_gpus=1`` task on it sees that card; a third node is refused
    and a terminated node's card returns to the pool."""
    addr = head.start_node_server()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5")
    provider = LocalNodeProvider(addr, head.cluster_key_hex)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    try:
        ids = [provider.create_node({"num_cpus": 1, "num_gpus": 1})
               for _ in range(2)]
        assert [provider.gpus_of(i) for i in ids] == [[0], [1]]
        with pytest.raises(RuntimeError, match="0 of this host's cards"):
            provider.create_node({"num_cpus": 1, "num_gpus": 1})
        deadline = time.time() + 60
        while time.time() < deadline and \
                rt.cluster_resources().get("GPU", 0) < 2:
            time.sleep(0.2)
        assert rt.cluster_resources().get("GPU") == 2

        @rt.remote(num_gpus=1, num_cpus=1)
        def card():
            import os as _os
            import time as _t

            _t.sleep(1.0)
            return _os.environ.get("CUDA_VISIBLE_DEVICES")

        assert sorted(rt.get([card.remote() for _ in range(2)],
                             timeout=120)) == ["4", "5"]
        provider.terminate_node(ids[0])
        assert provider.non_terminated_nodes() == [ids[1]]
        again = provider.create_node({"num_cpus": 1, "num_gpus": 1})
        assert provider.gpus_of(again) == [0]
    finally:
        provider.shutdown()


def test_callback_provider_delegates():
    made, gone = [], []

    def launch(cfg):
        made.append(cfg)
        return f"n{len(made)}"

    p = CallbackNodeProvider(launch, gone.append,
                             lambda: [f"n{i + 1}" for i in range(len(made))
                                      if f"n{i + 1}" not in gone])
    assert p.create_node({"num_gpus": 8}) == "n1"
    assert p.create_node({"num_gpus": 8}) == "n2"
    assert p.non_terminated_nodes() == ["n1", "n2"] and p.is_running("n2")
    p.shutdown()
    assert gone == ["n1", "n2"] and p.non_terminated_nodes() == []
    assert made == [{"num_gpus": 8}] * 2

"""The port's cross-host ring channels (``ray_tpu_torch/core/net_ring.py``)
held to the cases of the JAX package's tests, on the CPU:

- ``tests/test_net_ring.py``: the TCP session layer, two endpoints in one
  process over real authenticated loopback connections, numpy and torch
  tensors on the zero-copy writev path;
- ``tests/test_net_ring_conformance.py``: the port's endpoints and the
  JAX package's machine-checked spec (``ray_tpu/tools/lint/
  ring_model_net.py``, plain Python) through identical traces — scripted
  recovery scenarios and seeded random walks with loss, duplication,
  reordering and crash-restarts — with the protocol state compared after
  every op;
- ``tests/test_cross_host_dag.py``: compiled graphs whose edges cross
  separate-process node daemons of the port's ``cluster_utils.Cluster``
  ride net rings, co-located edges stay on /dev/shm, tensors cross with
  no serializer, an executor's death is attributed and a restarted actor
  on another node gets fresh net edges.

Nothing at the top imports JAX: the daemons' workers import this module
to unpickle its actors.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import net_ring
from ray_tpu_torch.core.exceptions import ActorDiedError
from ray_tpu_torch.core.net_ring import NetRingReader, NetRingWriter
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.experimental.channel import (
    STATS,
    TAG_BYTES,
    TAG_ERROR,
    TAG_STOP,
    TAG_TENSOR,
    ChannelClosed,
    ChannelTimeout,
    ShmChannel,
)

T = 60  # seconds any one blocking call may take


@pytest.fixture()
def ring_pair():
    made = []

    def make(ring_id, n_slots=4, capacity=1 << 20, **kw):
        reader = net_ring.create_reader(ring_id, n_slots, capacity, **kw)
        host = net_ring.ensure_host()
        writer = net_ring.NetRingWriter.connect(
            host.address, host.authkey, ring_id, n_slots, capacity)
        made.append((writer, reader))
        return writer, reader

    yield make
    for w, r in made:
        w.close()
        r.close()


def _sever_sessions():
    host = net_ring.ensure_host()
    with host._lock:
        conns = list(host._conns)
    for c in conns:
        c.close()


# --------------------------------------------------------------------------- #
# tests/test_net_ring.py
# --------------------------------------------------------------------------- #


def test_roundtrip_tags_and_order(ring_pair):
    w, r = ring_pair("pt_basic")
    w.write(b"raw", tag=TAG_BYTES, timeout=5)
    w.write(b"err", tag=TAG_ERROR, timeout=5)
    assert r.read(timeout=5) == (TAG_BYTES, b"raw")
    assert r.read(timeout=5) == (TAG_ERROR, b"err")
    w.write(b"", tag=TAG_STOP, timeout=5)
    with pytest.raises(ChannelClosed):
        r.read(timeout=5)


@pytest.mark.parametrize("kind", ["numpy", "bf16_tensor"])
def test_tensor_path_no_serializer(ring_pair, kind):
    w, r = ring_pair(f"pt_tensor_{kind}")
    before = STATS["serialized_bytes"]
    if kind == "numpy":
        arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    else:
        arr = torch.arange(24, dtype=torch.bfloat16).reshape(2, 3, 4)
    w.write_array(arr, timeout=5)
    tag, out = r.read(timeout=5)
    assert tag == TAG_TENSOR
    assert type(out) is type(arr) and out.dtype == arr.dtype
    if kind == "numpy":
        np.testing.assert_array_equal(out, arr)
    else:
        assert torch.equal(out, arr)
    assert STATS["serialized_bytes"] == before


def test_window_backpressure_and_drain(ring_pair):
    w, r = ring_pair("pt_window", n_slots=3)
    for i in range(3):
        w.write(b"m%d" % i, tag=TAG_BYTES, timeout=5)
    assert not w.writable() and w.occupancy() == 3
    with pytest.raises(ChannelTimeout):
        w.write(b"overflow", tag=TAG_BYTES, timeout=0.2)
    for i in range(3):
        assert r.read(timeout=5) == (TAG_BYTES, b"m%d" % i)
    w.wait_writable(timeout=5)
    assert w.writable()


def test_capacity_enforced(ring_pair):
    w, _r = ring_pair("pt_cap", capacity=64)
    with pytest.raises(ValueError):
        w.write(b"x" * 65, tag=TAG_BYTES, timeout=1)
    with pytest.raises(ValueError):
        w.write_array(torch.zeros(64, dtype=torch.float32), timeout=1)


def test_session_break_recovers_via_retransmit(ring_pair):
    w, r = ring_pair("pt_break", n_slots=4)
    w.write(b"before", tag=TAG_BYTES, timeout=5)
    assert r.read(timeout=5) == (TAG_BYTES, b"before")
    _sever_sessions()
    w.write(b"during", tag=TAG_BYTES, timeout=5)
    w.write(b"during2", tag=TAG_BYTES, timeout=5)
    assert r.read(timeout=15) == (TAG_BYTES, b"during")
    assert r.read(timeout=15) == (TAG_BYTES, b"during2")
    deadline = time.monotonic() + 10
    while w.acked != w.w and time.monotonic() < deadline:
        time.sleep(0.02)
    assert w.acked == w.w


def test_poison_unparks_blocked_reader(ring_pair):
    w, r = ring_pair("pt_poison")
    errs = []

    def blocked_read():
        try:
            r.read(timeout=30)
        except ChannelClosed as e:
            errs.append(e)

    t = threading.Thread(target=blocked_read, daemon=True)
    t.start()
    time.sleep(0.2)
    r.poison()
    t.join(timeout=5)
    assert not t.is_alive() and len(errs) == 1
    w.close()


def test_poison_prefix_targets_dag_uid(ring_pair):
    _w1, r1 = ring_pair("ptuidA_e0_0")
    _w2, r2 = ring_pair("ptuidB_e0_0")
    assert net_ring.poison_rings("ptuidA_") == 1
    with pytest.raises(ChannelClosed):
        r1.read(timeout=1)
    _w2.write(b"ok", tag=TAG_BYTES, timeout=5)
    assert r2.read(timeout=5) == (TAG_BYTES, b"ok")


def test_wait_writable_is_all_or_nothing_safe(ring_pair):
    w, r = ring_pair("pt_wait", n_slots=2)
    w.wait_writable(timeout=5)
    w.write(b"1", tag=TAG_BYTES, timeout=0)
    w.wait_writable(timeout=5)
    w.write(b"2", tag=TAG_BYTES, timeout=0)
    assert r.read(timeout=5)[1] == b"1"
    assert r.read(timeout=5)[1] == b"2"


def test_chaos_wire_point_drops_data_then_retransmit_recovers():
    from ray_tpu_torch.core import fault_injection

    reader = net_ring.create_reader("pt_chaos_d", 4, 1 << 16)
    host = net_ring.ensure_host()
    w = net_ring.NetRingWriter.connect(host.address, host.authkey,
                                       "pt_chaos_d", 4, 1 << 16)
    try:
        fault_injection.configure("wire.send.nrd=drop@2")
        w.write(b"first", tag=TAG_BYTES, timeout=5)
        w.write(b"second", tag=TAG_BYTES, timeout=5)
        assert reader.read(timeout=10) == (TAG_BYTES, b"first")
        assert reader.read(timeout=10) == (TAG_BYTES, b"second")
    finally:
        fault_injection.reset()
        w.close()
        reader.close()


def test_tensor_send_writev_zero_copy(ring_pair):
    """A numpy payload is writev'd segment by segment: no joined copy
    on the send path (``tensor_copy_bytes`` stays put)."""
    w, r = ring_pair("pt_writev")
    before_copy = STATS["tensor_copy_bytes"]
    before_tensor = STATS["tensor_bytes"]
    arr = np.arange(512 * 257, dtype=np.float32).reshape(512, 257)
    w.write_array(arr, timeout=5)
    tag, out = r.read(timeout=5)
    assert tag == TAG_TENSOR
    np.testing.assert_array_equal(out, arr)
    assert STATS["tensor_bytes"] - before_tensor == arr.nbytes
    assert STATS["tensor_copy_bytes"] == before_copy


def test_tensor_segments_retransmit_after_session_break(ring_pair):
    w, r = ring_pair("pt_writev_rt", n_slots=2)
    arr = np.arange(1024, dtype=np.int32)
    w.write_array(arr, timeout=5)
    tag, out = r.read(timeout=5)
    np.testing.assert_array_equal(out, arr)
    _sever_sessions()
    arr2 = arr * 3
    w.write_array(arr2, timeout=5)
    tag, out2 = r.read(timeout=15)
    assert tag == TAG_TENSOR
    np.testing.assert_array_equal(out2, arr2)


def test_cpu_tensor_is_snapshotted_not_borrowed(ring_pair):
    """A CPU tensor is mutable: the writer sends a snapshot (one counted
    copy), so a retransmit after a session break ships the bytes as
    written even if the producer mutated its tensor since."""
    w, r = ring_pair("pt_snapshot", n_slots=2)
    t = torch.arange(256, dtype=torch.float32)
    w.write_array(t, timeout=5)
    assert torch.equal(r.read(timeout=5)[1], t)
    _sever_sessions()
    before_copy = STATS["tensor_copy_bytes"]
    sent = t * 2
    w.write_array(sent, timeout=5)
    assert STATS["tensor_copy_bytes"] - before_copy == sent.numel() * 4
    want = sent.clone()
    sent.fill_(-1.0)  # the producer reuses its buffer before the ack
    tag, got = r.read(timeout=15)
    assert tag == TAG_TENSOR and torch.equal(got, want)


# --------------------------------------------------------------------------- #
# tests/test_net_ring_conformance.py: the port's endpoints vs the spec
# --------------------------------------------------------------------------- #


def _spec():
    from ray_tpu.tools.lint import ring_model_net

    return ring_model_net


class ModelTwin:
    """The spec state, driven op by op through the spec module's own
    transition functions."""

    def __init__(self, n_slots: int):
        self.M = _spec()
        self.NMUT = self.M.NetMutations()
        self.n = n_slots
        self.s = self.M.initial_state(n_slots)

    w = property(lambda self: self.s[0])
    acked = property(lambda self: self.s[1])
    r = property(lambda self: self.s[2])
    slots = property(lambda self: self.s[3])
    resyncing = property(lambda self: self.s[5] == self.M.RESYNC)
    data = property(lambda self: self.s[10])
    acks = property(lambda self: self.s[11])

    def _set(self, **kw):
        self.s = self.M._set(self.s, **kw)

    def produce(self):
        assert self.M.window_open(self.s, self.n)
        w = self.w + 1
        self._set(w=w, data=self.data | {("d", w)})

    def consume(self):
        assert not self.resyncing and self.M.readable(self.s, self.n)
        r = self.r
        assert self.slots[r % self.n] == r + 1
        slots = list(self.slots)
        slots[r % self.n] = 0
        self._set(r=r + 1, slots=tuple(slots),
                  acks=self.acks | {("a", r + 1)})

    def deliver_data(self, key, keep=False):
        st, viol = self.M._deliver_data(self.s, key, self.n, self.NMUT)
        assert not viol, f"spec violation on {key}: {viol}"
        if not keep:
            st = self.M._set(st, data=st[10] - {key})
        self.s = st

    def lose_data(self, key):
        self._set(data=self.data - {key})

    def deliver_ack(self, key, keep=False):
        st, viol = self.M._deliver_ack(self.s, key, self.NMUT)
        assert not viol
        if not keep:
            st = self.M._set(st, acks=st[11] - {key})
        self.s = st

    def lose_ack(self, key):
        self._set(acks=self.acks - {key})

    def retransmit(self):
        assert self.acked < self.w
        self._set(data=self.data | {("d", self.acked + 1)})

    def crash_reader(self):
        self._set(r=0, slots=(0,) * self.n, rflag=0, rbell=0,
                  data=frozenset(), acks=frozenset(), crashed=1,
                  rpc=self.M.RESYNC)

    def resync_send(self):
        assert self.resyncing
        self._set(acks=self.acks | {("rrq",)})

    def crash_writer(self):
        self._set(acked=0, wflag=0, wbell=0, data=frozenset(),
                  acks=frozenset(), crashed=1)


def _key(msg):
    return {"nrd": lambda m: ("d", m[1]),
            "nrbase": lambda m: ("rbase", m[1]),
            "nra": lambda m: ("a", m[1]),
            "nrrq": lambda m: ("rrq",)}[msg[0]](msg)


class Harness:
    """The port's endpoints wired through test-controlled channels, keyed
    sets like the spec's (duplicates collapse; delivery order is the
    test's choice)."""

    def __init__(self, n_slots: int, capacity: int = 4096):
        self.n = n_slots
        self.capacity = capacity
        self.data: dict = {}
        self.acks: dict = {}
        self.writer = NetRingWriter("pconf_ring", n_slots, capacity,
                                    send=self._to_reader)
        self.reader = NetRingReader("pconf_ring", n_slots, capacity)
        self.reader.attach_send(self._to_writer)

    def _to_reader(self, msg):
        self.data[_key(msg)] = msg

    def _to_writer(self, msg):
        self.acks[_key(msg)] = msg

    def produce(self):
        self.writer.produce(b"p%d" % (self.writer.w + 1))

    def consume(self):
        self.reader.consume()

    def deliver_data(self, key, keep=False):
        msg = self.data[key] if keep else self.data.pop(key)
        self.reader.on_message(msg, reply=self._to_writer)

    def lose_data(self, key):
        del self.data[key]

    def deliver_ack(self, key, keep=False):
        msg = self.acks[key] if keep else self.acks.pop(key)
        self.writer.on_message(msg, reply=self._to_reader)

    def lose_ack(self, key):
        del self.acks[key]

    def retransmit(self):
        assert self.writer.retransmit_once()

    def crash_reader(self):
        self.reader = NetRingReader("pconf_ring", self.n, self.capacity,
                                    resync=True)
        self.reader.attach_send(self._to_writer)
        self.data.clear()
        self.acks.clear()

    def resync_send(self):
        self.reader.start_resync()

    def crash_writer(self):
        old = self.writer
        self.writer = NetRingWriter("pconf_ring", self.n, self.capacity,
                                    send=self._to_reader)
        self.writer.w = old.w
        self.writer._unacked = dict(old._unacked)
        self.data.clear()
        self.acks.clear()


def assert_conformant(h: Harness, m: ModelTwin, ctx: str):
    M = m.M
    real_slots = tuple(s[0] if s is not None else 0
                       for s in h.reader._slots)
    assert (h.writer.w, h.writer.acked) == (m.w, m.acked), ctx
    assert (h.reader.r, real_slots) == (m.r, m.slots), ctx
    assert h.reader.resyncing == m.resyncing, ctx
    assert set(h.data) == set(m.data), ctx
    assert set(h.acks) == set(m.acks), ctx
    assert h.writer.writable() == M.window_open(m.s, m.n), ctx
    assert h.reader.readable() == \
        (not m.resyncing and M.readable(m.s, m.n)), ctx


def run_script(n_slots, ops):
    h, m = Harness(n_slots), ModelTwin(n_slots)
    for step, op in enumerate(ops(h)):
        getattr(h, op[0])(*op[1:])
        getattr(m, op[0])(*op[1:])
        assert_conformant(h, m, f"step {step}: {op}")
    return h


@pytest.mark.parametrize("n_slots", [1, 2, 3])
def test_scripted_wedge_recovery_trace(n_slots):
    """All messages consumed, the FINAL ack lost: the window is pinned
    shut until a stale retransmission draws the Go-Back-N re-ack."""
    def ops(h):
        for _ in range(n_slots):
            yield ("produce",)
        for s in range(1, n_slots + 1):
            yield ("deliver_data", ("d", s))
            yield ("consume",)
        for s in range(1, n_slots + 1):
            yield ("lose_ack", ("a", s))
        assert not h.writer.writable()
        yield ("retransmit",)
        yield ("deliver_data", ("d", 1))
        yield ("deliver_ack", ("a", n_slots))
        assert h.writer.writable() and h.writer.acked == n_slots
        yield ("produce",)

    run_script(n_slots, ops)


@pytest.mark.parametrize("n_slots", [1, 2])
def test_scripted_reader_restart_resync_trace(n_slots):
    def ops(h):
        yield from [("produce",), ("deliver_data", ("d", 1)), ("consume",),
                    ("deliver_ack", ("a", 1)), ("produce",),
                    ("crash_reader",)]
        assert h.reader.resyncing and not h.reader.readable()
        yield from [("resync_send",), ("deliver_ack", ("rrq",)),
                    ("deliver_data", ("rbase", 1))]
        assert not h.reader.resyncing and h.reader.r == 1
        yield from [("retransmit",), ("deliver_data", ("d", 2)),
                    ("consume",), ("deliver_ack", ("a", 2))]

    assert run_script(n_slots, ops).writer.acked == 2


@pytest.mark.parametrize("n_slots", [1, 2])
def test_scripted_writer_restart_trace(n_slots):
    def ops(h):
        yield from [("produce",), ("deliver_data", ("d", 1)), ("consume",),
                    ("deliver_ack", ("a", 1)), ("crash_writer",)]
        assert h.writer.acked == 0 and h.writer.w == 1
        yield from [("retransmit",), ("deliver_data", ("d", 1)),
                    ("deliver_ack", ("a", 1))]

    h = run_script(n_slots, ops)
    assert h.writer.acked == 1 and h.writer.writable()


def _enabled_ops(m: ModelTwin, n_messages: int, crash_left: bool):
    M = m.M
    ops = []
    if M.window_open(m.s, m.n) and m.w < n_messages:
        ops.append(("produce",))
    if not m.resyncing and M.readable(m.s, m.n):
        ops.append(("consume",))
    for key in sorted(m.data):
        ops += [("deliver_data", key), ("deliver_data", key, True),
                ("lose_data", key)]
    for key in sorted(m.acks):
        ops += [("deliver_ack", key), ("deliver_ack", key, True),
                ("lose_ack", key)]
    if m.acked < m.w and ("d", m.acked + 1) not in m.data:
        ops.append(("retransmit",))
    if m.resyncing and ("rrq",) not in m.acks:
        ops.append(("resync_send",))
    if crash_left:
        ops += [("crash_reader",), ("crash_writer",)]
    return ops


@pytest.mark.parametrize("n_slots,seed", [(1, 7), (2, 11), (2, 23),
                                          (3, 5)])
def test_seeded_random_traces_conform(n_slots, seed):
    rng = random.Random(seed)
    h, m = Harness(n_slots), ModelTwin(n_slots)
    crash_left = True
    for step in range(400):
        ops = _enabled_ops(m, 200, crash_left)
        if not ops:
            break
        weights = [4 if o[0] in ("produce", "consume", "deliver_data",
                                 "deliver_ack") else 1 for o in ops]
        op = rng.choices(ops, weights=weights, k=1)[0]
        if op[0].startswith("crash"):
            crash_left = False
        getattr(h, op[0])(*op[1:])
        getattr(m, op[0])(*op[1:])
        assert_conformant(h, m, f"step {step}: {op}")
    assert m.r > 0 or m.w > 0


# --------------------------------------------------------------------------- #
# tests/test_cross_host_dag.py: net-ring edges from actor placement
# --------------------------------------------------------------------------- #


def wait_for(cond, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture()
def two_daemons():
    cluster = Cluster(head_node_args={"num_cpus": 1})
    n1 = cluster.add_node(num_cpus=2, resources={"d1": 4},
                          separate_process=True)
    n2 = cluster.add_node(num_cpus=2, resources={"d2": 4},
                          separate_process=True)
    try:
        yield cluster, n1, n2
    finally:
        cluster.shutdown()


@rt.remote(resources={"d1": 1})
class OnD1:
    def inc(self, x):
        return x + 1

    def pid(self):
        return os.getpid()

    def matmul(self, x):
        x = torch.as_tensor(x)
        return x @ x.T

    def chan_stats(self):
        from ray_tpu_torch.experimental.channel import STATS

        return dict(STATS)


@rt.remote(resources={"d2": 1})
class OnD2:
    def double(self, x):
        return x * 2

    def rowsum(self, m):
        return torch.as_tensor(m).sum(dim=1)

    def chan_stats(self):
        from ray_tpu_torch.experimental.channel import STATS

        return dict(STATS)


@rt.remote
class Local:
    def triple(self, x):
        return x * 3


@rt.remote(resources={"pool": 1}, max_restarts=2)
class Movable:
    def inc(self, x):
        return x + 1


def test_cross_daemon_edges_are_net_rings(two_daemons):
    a, b = OnD1.remote(), OnD2.remote()
    with InputNode() as inp:
        out = b.double.bind(a.inc.bind(inp))
    dag = out.experimental_compile(max_inflight=4)
    try:
        assert all(isinstance(ch, NetRingWriter)
                   for ch in dag._input_chans), dag._input_chans
        assert isinstance(dag._out, NetRingReader)
        assert not any(isinstance(ch, ShmChannel) for ch in dag._channels)
        for i in range(6):
            assert dag.execute(i).get(timeout=T) == (i + 1) * 2
        refs = [dag.execute(i) for i in range(4)]
        assert [r.get(timeout=T) for r in refs] == \
            [(i + 1) * 2 for i in range(4)]
    finally:
        dag.teardown()


def test_mixed_topology_shm_and_net(two_daemons):
    loc, far = Local.remote(), OnD1.remote()
    with InputNode() as inp:
        out = far.inc.bind(loc.triple.bind(inp))
    dag = out.experimental_compile(max_inflight=2)
    try:
        assert any(isinstance(ch, ShmChannel) for ch in dag._input_chans)
        assert isinstance(dag._out, NetRingReader)
        for i in range(5):
            assert dag.execute(i).get(timeout=T) == i * 3 + 1
    finally:
        dag.teardown()


def test_tensor_path_crosses_daemons_without_serializer(two_daemons):
    a, b = OnD1.remote(), OnD2.remote()
    with InputNode() as inp:
        out = b.rowsum.bind(a.matmul.bind(inp))
    dag = out.experimental_compile(buffer_size_bytes=8 << 20,
                                   device_channels=True, max_inflight=2)
    try:
        x = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
        got = dag.execute(x).get(timeout=120)
        tx = torch.from_numpy(x)
        torch.testing.assert_close(got, (tx @ tx.T).sum(dim=1), rtol=1e-4,
                                   atol=0)
        sa = rt.get(a.chan_stats.remote(), timeout=T)
        sb = rt.get(b.chan_stats.remote(), timeout=T)
        assert sa["tensor_bytes"] >= 64 * 64 * 4
        assert sa["serialized_bytes"] == 0, sa
        assert sb["serialized_bytes"] == 0, sb
    finally:
        dag.teardown()


def test_executor_death_cross_daemon_fails_attributed(two_daemons):
    a = OnD1.remote()
    pid = rt.get(a.pid.remote(), timeout=T)
    with InputNode() as inp:
        out = a.inc.bind(inp)
    dag = out.experimental_compile(max_inflight=2)
    assert dag.execute(1).get(timeout=T) == 2
    ref = dag.execute(2)
    os.kill(pid, signal.SIGKILL)
    with pytest.raises(ActorDiedError):
        ref.get(timeout=T)
    dag.teardown()


def test_rebind_rebuilds_net_edges_to_actors_new_node(two_daemons):
    cluster, n1, n2 = two_daemons
    cluster.add_node(num_cpus=1, resources={"pool": 1},
                     separate_process=True)
    cluster.add_node(num_cpus=1, resources={"pool": 1},
                     separate_process=True)
    s = Movable.remote()
    assert rt.get(s.inc.remote(0), timeout=T) == 1
    from ray_tpu_torch.core.runtime import get_current_runtime

    head = get_current_runtime().head
    loc0 = head.actor_location(s._actor_id)["node_hex"]
    with InputNode() as inp:
        out = s.inc.bind(inp)
    dag = out.experimental_compile(max_inflight=2)
    assert dag.execute(1).get(timeout=T) == 2
    assert isinstance(dag._out, NetRingReader)
    victim = head.nodes[loc0]
    os.kill(victim.pid, signal.SIGKILL)
    wait_for(lambda: (head.actor_location(s._actor_id) or {})
             .get("node_hex") not in (None, loc0),
             timeout=90, msg="actor failover to the surviving node")
    wait_for(lambda: (head.actor_location(s._actor_id) or {})
             .get("state") == "ALIVE",
             timeout=90, msg="restarted actor alive")
    assert head.actor_location(s._actor_id)["node_hex"] != loc0
    deadline = time.monotonic() + 90
    value = None
    while time.monotonic() < deadline:
        try:
            value = dag.execute(9, timeout=20).get(timeout=30)
            break
        except Exception:
            time.sleep(0.3)
    assert value == 10, f"rebind to the new node never served: {value!r}"
    assert isinstance(dag._out, NetRingReader)
    assert dag._uid in dag._out.ring_id
    dag.teardown()

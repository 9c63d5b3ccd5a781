"""The port's compiled graphs (``ray_tpu_torch/dag``) and ring channels
(``ray_tpu_torch/experimental/channel.py``) held to the cases of
``tests/test_compiled_dag.py`` on the CPU, all but its timing gate
(``test_compiled_beats_eager``), plus what the port adds:

- wire format: every tag a port ``ShmChannel`` writes (DATA, BYTES,
  ERROR, STREAM frames, STOP, TENSOR of a float32 numpy array) is read
  back by the JAX package's ``ShmChannel``, and the other way round;
- protocol: the port's ``ShmChannel`` and the JAX package's
  ``RingModel`` through identical traces (the check of
  ``tests/test_static_analysis.py::test_ring_conformance_model_vs_real_channel``);
- the torch tensor path: a bfloat16 CPU tensor crosses a
  ``device_channels=True`` edge with no serialized bytes, a CUDA payload
  on a reader without a card raises, and two planted faults (the
  duck-typed tensor test, a slot released before its tensor is copied
  out) are caught by the gates that guard against them.

One four-CPU runtime serves the module. Nothing at the top imports JAX:
the runtime's workers import this module to unpickle its actors.
"""

import collections
import os
import struct
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core.exceptions import TaskError
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.experimental import channel as ch_mod
from ray_tpu_torch.experimental.channel import (
    TAG_BYTES,
    TAG_DATA,
    TAG_ERROR,
    TAG_STOP,
    TAG_STREAM,
    TAG_TENSOR,
    ChannelClosed,
    ChannelTimeout,
    ShmChannel,
)

T = 60  # seconds any one blocking call may take


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()


@rt.remote
class Stage:
    def __init__(self, add):
        self.add = add

    def step(self, x):
        return x + self.add

    def boom(self, x):
        raise ValueError(f"bad input {x}")

    def slow(self, x):
        time.sleep(0.4)
        return x + self.add

    def scaled(self, x, factor):
        return x * factor


@rt.remote
class Worker2:
    def inc(self, x):
        return x + 1

    def double(self, x):
        return x * 2

    def add(self, a, b):
        return a + b

    def matmul(self, x):
        x = torch.as_tensor(x)
        return x @ x.T

    def rowsum(self, m):
        return torch.as_tensor(m).sum(dim=1)

    def to_bf16(self, x):
        return torch.as_tensor(x).to(torch.bfloat16) * 2

    def chan_stats(self):
        from ray_tpu_torch.experimental.channel import STATS

        return dict(STATS)


def _compile(out, **kw):
    return out.experimental_compile(**kw)


# --------------------------------------------------------------------------- #
# tests/test_compiled_dag.py
# --------------------------------------------------------------------------- #


def test_compiled_chain_correctness(runtime):
    a, b = Stage.remote(1), Stage.remote(10)
    rt.get([a.step.remote(0), b.step.remote(0)], timeout=T)
    with InputNode() as inp:
        out = b.step.bind(a.step.bind(inp))
    compiled = _compile(out)
    try:
        assert compiled.execute(5).get() == 16
        for i in range(20):
            assert compiled.execute(i).get() == i + 11
        refs = [compiled.execute(i) for i in range(5)]
        assert [r.get() for r in refs] == [11, 12, 13, 14, 15]
    finally:
        compiled.teardown()


def test_compiled_constant_args(runtime):
    a = Stage.remote(0)
    rt.get(a.step.remote(0), timeout=T)
    with InputNode() as inp:
        out = a.scaled.bind(inp, 3)
    compiled = _compile(out)
    try:
        assert compiled.execute(7).get() == 21
    finally:
        compiled.teardown()


def test_compiled_error_propagates(runtime):
    a, b = Stage.remote(1), Stage.remote(2)
    rt.get([a.step.remote(0), b.step.remote(0)], timeout=T)
    with InputNode() as inp:
        out = b.step.bind(a.boom.bind(inp))
    compiled = _compile(out)
    try:
        with pytest.raises(TaskError):
            compiled.execute(1).get()
        with pytest.raises(TaskError):
            compiled.execute(2).get()
    finally:
        compiled.teardown()


def test_channel_direct(tmp_path):
    path = str(tmp_path / "direct")
    ch = ShmChannel(path, capacity=1024, create=True)
    try:
        ch.write(b"hello")
        tag, payload = ch.read()
        assert payload == b"hello"
        with pytest.raises(ChannelTimeout):
            ch.read(timeout=0.1)
        with pytest.raises(ValueError):
            ch.write(b"x" * 2048)
    finally:
        ch.close(unlink=True)


def test_ring_channel_multi_slot(tmp_path):
    path = str(tmp_path / "ring")
    ch = ShmChannel(path, capacity=1024, create=True, n_slots=4)
    try:
        for i in range(4):
            ch.write(b"m%d" % i)
        assert ch.occupancy() == 4
        assert not ch.writable()
        with pytest.raises(ChannelTimeout):
            ch.write(b"overflow", timeout=0.1)
        with pytest.raises(ChannelTimeout):
            ch.wait_writable(timeout=0.1)
        for i in range(4):
            _, payload = ch.read()
            assert payload == b"m%d" % i
        assert ch.occupancy() == 0
        ch.wait_writable(timeout=0.1)
        for i in range(25):
            ch.write(b"w%d" % i)
            if ch.occupancy() >= 3:
                ch.read()
        while ch.readable():
            ch.read()
        ch.write(b"raw", tag=TAG_BYTES)
        tag, payload = ch.read()
        assert tag == TAG_BYTES and payload == b"raw"
        # typed arrays and tensors interleave with serialized messages
        ch.write_array(np.arange(6, dtype=np.float32))
        ch.write_array(torch.arange(6, dtype=torch.bfloat16))
        ch.write(b"plain")
        _, arr = ch.read()
        np.testing.assert_array_equal(arr, np.arange(6, dtype=np.float32))
        _, t = ch.read()
        assert torch.equal(t, torch.arange(6, dtype=torch.bfloat16))
        _, payload = ch.read()
        assert payload == b"plain"
        peer = ShmChannel(path)
        assert peer.n_slots == 4 and peer.capacity == 1024
        peer.close()
    finally:
        ch.close(unlink=True)


def test_channel_write_serialized_segments(tmp_path):
    from ray_tpu_torch.core import serialization

    path = str(tmp_path / "wser")
    ch = ShmChannel(path, capacity=64 * 1024, create=True, n_slots=2)
    try:
        value = {"x": np.arange(100, dtype=np.int64), "y": "z"}
        ch.write_serialized(serialization.serialize(value))
        _, payload = ch.read()
        back = serialization.deserialize(payload)
        np.testing.assert_array_equal(back["x"], value["x"])
        assert back["y"] == "z"
    finally:
        ch.close(unlink=True)


def test_ref_get_idempotent(runtime):
    a = Stage.remote(1)
    rt.get(a.step.remote(0), timeout=T)
    with InputNode() as inp:
        out = a.step.bind(inp)
    compiled = _compile(out)
    try:
        ref = compiled.execute(5)
        assert ref.get() == 6
        assert ref.get() == 6
        assert ref.get(timeout=0.001) == 6
        r1, r2 = compiled.execute(1), compiled.execute(2)
        assert r2.get() == 3
        assert r1.get() == 2
        assert r2.get() == 3
        boom = Stage.remote(0)
        rt.get(boom.step.remote(0), timeout=T)
        with InputNode() as inp:
            bout = boom.boom.bind(inp)
        bcompiled = _compile(bout)
        try:
            bref = bcompiled.execute(9)
            with pytest.raises(TaskError) as e1:
                bref.get()
            with pytest.raises(TaskError) as e2:
                bref.get()
            assert e1.value is e2.value
        finally:
            bcompiled.teardown()
    finally:
        compiled.teardown()


def test_max_inflight_overlap(runtime):
    a, b = Stage.remote(1), Stage.remote(10)
    rt.get([a.step.remote(0), b.step.remote(0)], timeout=T)
    with InputNode() as inp:
        out = b.step.bind(a.step.bind(inp))
    compiled = _compile(out, max_inflight=4)
    try:
        refs = [compiled.execute(i, timeout=20.0) for i in range(4)]
        assert [r.get(timeout=30) for r in refs] == [11, 12, 13, 14]
    finally:
        compiled.teardown()


def test_execute_timeout_leaves_dag_healthy(runtime):
    a = Stage.remote(1)
    rt.get(a.step.remote(0), timeout=T)
    with InputNode() as inp:
        out = a.slow.bind(inp)
    compiled = _compile(out, max_inflight=1)
    try:
        refs = [compiled.execute(i, timeout=10.0) for i in range(2)]
        with pytest.raises(ChannelTimeout):
            while True:
                refs.append(compiled.execute(99, timeout=0.2))
        for i, r in enumerate(refs):
            assert r.get(timeout=30) == (i + 1 if i < 2 else 100)
        assert compiled.execute(7, timeout=10.0).get(timeout=30) == 8
    finally:
        compiled.teardown()


def test_teardown_with_inflight_executions(runtime):
    a, b = Stage.remote(1), Stage.remote(10)
    rt.get([a.step.remote(0), b.step.remote(0)], timeout=T)
    with InputNode() as inp:
        out = b.step.bind(a.step.bind(inp))
    compiled = _compile(out, max_inflight=4)
    paths = [ch.path for ch in compiled._channels]
    for i in range(4):
        compiled.execute(i, timeout=10.0)
    compiled.teardown()
    for p in paths:
        assert not os.path.exists(p), p
    with pytest.raises(RuntimeError):
        compiled.execute(0)


def test_pipelined_stress_50x(runtime):
    a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    rt.get([a.step.remote(0), b.step.remote(0), c.step.remote(0)],
           timeout=T)
    with InputNode() as inp:
        out = c.step.bind(b.step.bind(a.step.bind(inp)))
    compiled = _compile(out, max_inflight=4)
    try:
        for _ in range(50):
            pending = collections.deque()
            for i in range(8):
                if len(pending) >= 4:
                    j, r = pending.popleft()
                    assert r.get(timeout=T) == j + 111
                pending.append((i, compiled.execute(i, timeout=T)))
            while pending:
                j, r = pending.popleft()
                assert r.get(timeout=T) == j + 111
    finally:
        compiled.teardown()


def test_dag_metrics_in_registry(runtime):
    from ray_tpu_torch.experimental.channel import flush_channel_metrics
    from ray_tpu_torch.util.metrics import registry

    a = Stage.remote(1)
    rt.get(a.step.remote(0), timeout=T)
    with InputNode() as inp:
        out = a.step.bind(inp)
    compiled = _compile(out)
    try:
        before = registry().snapshot().get(
            "port_dag_executions_total", {"values": {}})
        base = sum(before["values"].values())
        for i in range(5):
            assert compiled.execute(i).get() == i + 1
        flush_channel_metrics()
        snap = registry().snapshot()
        execs = sum(snap["port_dag_executions_total"]["values"].values())
        assert execs - base == 5
        ser = sum(snap["port_dag_channel_serialized_bytes_total"]["values"]
                  .values())
        assert ser > 0
        assert "port_dag_ring_occupancy" in snap
    finally:
        compiled.teardown()


def test_diamond_dag(runtime):
    a, b, c = Worker2.remote(), Worker2.remote(), Worker2.remote()
    with InputNode() as inp:
        left = a.inc.bind(inp)
        right = b.double.bind(inp)
        out = c.add.bind(left, right)
    compiled = _compile(out)
    try:
        for x in (0, 3, 10):
            assert compiled.execute(x).get(timeout=T) == (x + 1) + 2 * x
        refs = [compiled.execute(i) for i in range(3)]
        assert [r.get(timeout=T) for r in refs] == [3 * i + 1
                                                    for i in range(3)]
    finally:
        compiled.teardown()


def test_multi_consumer_fanout(runtime):
    a, b, c, d = (Worker2.remote() for _ in range(4))
    with InputNode() as inp:
        base = a.inc.bind(inp)
        l2 = b.double.bind(base)
        r2 = c.inc.bind(base)
        out = d.add.bind(l2, r2)
    compiled = _compile(out)
    try:
        assert compiled.execute(5).get(timeout=T) == 3 * 5 + 4
        assert compiled.execute(0).get(timeout=T) == 4
    finally:
        compiled.teardown()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_channel_zero_serialization(runtime, dtype):
    """Tensor edges: torch results cross actor boundaries on the typed
    tensor path with ZERO serialization-layer bytes, bfloat16 included
    (numpy has no bfloat16: the payload names the torch dtype). The
    reference's observable-state loop: fresh actors a round until the
    deadline, only then fail with the last counterexample."""
    deadline = time.monotonic() + T
    while True:
        a, b = Worker2.remote(), Worker2.remote()
        with InputNode() as inp:
            if dtype == "float32":
                out = b.rowsum.bind(a.matmul.bind(inp))
            else:
                out = b.rowsum.bind(a.to_bf16.bind(inp))
        compiled = _compile(out, buffer_size_bytes=8 << 20,
                            device_channels=True)
        try:
            x = np.arange(128 * 64, dtype=np.float32).reshape(128, 64)
            got = compiled.execute(x).get(timeout=120)
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            tx = torch.from_numpy(x)
            if dtype == "float32":
                want, mid_bytes = (tx @ tx.T).sum(dim=1), 128 * 128 * 4
                torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
            else:
                want = (tx.to(torch.bfloat16) * 2).sum(dim=1)
                mid_bytes = 128 * 64 * 2
                assert got.dtype == torch.bfloat16
                assert torch.equal(got, want)
            stats_a = rt.get(a.chan_stats.remote(), timeout=T)
            assert stats_a["tensor_bytes"] >= mid_bytes
            assert stats_a["serialized_bytes"] == 0, stats_a
            stats_b = rt.get(b.chan_stats.remote(), timeout=T)
            assert stats_b["tensor_bytes"] >= 128 * got.element_size()
            assert stats_b["serialized_bytes"] == 0, stats_b
            return
        except AssertionError:
            if time.monotonic() > deadline:
                raise
        finally:
            compiled.teardown()
        time.sleep(0.2)


def test_bind_builds_a_class_method_node(runtime):
    from ray_tpu_torch.dag import ClassMethodNode

    a = Stage.remote(1)
    with InputNode() as inp:
        node = a.step.bind(inp)
    assert isinstance(node, ClassMethodNode)
    assert node.method_name == "step" and node.args_template == [("edge", 0)]


# --------------------------------------------------------------------------- #
# wire format: the port's channel against the JAX package's
# --------------------------------------------------------------------------- #


def _frame_msgs():
    from ray_tpu_torch.experimental.channel import pack_stream_frame

    return [
        ("data", TAG_DATA, b"\x80\x05pickled-ish"),
        ("bytes", TAG_BYTES, b"raw body"),
        ("error", TAG_ERROR, b"an error payload"),
        ("stream", TAG_STREAM, pack_stream_frame(7, 1 | 4, b'{"t": 1}')),
        ("stream_chunk", TAG_STREAM, pack_stream_frame(3, 0, b"chunk")),
    ]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_wire_format_matches_the_jax_channel(direction, tmp_path):
    """Every tag one package's ``ShmChannel`` writes reads back through
    the other's: the ring header, the slot header, the stream framing
    and the float32 numpy TENSOR payload are the same bytes."""
    from ray_tpu.experimental import channel as jch

    path = str(tmp_path / f"wire_{direction}")
    if direction == "port_to_jax":
        writer = ShmChannel(path, capacity=4096, create=True, n_slots=8)
        reader = jch.ShmChannel(path)
    else:
        writer = jch.ShmChannel(path, capacity=4096, create=True, n_slots=8)
        reader = ShmChannel(path)
    try:
        for name, tag, payload in _frame_msgs():
            writer.write(payload, tag=tag)
            got_tag, got = reader.read(timeout=5)
            assert (got_tag, bytes(got)) == (tag, payload), name
            if tag == TAG_STREAM:
                assert ch_mod.unpack_stream_frame(payload) \
                    == jch.unpack_stream_frame(payload)
        arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 7
        writer.write_array(arr)
        got_tag, got = reader.read(timeout=5)
        assert got_tag == TAG_TENSOR
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, arr)
        assert ch_mod.tensor_payload(arr)[0] == jch.tensor_payload(arr)[0]
        writer.write(b"", tag=TAG_STOP)
        with pytest.raises((ChannelClosed, jch.ChannelClosed)):
            reader.read(timeout=5)
    finally:
        reader.close()
        writer.close(unlink=True)


def _real_header(ch):
    w = struct.unpack_from("<Q", ch._mm, 0)[0]
    r = struct.unpack_from("<Q", ch._mm, 8)[0]
    seqs = tuple(
        struct.unpack_from("<Q", ch._mm,
                           ch_mod._HDR_SIZE + i * ch._slot_stride)[0]
        for i in range(ch.n_slots))
    return (w, r, seqs)


@pytest.mark.parametrize("n_slots", [1, 2, 3])
def test_ring_conformance_model_vs_port_channel(tmp_path, n_slots):
    """The port's ``ShmChannel`` and the JAX package's ``RingModel``
    through identical traces: after every op the mapped header
    (write_seq, read_seq, per-slot seqs) and the predicates agree."""
    import random

    from ray_tpu.tools.lint.ring_model import RingModel

    rng = random.Random(7 + n_slots)
    ch = ShmChannel(str(tmp_path / f"conf_{n_slots}"), capacity=256,
                    create=True, n_slots=n_slots)
    model = RingModel(n_slots)
    try:
        script = (["w"] * n_slots + ["r"] * n_slots) * 2
        occ = 0
        for _ in range(60):
            opts = ([] if occ >= n_slots else ["w"]) + \
                ([] if occ == 0 else ["r"])
            op = rng.choice(opts)
            occ += 1 if op == "w" else -1
            script.append(op)
        for step, op in enumerate(script):
            if op == "w":
                assert ch.writable() and model.writable(), step
                if step % 3 == 0:
                    ch.write_array(torch.full((1 + step % 8,), step,
                                              dtype=torch.bfloat16))
                else:
                    ch.write(b"x" * (1 + step % 32))
                model.write()
            else:
                assert ch.readable() and model.readable(), step
                ch.read(timeout=5.0)
                model.read()
            assert _real_header(ch) == model.header(), (step, op)
            assert ch.occupancy() == model.occupancy()
            assert ch.writable() == model.writable()
            assert ch.readable() == model.readable()
    finally:
        ch.close(unlink=True)


# --------------------------------------------------------------------------- #
# the torch tensor path
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("value", [
    torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
    torch.arange(12, dtype=torch.float32).reshape(3, 4).T,  # strided
    torch.tensor(3.5, dtype=torch.float64),
    torch.tensor([True, False, True]),
    torch.empty(0, 5, dtype=torch.int32),
    np.arange(5, dtype=np.int16),
    np.float32(2.5),
], ids=["bf16", "transposed", "0d", "bool", "empty", "numpy", "np_scalar"])
def test_tensor_round_trip_keeps_type_dtype_and_bytes(value, tmp_path):
    path = str(tmp_path / "tensor_rt")
    ch = ShmChannel(path, capacity=4096, create=True, n_slots=2)
    try:
        assert ch_mod.is_arraylike(value)
        before = dict(ch_mod.STATS)
        ch.write_array(value)
        tag, got = ch.read(timeout=5)
        assert tag == TAG_TENSOR
        assert ch_mod.STATS["serialized_bytes"] == before["serialized_bytes"]
        if isinstance(value, torch.Tensor):
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            assert got.dtype == value.dtype and got.shape == value.shape
            assert torch.equal(got, value)
        else:
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, value)
            assert got.dtype == np.asarray(value).dtype
    finally:
        ch.close(unlink=True)


def test_object_arrays_and_plain_values_are_not_arraylike():
    assert not ch_mod.is_arraylike(np.array([object()], dtype=object))
    assert not ch_mod.is_arraylike([1.0, 2.0])
    assert not ch_mod.is_arraylike(3.0)
    assert not ch_mod.is_arraylike(torch.eye(3).to_sparse())


def test_cuda_payload_without_a_card_raises(tmp_path):
    """A tensor written from a card must land on the reader's card; a
    reader without one refuses it, never falling back to the CPU."""
    assert not torch.cuda.is_available()
    meta = b'{"dtype": "torch.bfloat16", "shape": [2], "device": "cuda"}'
    payload = struct.pack("<I", len(meta)) + meta + b"\x00\x3f\x80\x3f"
    with pytest.raises(RuntimeError, match="no card"):
        ch_mod.parse_tensor(payload, 0)
    path = str(tmp_path / "cuda_meta")
    ch = ShmChannel(path, capacity=256, create=True)
    try:
        ch.write(payload, tag=TAG_TENSOR)
        with pytest.raises(RuntimeError, match="no card"):
            ch.read(timeout=5)
    finally:
        ch.close(unlink=True)


def _duck_typed_arraylike(v) -> bool:
    """The JAX package's eligibility test, verbatim."""
    return (hasattr(v, "dtype") and hasattr(v, "shape")
            and hasattr(v, "__array__")
            and not getattr(v.dtype, "hasobject", True))


def test_planted_duck_typed_arraylike_sends_tensors_through_the_serializer(
        runtime, monkeypatch):
    """Planted fault: the JAX package's duck-typed eligibility test. A
    torch dtype has no ``hasobject``, so it calls every tensor "not
    arraylike" and the driver's input path pickles it. The gate — no
    serialized bytes for a tensor input — passes with the port's test
    and fails with the planted one."""
    import ray_tpu_torch.dag as dag_mod

    x = torch.arange(64, dtype=torch.bfloat16)
    assert ch_mod.is_arraylike(x) and not _duck_typed_arraylike(x)
    a = Worker2.remote()
    with InputNode() as inp:
        out = a.double.bind(inp)
    compiled = _compile(out, device_channels=True)

    def serialized_by_one_execute():
        before = ch_mod.STATS["serialized_bytes"]
        got = compiled.execute(x).get(timeout=T)
        assert torch.equal(got, x * 2)
        return ch_mod.STATS["serialized_bytes"] - before

    try:
        assert serialized_by_one_execute() == 0
        monkeypatch.setattr(dag_mod, "_is_arraylike", _duck_typed_arraylike)
        assert serialized_by_one_execute() > 0  # the gate catches it
    finally:
        compiled.teardown()


def test_planted_early_slot_release_is_caught(monkeypatch, tmp_path):
    """Planted fault: the reader hands back a view of the slot instead of
    a copy, so the slot is released while the tensor still lives in it.
    The gate — a value read stays what was written after the writer
    reuses the slot — passes with the port's read and fails with the
    planted one."""
    def read_back_after_overwrite():
        path = str(tmp_path / "early_release")
        ch = ShmChannel(path, capacity=1024, create=True, n_slots=1)
        try:
            first = torch.arange(8, dtype=torch.bfloat16)
            ch.write_array(first)
            _, got = ch.read(timeout=5)
            ch.write_array(torch.full((8,), 7.0, dtype=torch.bfloat16))
            ok = torch.equal(got, first)
            del got
            ch.read(timeout=5)
            return ok
        finally:
            ch.close(unlink=True)

    assert read_back_after_overwrite()

    def view_not_copy(self, off):
        (meta_len,) = struct.unpack_from("<I", self._mm, off)
        body = off + 4 + meta_len
        return torch.frombuffer(self._mm, dtype=torch.bfloat16, count=8,
                                offset=body)

    monkeypatch.setattr(ShmChannel, "_read_tensor", view_not_copy)
    assert not read_back_after_overwrite()  # the gate catches it

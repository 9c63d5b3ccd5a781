"""Shared-memory SPSC ring channels for compiled graphs (port of
``ray_tpu/experimental/channel.py``).

Analog of the reference's shared_memory_channel.py (601 LoC) + mutable
plasma objects (experimental_mutable_object_manager.cc): an N-slot ring
buffer in /dev/shm mapped by both endpoint processes. The fast path is
two mmap writes plus one doorbell syscall — no scheduler, no per-call
task bookkeeping. Waiting uses named-FIFO doorbells rather than
spinning: on an oversubscribed host, competing spinners starve the very
producer they wait on.

Ring layout (v2 — generalizes the original single-slot rendezvous):

    global header (32 B):
        [write_seq u64][read_seq u64][n_slots u64][slot_cap u64]
    then n_slots slots of (24 B header + slot_cap payload):
        [seq u64][msg_len u64][tag u8][pad 7]

Each endpoint writes ONLY its own fields: the writer owns ``write_seq``
and every slot header it publishes; the reader owns ``read_seq``. The
writer may advance while ``write_seq - read_seq < n_slots`` (bounded
backpressure: up to n_slots messages in flight per edge instead of the
old at-most-one rendezvous), publishing into slot ``write_seq %
n_slots``: payload first, then the slot header (seq stamped LAST inside
it so the reader can cross-check), then the global ``write_seq`` commit,
then the doorbell. The reader consumes slot ``read_seq % n_slots`` once
``write_seq > read_seq``. n_slots=1 degenerates to the original
rendezvous protocol. Geometry lives in the mapped header, so the opening
end needs only the path.

The header/slot state machine has a pure, side-effect-free twin in
``ray_tpu/tools/lint/ring_model.py``, which the JAX package's lint
exhaustively model-checks (lost wakeup, torn publish, backpressure,
deadlock); tests/test_torch_compiled_dag.py drives THIS class and that
model through identical traces, and reads this class's messages with the
JAX package's channel (and the other way round): the ring layout, the
slot header and every tag's payload are the JAX package's, byte for
byte.

The typed tensor path (``TAG_TENSOR``) carries numpy arrays and torch
tensors, CPU or CUDA, bfloat16 included, with no serializer on either
end. A numpy payload's meta is the JAX package's (``dtype``, ``shape``);
a torch payload's names a torch dtype (``torch.bfloat16``) and the
source's device type. A CUDA tensor is copied device-to-host straight
into the mapped slot and lands, on the reading side, on that process's
current card; a reader without a card refuses it.
"""

from __future__ import annotations

import mmap
import os
import select
import struct
import sys
import time
from typing import Optional

_GHDR = struct.Struct("<QQQQ")  # write_seq, read_seq, n_slots, slot_cap
_WSEQ = struct.Struct("<Q")     # at offset 0 (writer-owned)
_RSEQ = struct.Struct("<Q")     # at offset 8 (reader-owned)
# parked flags (one byte each, own 8-byte lanes): set by a peer right
# before it parks on its doorbell FIFO, cleared when it resumes. The
# other end only pays the doorbell write() syscall when the flag is up —
# in the hot loop both ends are spinning and every bell is elided
# (futex-style wakeup elision). Set-flag-then-recheck on the parking
# side vs publish-then-check-flag on the ringing side closes the race.
_OFF_READER_PARKED = 32
_OFF_WRITER_PARKED = 40
_HDR_SIZE = 48
_SHDR = struct.Struct("<QQB7x")  # per-slot: seq, msg_len, tag (writer-owned)
TAG_DATA = 0
TAG_STOP = 1
TAG_ERROR = 2
TAG_TENSOR = 3  # typed array payload: no serialization layer at all
TAG_BYTES = 4   # raw bytes payload: serializer skipped entirely
TAG_STREAM = 5  # one frame of a multi-reply stream (see stream_frame)

# ---------------------------------------------------------------- stream
# Multi-reply framing for TAG_STREAM slots. A streaming node answers one
# request with MANY ring slots; each slot carries a fixed header binding
# the frame to its request (``corr`` — on an SPSC lane the driver assigns
# input seqs in ring-write order, so the worker's arrival counter IS the
# driver seq) plus flag bits. Framing rides INSIDE the slot payload: the
# ring publish/consume protocol itself is unchanged (same model as
# tools/lint/ring_model.py — no new ordering states).
_STREAM_HDR = struct.Struct("<QB")
STREAM_F_FINAL = 1   # last frame for this corr; completes the request
STREAM_F_ERROR = 2   # body is a serialized TaskError (implies FINAL)
STREAM_F_RAW = 4     # body is raw bytes (serializer skipped); else
#                      body is serializer output


def pack_stream_frame(corr: int, flags: int, body: bytes) -> bytes:
    return _STREAM_HDR.pack(corr, flags) + body


def unpack_stream_frame(payload: bytes):
    """-> (corr, flags, body)"""
    corr, flags = _STREAM_HDR.unpack_from(payload, 0)
    return corr, flags, payload[_STREAM_HDR.size:]

# per-process transfer accounting (the "host-copy metric": serialized
# bytes went through the pickle layer; tensor/raw bytes moved
# buffer->buffer). The authoritative hot-path counters — the registry
# metrics below are flushed FROM these off the dispatch path.
STATS = {"serialized_bytes": 0, "tensor_bytes": 0, "raw_bytes": 0,
         "messages": 0,
         # full-tensor intermediate copies made ASSEMBLING a tensor
         # payload on a send path (shm packs slots in place = 0; the
         # net ring writevs framed segments = 0, except on sends that
         # fall back to joining, e.g. model-conformance harness sends)
         "tensor_copy_bytes": 0}

# Backpressure/stall accounting, same discipline as STATS: the wait path
# bumps this dict (GIL-atomic enough for monotonic accumulation — the
# rare lost fraction of a concurrent add is noise against seconds-scale
# stalls), keyed by (channel role-name, "read"|"write"). The net ring
# shares both dicts so one flush covers every ring transport.
STALLS: dict = {}
# Go-Back-N retransmissions (core/net_ring.py bumps; flushed here)
RETRANSMITS = [0]

# Registry metrics (satellite: the channel accounting must be visible to
# the standard observability surfaces, not just a module dict). Counter
# increments take the registry lock, so the hot path only bumps STATS;
# deltas are flushed at most every _METRICS_INTERVAL_S per process plus
# on channel close / explicit flush_channel_metrics().
from ray_tpu_torch.util import flight_recorder as _fr
from ray_tpu_torch.util.metrics import Counter as _Counter
from ray_tpu_torch.util.metrics import Gauge as _Gauge

_m_serialized = _Counter(
    "port_dag_channel_serialized_bytes_total",
    "Bytes that crossed compiled-graph channels through the serializer")
_m_tensor = _Counter(
    "port_dag_channel_tensor_bytes_total",
    "Bytes that crossed compiled-graph channels on the typed tensor path")
_m_occupancy = _Gauge(
    "port_dag_ring_occupancy",
    "In-flight messages in a compiled-graph ring channel",
    tag_keys=("channel",))
_m_ring_stall = _Counter(
    "port_dag_ring_stall_seconds_total",
    "Seconds ring-channel endpoints spent blocked waiting (write = "
    "backpressure stall on a full ring, read = waiting for data)",
    tag_keys=("channel", "role"))
_m_retransmits = _Counter(
    "port_net_ring_retransmits_total",
    "Go-Back-N retransmissions on cross-host net-ring channels")

# flight-recorder span plane for the same seams (one registration site
# per name — graftlint metrics-hygiene checks this statically)
_sp_wait_write = _fr.register_span("ring.wait_write",
                                   tag_keys=("channel",))
_sp_wait_read = _fr.register_span("ring.wait_read",
                                  tag_keys=("channel",))
_sp_park = _fr.register_span("ring.park", tag_keys=("channel", "role"))

_METRICS_INTERVAL_S = 0.25
# hybrid-wait spin budget (checks before parking on the doorbell);
# (a bounded stretch of optimism per wait)
_SPIN_ITERS = 4000
_flushed = {"serialized_bytes": 0, "tensor_bytes": 0, "raw_bytes": 0}
_next_flush = [0.0]
# several exec-loop threads share STATS/_flushed; the delta computation
# must be atomic or two concurrent flushes double-count into the
# registry. Off the hot path (<=4 Hz), so a plain lock is fine.
import threading as _threading

_flush_lock = _threading.Lock()


_flushed_stalls: dict = {}
_flushed_retransmits = [0]


def flush_channel_metrics() -> None:
    """Push STATS/STALLS/RETRANSMITS deltas into the registry counters
    (tensor counter also covers TAG_BYTES traffic: both bypass the
    serialization layer)."""
    with _flush_lock:
        d = STATS["serialized_bytes"] - _flushed["serialized_bytes"]
        if d:
            _m_serialized.inc(d)
            _flushed["serialized_bytes"] = STATS["serialized_bytes"]
        d = (STATS["tensor_bytes"] - _flushed["tensor_bytes"]
             + STATS["raw_bytes"] - _flushed["raw_bytes"])
        if d:
            _m_tensor.inc(d)
            _flushed["tensor_bytes"] = STATS["tensor_bytes"]
            _flushed["raw_bytes"] = STATS["raw_bytes"]
        for key, v in list(STALLS.items()):
            d = v - _flushed_stalls.get(key, 0.0)
            if d > 0:
                _m_ring_stall.inc(d, tags={"channel": key[0],
                                           "role": key[1]})
                _flushed_stalls[key] = v
        d = RETRANSMITS[0] - _flushed_retransmits[0]
        if d:
            _m_retransmits.inc(d)
            _flushed_retransmits[0] = RETRANSMITS[0]


def _maybe_flush(chan: "ShmChannel") -> None:
    now = time.monotonic()
    if now < _next_flush[0]:
        return
    _next_flush[0] = now + _METRICS_INTERVAL_S
    flush_channel_metrics()
    try:
        _m_occupancy.set(float(chan.occupancy()),
                         tags={"channel": chan._metric_name})
    except Exception:
        pass  # mmap already closed (teardown race)


def _tensor_type():
    """``torch.Tensor`` when torch is loaded in this process, else None
    (a value can only be a tensor once torch is imported, so the check
    never imports it: most workers never touch a tensor)."""
    torch = sys.modules.get("torch")
    return getattr(torch, "Tensor", None)


def is_arraylike(v) -> bool:
    """Typed-tensor-channel eligibility (shared by the driver's input
    fast path and the executor's result path — they MUST agree or the
    same value routes down different paths at each end): a strided
    ``torch.Tensor`` (CPU or CUDA) or a numpy array or scalar of a
    non-object dtype. Named types, not duck typing: a torch dtype has no
    ``hasobject``, so the JAX package's attribute test would send every
    tensor through the serializer."""
    tensor = _tensor_type()
    if tensor is not None and isinstance(v, tensor):
        return v.layout is sys.modules["torch"].strided
    np = sys.modules.get("numpy")
    return (np is not None and isinstance(v, (np.ndarray, np.generic))
            and not v.dtype.hasobject)


def tensor_payload(arr):
    """TAG_TENSOR wire format: ``[meta_len u32][meta json][raw buffer]``.
    One format for every ring transport (shm slots pack it in place via
    ``write_array``; the net ring ships it as one payload) — the reader
    side is :func:`parse_tensor` either way. Returns ``(meta, raw)``:
    for numpy, ``raw`` is a uint8 view of the array (the JAX package's
    meta, byte for byte); for a tensor, a flat contiguous uint8 view of
    it, on the tensor's device (the writer decides where its bytes go:
    the shm slot copies them in place, the net ring to a host buffer)."""
    import json

    tensor = _tensor_type()
    if tensor is not None and isinstance(arr, tensor):
        t = arr.detach()
        if not t.is_contiguous():
            t = t.contiguous()
        meta = json.dumps({"dtype": str(t.dtype), "shape": list(t.shape),
                           "device": t.device.type}).encode()
        return meta, t.reshape(-1).view(sys.modules["torch"].uint8)
    import numpy as _np

    view = _np.asarray(arr)
    if not view.flags.c_contiguous:
        view = _np.ascontiguousarray(view)
    raw = view.reshape(-1).view(_np.uint8)
    meta = json.dumps({"dtype": str(view.dtype),
                       "shape": list(view.shape)}).encode()
    return meta, raw


def host_bytes(raw):
    """A host buffer holding ``raw``'s bytes, for a transport that sends
    from host memory (the net ring). Numpy: ``raw`` itself, borrowed
    (zero-copy). A CUDA tensor: one device-to-host copy into a fresh
    buffer, the transfer itself. A CPU tensor: a snapshot, counted in
    ``STATS["tensor_copy_bytes"]``: a tensor is mutable and a model may
    hand back a view of a buffer it keeps updating, while the net ring
    retains the payload until the peer acks it and retransmits it
    as-is."""
    tensor = _tensor_type()
    if tensor is None or not isinstance(raw, tensor):
        return raw
    if raw.device.type == "cpu":
        STATS["tensor_copy_bytes"] += raw.numel()
        return raw.clone().numpy()
    return raw.cpu().numpy()


def parse_tensor(buf, off: int):
    """Materialize a TAG_TENSOR payload from ``buf`` at ``off``, as a
    value of its own: the slot may be overwritten as soon as the read
    returns. Numpy comes back as numpy and a CPU tensor as a CPU tensor.
    A tensor written from a card lands on this process's current card
    (one host-to-device copy from the slot, complete before this
    returns); without a card the read raises — it never falls back to
    the CPU: the payload's own device type decides."""
    import json

    (meta_len,) = struct.unpack_from("<I", buf, off)
    off += 4
    meta = json.loads(bytes(buf[off:off + meta_len]))
    off += meta_len
    shape = tuple(meta["shape"])
    if meta["dtype"].startswith("torch."):
        return _parse_torch(buf, off, meta, shape)
    import numpy as _np

    dtype = _np.dtype(meta["dtype"])
    count = int(_np.prod(shape)) if shape else 1
    view = _np.frombuffer(buf, dtype=dtype, count=count,
                          offset=off).reshape(shape)
    return view.copy()


def _parse_torch(buf, off: int, meta: dict, shape: tuple):
    import warnings

    import torch

    dtype = getattr(torch, meta["dtype"][len("torch."):])
    if meta.get("device", "cpu") == "cpu":
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        raise RuntimeError(
            f"a {meta['device']} tensor of shape {list(shape)} arrived on "
            "a compiled-graph edge, and this process has no card to put "
            "it on")
    nbytes = torch.Size(shape).numel() * dtype.itemsize
    out = torch.empty(nbytes, dtype=torch.uint8, device=device)
    if nbytes:
        with warnings.catch_warnings():
            # a net ring's payload is immutable bytes; it is only read
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                                   offset=off)
        # a blocking copy: the bytes are in ``out`` when copy_ returns,
        # so the caller may hand the slot back to the writer
        out.copy_(src)
    return out.view(dtype).reshape(shape)


class ChannelTimeout(Exception):
    pass


class ChannelClosed(Exception):
    pass


class BatchItemError:
    """Per-item error carrier for ring-fed batch mode: a batch-capable
    compiled method returns one of these in its result list to fail ONE
    request of the batch (the exec loop ships it as a TAG_ERROR reply in
    that item's slot) without poisoning the batch-mates around it."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class ShmChannel:
    """One-directional single-producer single-consumer ring channel."""

    def __init__(self, path: str, capacity: int = 4 * 1024 * 1024,
                 create: bool = False, n_slots: int = 1):
        self.path = path
        # occupancy-gauge tag: the edge role ("e2_0", "out"), not the
        # per-DAG uid — keeps the registry tag set bounded across many
        # compiled DAGs in one process
        base = os.path.basename(path)
        if base.startswith("raytorch_chan_"):
            base = base[len("raytorch_chan_"):]
            base = base.split("_", 1)[-1]
        self._metric_name = base
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o600)
        self._mm = None
        self._bells = []
        try:
            if create:
                if n_slots < 1:
                    raise ValueError(f"n_slots must be >= 1, got {n_slots}")
                self.capacity = capacity
                self.n_slots = n_slots
                total = _HDR_SIZE + n_slots * (_SHDR.size + capacity)
                os.ftruncate(self._fd, total)  # zero-fills: flags start down
                self._mm = mmap.mmap(self._fd, total)
                _GHDR.pack_into(self._mm, 0, 0, 0, n_slots, capacity)
            else:
                # geometry rides in the mapped header — the opening end
                # does not need to agree on capacity/n_slots out of band
                self._mm = mmap.mmap(self._fd, _GHDR.size)
                _, _, n, cap = _GHDR.unpack_from(self._mm, 0)
                self._mm.close()
                self.capacity = cap
                self.n_slots = n
                total = _HDR_SIZE + n * (_SHDR.size + cap)
                self._mm = mmap.mmap(self._fd, total)
            self._slot_stride = _SHDR.size + self.capacity
            # doorbells: data_ready rings the reader, slot_free rings the
            # writer.  O_RDWR on a FIFO never blocks at open and works
            # for both ends.
            for suffix in (".rdy", ".free"):
                p = path + suffix
                if create:
                    try:
                        os.mkfifo(p, 0o600)
                    except FileExistsError:
                        pass
                self._bells.append(os.open(p, os.O_RDWR | os.O_NONBLOCK))
            self._bell_rdy, self._bell_free = self._bells
        except BaseException:
            # partial construction must not leak the mapping or fds (a
            # torn geometry header / missing fifo raises here): release
            # whatever was acquired, in reverse order
            if self._mm is not None:
                try:
                    self._mm.close()
                except Exception:
                    pass
            for fd in (self._fd, *self._bells):
                try:
                    os.close(fd)
                except OSError:
                    pass
            raise

    # ---- internals ----

    def _seqs(self):
        return _WSEQ.unpack_from(self._mm, 0)[0], \
            _RSEQ.unpack_from(self._mm, 8)[0]

    def _slot_off(self, seq: int) -> int:
        return _HDR_SIZE + (seq % self.n_slots) * self._slot_stride

    def _ring(self, fd: int) -> None:
        try:
            os.write(fd, b"\x00")
        except (BlockingIOError, OSError):
            pass  # full pipe still wakes the peer

    def _wait(self, ready, bell_fd: int, flag_off: int,
              timeout: Optional[float]) -> None:
        if ready():
            return
        # the wait is real: time it from here (the fast path above stays
        # untimed) — the stall feeds the per-(channel, role) counter and
        # a flight-recorder span, including on timeout
        role = "write" if flag_off == _OFF_WRITER_PARKED else "read"
        t0 = time.monotonic()
        try:
            self._wait_slow(ready, bell_fd, flag_off, timeout, role)
        finally:
            dur = time.monotonic() - t0
            key = (self._metric_name, role)
            STALLS[key] = STALLS.get(key, 0.0) + dur
            (_sp_wait_write if role == "write" else _sp_wait_read) \
                .end_at(t0, dur, self._metric_name)

    def _wait_slow(self, ready, bell_fd: int, flag_off: int,
                   timeout: Optional[float], role: str) -> None:
        # Hybrid wait: a bounded spin first — when the peer is actively
        # producing, the reply lands within microseconds and a futex-free
        # check loop beats a doorbell wakeup — yielding the core
        # every few checks so the peer can actually run on an
        # oversubscribed host. Only then raise the parked flag and sleep
        # on the doorbell FIFO (unbounded spinning starves the very
        # producer being awaited).
        for i in range(_SPIN_ITERS):
            if ready():
                return
            if i & 7 == 7:
                os.sched_yield()
        _sp_park.instant(self._metric_name, role)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                # flag BEFORE the recheck: a publish that lands between
                # the recheck and select sees the flag up and rings
                self._mm[flag_off] = 1
                if ready():
                    return
                remaining = 0.2 if deadline is None else min(
                    0.2, deadline - time.monotonic())
                if remaining <= 0:
                    raise ChannelTimeout(self.path)
                select.select([bell_fd], [], [], remaining)
                try:  # drain stale tokens; state re-checked by the loop
                    os.read(bell_fd, 4096)
                except (BlockingIOError, OSError):
                    pass
        finally:
            try:
                self._mm[flag_off] = 0
            except ValueError:
                pass  # mapping closed mid-park (teardown race)

    # ---- API ----

    def occupancy(self) -> int:
        """Messages currently in flight (written, not yet consumed)."""
        w, r = self._seqs()
        return w - r

    def writable(self) -> bool:
        w, r = self._seqs()
        return w - r < self.n_slots

    def readable(self) -> bool:
        w, r = self._seqs()
        return w > r

    def wait_writable(self, timeout: Optional[float] = None) -> None:
        """Block until a free slot exists WITHOUT writing. With a single
        writer thread, a channel observed writable stays writable until
        that thread writes (the reader only frees slots) — so a caller
        can wait on every edge of a multi-input round first and only
        then commit the writes, making the round all-or-nothing."""
        self._wait(self.writable, self._bell_free, _OFF_WRITER_PARKED,
                   timeout)

    def _publish(self, total_len: int, tag: int,
                 timeout: Optional[float], fill) -> None:
        """Ring publish protocol: wait for a free slot, let ``fill``
        write the payload bytes into it, commit the slot header
        (seq+len+tag), then the global write_seq (the reader checks the
        global seq before trusting the slot), then ring the doorbell.
        The only place the invariants live — every write path rides it."""
        if total_len > self.capacity:
            raise ValueError(
                f"message of {total_len}B exceeds channel slot capacity "
                f"{self.capacity}B (raise buffer_size_bytes)")
        self._wait(self.writable, self._bell_free, _OFF_WRITER_PARKED,
                   timeout)
        w, _ = self._seqs()
        off = self._slot_off(w)
        fill(self._mm, off + _SHDR.size)
        _SHDR.pack_into(self._mm, off, w + 1, total_len, tag)
        _WSEQ.pack_into(self._mm, 0, w + 1)
        if self._mm[_OFF_READER_PARKED]:
            self._ring(self._bell_rdy)
        STATS["messages"] += 1
        _maybe_flush(self)

    def write(self, payload: bytes, tag: int = TAG_DATA,
              timeout: Optional[float] = None) -> None:
        def fill(mm, off):
            mm[off:off + len(payload)] = payload

        self._publish(len(payload), tag, timeout, fill)
        if tag == TAG_DATA or tag == TAG_ERROR:
            STATS["serialized_bytes"] += len(payload)
        elif tag == TAG_BYTES or tag == TAG_STREAM:
            STATS["raw_bytes"] += len(payload)

    def write_serialized(self, sobj, timeout: Optional[float] = None) -> None:
        """Serializer output straight into the slot: packs the
        SerializedObject's wire segments into the mapped ring with no
        intermediate ``to_bytes()`` concatenation — the driver's input
        serialization buffer IS the channel slot."""
        total = sobj.total_bytes

        def fill(mm, off):
            for seg in sobj.iter_segments():
                n = seg.nbytes
                mm[off:off + n] = seg
                off += n

        self._publish(total, TAG_DATA, timeout, fill)
        STATS["serialized_bytes"] += total

    def write_array(self, arr, timeout: Optional[float] = None) -> None:
        """Typed-array fast path (reference: the NCCL tensor channel,
        torch_tensor_nccl_channel.py:191 — tensors bypass the
        serialization layer entirely). The buffer lands in the shared
        slot in ONE transfer: a numpy array by one memcpy, a tensor by
        ``Tensor.copy_`` into a uint8 tensor over the slot's mapped
        range (``torch.frombuffer``) — for a CUDA tensor that copy is
        the device-to-host DMA itself, with no staging buffer."""
        meta, raw = tensor_payload(arr)
        nbytes = raw.nbytes

        def fill(mm, off):
            struct.pack_into("<I", mm, off, len(meta))
            off += 4
            mm[off:off + len(meta)] = meta
            off += len(meta)
            if not nbytes:
                return
            tensor = _tensor_type()
            if tensor is not None and isinstance(raw, tensor):
                dst = sys.modules["torch"].frombuffer(
                    mm, dtype=raw.dtype, count=nbytes, offset=off)
                try:
                    dst.copy_(raw)
                finally:
                    del dst  # the mapping must not stay exported
            else:
                mm[off:off + nbytes] = memoryview(raw)

        self._publish(4 + len(meta) + nbytes, TAG_TENSOR, timeout, fill)
        STATS["tensor_bytes"] += nbytes

    def read(self, timeout: Optional[float] = None):
        self._wait(self.readable, self._bell_rdy, _OFF_READER_PARKED,
                   timeout)
        _, r = self._seqs()
        off = self._slot_off(r)
        seq, length, tag = _SHDR.unpack_from(self._mm, off)
        if seq != r + 1:  # writer crashed mid-publish / stale mapping
            raise ChannelClosed(
                f"{self.path}: slot seq {seq} != expected {r + 1}")
        body = off + _SHDR.size
        if tag == TAG_TENSOR:
            value = self._read_tensor(body)
            _RSEQ.pack_into(self._mm, 8, r + 1)
            if self._mm[_OFF_WRITER_PARKED]:
                self._ring(self._bell_free)
            return (TAG_TENSOR, value)
        payload = bytes(self._mm[body:body + length])
        _RSEQ.pack_into(self._mm, 8, r + 1)  # only the reader's field
        if self._mm[_OFF_WRITER_PARKED]:
            self._ring(self._bell_free)
        if tag == TAG_STOP:
            raise ChannelClosed(self.path)
        return (tag, payload) if tag in (TAG_ERROR, TAG_BYTES, TAG_STREAM) \
            else (TAG_DATA, payload)

    def _read_tensor(self, off: int):
        """Materialize the typed payload BEFORE acking the slot (the
        writer may overwrite after the ack): a copy, never a view of the
        mapping."""
        return parse_tensor(self._mm, off)

    def close(self, unlink: bool = False) -> None:
        try:
            flush_channel_metrics()
        except Exception:
            pass
        try:
            self._mm.close()
        except BufferError:
            pass
        for fd in (self._fd, *self._bells):
            try:
                os.close(fd)
            except OSError:
                pass
        if unlink:
            for p in (self.path, self.path + ".rdy", self.path + ".free"):
                try:
                    os.unlink(p)
                except OSError:
                    pass


def channel_path(name: str) -> str:
    base = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"
    return os.path.join(base, f"raytorch_chan_{name}")

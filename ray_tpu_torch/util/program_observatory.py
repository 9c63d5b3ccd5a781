"""Program observatory: a per-process registry of observed programs (port
of ``ray_tpu/util/xla_observatory.py``; there is no XLA in the port, so
the name drops it).

:func:`observe_program` wraps a callable, the counterpart of
``observe_compiled``. In eager PyTorch a "compile" is the first call under
a new input fingerprint (shape, dtype and device of every tensor leaf; a
plain Python scalar contributes only its type, so a decode position does
not fake a recompile on every token). A wrapper's first
``max_analysed`` such calls (:data:`ANALYSED_FIRST_CALLS`, one by
default) are the real calls, each run ONCE, inside an analysis:

- a ``TorchDispatchMode`` that counts the aten FLOPs by the formulas
  ``FlopCounterMode`` uses, sums the bytes of each non-view op's tensor
  inputs and outputs (the counterpart of ``cost_analysis()``'s bytes
  accessed) and keeps the high-water mark of the bytes the call
  allocated (with the arguments' bytes, the counterpart of
  ``memory_analysis()``'s argument + output + temp). It reads no
  allocator statistic and resets none, so a caller's
  ``torch.cuda.max_memory_allocated()`` reads what it would without it,
  and unlike ``FlopCounterMode`` it runs every op's own kernel, so
  results stay bitwise (:class:`_CountingMode`);
- the attention kernels' :class:`~ray_tpu_torch.ops.flash_attention.KernelTally`:
  the Hopper kernels launch through ``ctypes``, where no dispatch mode
  sees them, so each launch reports its exact ``attention_work``.

Its synchronised wall time is ``compile_seconds``. The analysis runs
every op through Python (about 0.2 s a call of Llama-3-8B on an H100),
and a decode engine meets a new fingerprint every page of KV length, so
later new fingerprints are not analysed: they are counted from the
fingerprint alone (``compiles``, ``recompiles``, ``variants``, churn)
and run as they are. The count columns (``flops``, ``bytes_accessed``,
``peak_bytes``) are those of the latest analysed call. A call is never
run twice: the train steps update params and optimizer state in place. The
analysis' own bookkeeping never raises into the call (a failure there
records the call without counts), and the function's own exceptions pass
through unchanged. Only a failure before the call starts (fingerprint,
entering the modes) falls back, permanently, to the plain function, as
JAX's wrapper does. Steady-state calls pay the fingerprint and one dict
lookup.

On the CPU the attention kernels' plain versions run and are counted as
the matmuls they are, over the full T x T; on the card the kernels count
the causal half. So one program counts other FLOPs on each device. JAX's
``cost_analysis`` counts a ``lax.scan`` body once whatever the trip
count; the port counts what runs.

Numeric columns also go to the metrics registry tagged ``{program}``
(``port_program_*``, each the counterpart of a ``ray_tpu_xla_*`` name),
and each first call records a ``program.first_call`` flight-recorder
span and a ``program.first_call`` compile event.

:func:`program_report` joins the counts with the measured flight-recorder
spans (``spmd.compute``, ``serve.decode_step``, ``serve.prefill``) into
per-program achieved FLOP/s, arithmetic intensity, MFU and a
compute-bound / memory-bound verdict against the card's peaks (the H100
table, :data:`PEAKS`). An unknown CUDA card gets no peaks, so no MFU and
no verdict; the CPU gets nominal, trend-only ceilings whose verdict is
not enforced. ``program_report(head=...)`` is the head-side fold across
processes behind ``GET /api/xla`` and ``python -m ray_tpu_torch xla``,
with the recompile storms of the head's health monitor
(``train/health.py``); the goodput ledger's compile column back-fills
from the ``program.first_call`` spans (``util/goodput.py``). Nothing of
the JAX package's observatory is left out; the fingerprint-only counting
of later first calls is the port's own (above).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ray_tpu_torch.core.config import global_config
from ray_tpu_torch.ops.flash_attention import KernelTally
from ray_tpu_torch.util import device_telemetry
from ray_tpu_torch.util import flight_recorder as _fr
from ray_tpu_torch.util.metrics import (Counter, Gauge, aggregate_series,
                                        registry)

__all__ = [
    "PEAKS",
    "ObservedProgram",
    "observe_program",
    "snapshot",
    "get_program",
    "program_names",
    "program_report",
    "publish_report",
    "format_programs",
    "peak_flops_per_chip",
    "peak_hbm_bytes_per_sec",
    "peaks_for",
    "reset_for_tests",
]

_sp_first_call = _fr.register_span("program.first_call",
                                   tag_keys=("program",))

_c_compiles = Counter(
    "port_program_compiles_total",
    "First calls per observed program (one per new input fingerprint of "
    "a wrapper, analysed or not)", tag_keys=("program",))
_c_recompiles = Counter(
    "port_program_recompiles_total",
    "First calls of an observed program under a NEW input fingerprint "
    "(shape churn)", tag_keys=("program",))
_c_compile_seconds = Counter(
    "port_program_compile_seconds_total",
    "Synchronised wall seconds of the analysed first calls per observed "
    "program", tag_keys=("program",))
_g_flops = Gauge(
    "port_program_flops",
    "Counted FLOPs (aten ops and the attention kernels) of the most "
    "recent analysed first call", tag_keys=("program",))
_g_bytes = Gauge(
    "port_program_bytes_accessed",
    "Counted bytes read and written of the most recent analysed first "
    "call",
    tag_keys=("program",))
_g_peak_bytes = Gauge(
    "port_program_peak_bytes",
    "Argument bytes plus the high-water mark of the bytes allocated in "
    "the most recent analysed first call", tag_keys=("program",))
_g_variants = Gauge(
    "port_program_variants",
    "Distinct input fingerprints seen for a program (for the decode "
    "engine this is the padded-bucket count)", tag_keys=("program",))
_g_churn = Gauge(
    "port_program_shape_churn",
    "Count of one observed fingerprint transition (old -> new), bounded "
    "per program so tag cardinality stays small",
    tag_keys=("program", "from", "to"))

# first calls analysed per wrapper; a later new fingerprint is counted,
# not analysed (None analyses every one)
ANALYSED_FIRST_CALLS = 1

# caps that bound metric tag cardinality and record growth
_MAX_CHURN_TAGS = 8
_MAX_CHURN_RECORDS = 16
_AVAL_STR_LEN = 120

_LOCK = threading.Lock()
_REGISTRY: Dict[str, "ProgramRecord"] = {}


class ProgramRecord:
    """Everything this process knows about one observed program."""

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.analysed = 0
        self.recompiles = 0
        self.compile_seconds = 0.0
        self.variants: Dict[tuple, dict] = {}   # fingerprint -> info
        self.churn: List[dict] = []             # bounded transition log
        self.last: Dict[str, Any] = {}          # latest analyses
        self.last_avals = ""
        self.last_fp: tuple = ()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "compiles": self.compiles,
            "analysed": self.analysed,
            "recompiles": self.recompiles,
            "compile_seconds": round(self.compile_seconds, 6),
            "variants": len(self.variants),
            "avals": self.last_avals,
            "churn": list(self.churn),
            "by_variant": [dict(v) for v in self.variants.values()],
            **self.last,
        }


# --------------------------------------------------------------------------- #
# Fingerprints
# --------------------------------------------------------------------------- #

_DTYPE_SHORT = {"float": "f", "uint": "u", "int": "i", "complex": "c",
                "bfloat": "bf", "bool": "b"}


def _short_dtype(dt) -> str:
    s = str(getattr(dt, "name", dt)).replace("torch.", "")
    for long, short in _DTYPE_SHORT.items():
        if s.startswith(long):
            return short + s[len(long):]
    return s


def _fingerprint(args, kwargs) -> tuple:
    """Hashable fingerprint of one call: the per-call hot path, so no
    string work happens here (``_describe`` renders it, and only on a
    first call).

    Shape, dtype and device per tensor leaf (shape and dtype for another
    array, e.g. a numpy param tree); any other leaf contributes only its
    type, so one analysis covers every value of a scalar."""
    fp: List[tuple] = []
    for leaf in tree_leaves((args, kwargs)):
        if isinstance(leaf, torch.Tensor):
            fp.append((leaf.dtype, tuple(leaf.shape), leaf.device))
            continue
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            fp.append((dtype, tuple(shape)))
        else:
            fp.append((type(leaf).__name__,))
    return tuple(fp)


def _describe(fp: tuple) -> str:
    """Compact human string for a fingerprint (first-call path only)."""
    parts: List[str] = []
    for entry in fp:
        if len(parts) >= 6:
            break
        if len(entry) >= 2:
            dtype, shape = entry[:2]
            dims = ",".join(str(d) for d in shape)
            parts.append(f"{_short_dtype(dtype)}[{dims}]")
    if len(fp) > 6:
        parts.append(f"+{len(fp) - 6} leaves")
    return ";".join(parts)[:_AVAL_STR_LEN]


def _churn_pair(old: tuple, new: tuple) -> Tuple[str, str]:
    """(from, to) of a transition between two fingerprints: only the
    leaves that changed, so a step whose params lead its arguments names
    the token or cache shapes that moved (the whole fingerprints when the
    leaf count changed)."""
    if len(old) == len(new):
        changed = [i for i, (a, b) in enumerate(zip(old, new)) if a != b]
        old = tuple(old[i] for i in changed)
        new = tuple(new[i] for i in changed)
    return _describe(old), _describe(new)


# --------------------------------------------------------------------------- #
# The analysis of a first call
# --------------------------------------------------------------------------- #

# allocations that move no data: their outputs are counted live, not
# accessed
_ALLOCATIONS = frozenset(
    getattr(torch.ops.aten, name) for name in
    ("empty", "empty_strided", "empty_like", "new_empty",
     "new_empty_strided"))


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    st = t.untyped_storage()
    return (t.device, st.data_ptr()), st


def _op_tensors(args, kwargs) -> List[torch.Tensor]:
    """The tensors of an aten op's arguments or outputs: top level, or
    in a list or tuple (an aten schema nests no deeper)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


# (op, device type) -> whether it runs as its composite; ops are few and
# the answer is fixed for the process
_COMPOSITE: Dict[tuple, bool] = {}


def _composite_to_run(func, tensors) -> bool:
    """Whether ``func`` reaches the mode as a composite that the
    dispatcher would run as its CompositeImplicitAutograd decomposition
    (no kernel of the tensors' backend, none CompositeExplicit): under
    ``inference_mode`` ``aten.matmul`` and ``aten.einsum`` arrive so, and
    their matmuls are counted only inside the decomposition. An op with a
    kernel of its own (``aten.silu_backward`` on CPU and CUDA) runs that
    kernel: its decomposition would round otherwise in bf16."""
    if not tensors or tensors[0].device.type not in ("cpu", "cuda"):
        return False
    key = (func, tensors[0].device.type)
    hit = _COMPOSITE.get(key)
    if hit is None:
        has = torch._C._dispatch_has_kernel_for_dispatch_key
        name = func.name()
        hit = _COMPOSITE[key] = (
            has(name, "CompositeImplicitAutograd")
            and not has(name, "CompositeExplicitAutograd")
            and not has(name, key[1].upper()))
    return hit


class _CountingMode(TorchDispatchMode):
    """The aten side of an analysis, in one pass over the dispatched ops:

    - FLOPs by ``torch.utils.flop_counter``'s formulas (the ones
      ``FlopCounterMode`` uses, keyed by op);
    - bytes each non-view op reads and writes: its tensor inputs and
      outputs, each counted once per argument;
    - bytes live from allocations made under the mode: new storages
      among the outputs, released through weak references when their
      memory is freed, and their high-water mark.

    ``FlopCounterMode`` itself is not used: it decomposes every op
    outside its formula table that has a composite kernel, kernels of
    its own or not, and ``aten.silu_backward``'s decomposition moves a
    bf16 train step's gradients. This mode decomposes only what would run
    decomposed anyway (:func:`_composite_to_run`), so results stay
    bitwise. Its bookkeeping never raises into the call."""

    def __init__(self, arg_keys):
        super().__init__()
        self.flops: Dict[str, int] = {}
        self.bytes = 0
        self.live = 0
        self.peak_live = 0
        self.failed = False
        self._arg_keys = arg_keys
        self._live: Dict[Any, int] = {}
        # storages are freed on whichever thread drops them last, maybe
        # by the GC on a thread inside ``with self._lock``: the finalizer
        # only queues the key (no lock), and the lock's holders drain
        # the queue (the runtime's ObjectRef drop queue, the same way)
        self._freed: "collections.deque" = collections.deque()
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins, decompose = [], False
        try:
            ins = _op_tensors(args, kwargs)
            decompose = isinstance(func, torch._ops.OpOverload) \
                and _composite_to_run(func, ins)
        except Exception:  # noqa: BLE001 — never raise into the call
            self.failed = True
        if decompose:
            with self:
                return func._op_dk(
                    torch._C.DispatchKey.CompositeImplicitAutograd,
                    *args, **kwargs)
        out = func(*args, **kwargs)
        try:
            self._note(func, args, kwargs, ins, out)
        except Exception:  # noqa: BLE001 — never raise into the call
            self.failed = True
        return out

    def _note(self, func, args, kwargs, ins, out) -> None:
        packet = func._overloadpacket
        count = flop_registry.get(packet)
        if count is not None:
            with self._lock:
                self._drain_freed()
                self.flops[str(packet)] = self.flops.get(str(packet), 0) \
                    + int(count(*args, **kwargs, out_val=out))
        outs = _op_tensors(out if isinstance(out, tuple) else (out,), {})
        if not func.is_view and packet not in _ALLOCATIONS:
            nbytes = sum(_tensor_bytes(t) for t in outs) + sum(
                _tensor_bytes(t) for t in ins)
            with self._lock:
                self._drain_freed()
                self.bytes += nbytes
        for t in outs:
            key, st = _storage_key(t)
            nbytes = st.nbytes()
            if not nbytes or key in self._arg_keys:
                continue
            with self._lock:
                # a freed storage's address may be reused: drain first
                self._drain_freed()
                if key in self._live:
                    continue
                self._live[key] = nbytes
                self.live += nbytes
                self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(st, self._freed.append, key)

    def _drain_freed(self) -> None:
        """Release the storages freed since the last drain (lock held)."""
        while self._freed:
            self.live -= self._live.pop(self._freed.popleft(), 0)

    def output_bytes(self, out) -> int:
        """Bytes of the storages of ``out`` allocated under the mode."""
        keys = {_storage_key(t)[0] for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)}
        with self._lock:
            self._drain_freed()
            return sum(self._live.get(key, 0) for key in keys)


def _arg_storages(args, kwargs) -> Dict[Any, int]:
    keys: Dict[Any, int] = {}
    for t in tree_leaves((args, kwargs)):
        if isinstance(t, torch.Tensor):
            key, st = _storage_key(t)
            keys[key] = st.nbytes()
    return keys


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _analyses(counting: _CountingMode, tally: KernelTally, arg_bytes: int,
              out) -> Dict[str, Any]:
    if counting.failed:
        return {"analysis_failed": True}
    by_op = dict(counting.flops)
    info: Dict[str, Any] = {
        "flops": float(sum(by_op.values()) + tally.total("flops")),
        "bytes_accessed": float(counting.bytes + tally.total("bytes")),
        "flops_by_op": by_op}
    if tally.counts:
        info["kernels"] = {k: dict(c) for k, c in tally.counts.items()}
    output = counting.output_bytes(out)
    info["memory"] = {"argument": arg_bytes, "output": output,
                      "temp": max(0, counting.peak_live - output)}
    info["peak_bytes"] = arg_bytes + counting.peak_live
    return info


def _record_first_call(name: str, fp: tuple, fp_str: str,
                       info: Optional[Dict[str, Any]],
                       compile_s: float) -> None:
    """Record one first call: analysed (``info`` holds its analyses, and
    ``compile_s`` its synchronised wall time) or counted only (``info``
    None)."""
    analysed = info is not None
    info = info or {}
    with _LOCK:
        rec = _REGISTRY.get(name)
        if rec is None:
            rec = _REGISTRY[name] = ProgramRecord(name)
        is_recompile = bool(rec.variants) and fp not in rec.variants
        if is_recompile:
            churn_from, churn_to = _churn_pair(rec.last_fp, fp)
        rec.compiles += 1
        variant = {"avals": fp_str, "analysed": analysed}
        if analysed:
            rec.analysed += 1
            rec.compile_seconds += compile_s
            rec.last = info
            variant["compile_s"] = round(compile_s, 6)
            variant.update({k: info[k] for k in ("flops", "bytes_accessed",
                                                 "peak_bytes", "kernels")
                            if k in info})
        rec.variants[fp] = variant
        rec.last_avals = fp_str
        rec.last_fp = fp
        if is_recompile:
            rec.recompiles += 1
            if len(rec.churn) >= _MAX_CHURN_RECORDS:
                rec.churn.pop(0)
            rec.churn.append({"from": churn_from, "to": churn_to,
                              "compile_s": round(compile_s, 6)})
        n_variants = len(rec.variants)
        n_churn_tags = len({(c["from"], c["to"]) for c in rec.churn})
    tk = (("program", name),)
    _c_compiles.inc(tag_key=tk)
    if analysed:
        _c_compile_seconds.inc(compile_s, tag_key=tk)
    _g_variants.set(float(n_variants), tag_key=tk)
    if "flops" in info:
        _g_flops.set(info["flops"], tag_key=tk)
    if "bytes_accessed" in info:
        _g_bytes.set(info["bytes_accessed"], tag_key=tk)
    if "peak_bytes" in info:
        _g_peak_bytes.set(float(info["peak_bytes"]), tag_key=tk)
    if is_recompile:
        _c_recompiles.inc(tag_key=tk)
        if n_churn_tags <= _MAX_CHURN_TAGS:
            _g_churn.set(1.0, tags={"program": name,
                                    "from": churn_from, "to": churn_to})


# --------------------------------------------------------------------------- #
# The observation hook
# --------------------------------------------------------------------------- #


class ObservedProgram:
    """Observing wrapper around one callable: a drop-in replacement
    (other attributes are the wrapped function's).

    The first call under each new fingerprint runs inside the analysis,
    up to ``max_analysed`` of them (:data:`ANALYSED_FIRST_CALLS`; set it
    to None on a wrapper to analyse every one); a later new
    fingerprint is counted and its call runs as it is, as do calls under
    a seen fingerprint. A
    failure before a call starts (the fingerprint, entering the
    analysis) permanently falls back to the plain function: observation
    never changes what a step computes or whether it runs."""

    def __init__(self, fn: Callable, name: str):
        self._fn = fn
        self.program_name = name
        self.max_analysed: Optional[int] = ANALYSED_FIRST_CALLS
        self._analysed = 0
        self._seen: set = set()
        self._fallback = False

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __call__(self, *args, **kwargs):
        if self._fallback or not global_config().xla_observatory_enabled:
            return self._fn(*args, **kwargs)
        try:
            fp = _fingerprint(args, kwargs)
        except Exception:  # noqa: BLE001 — observation never breaks a call
            self._fallback = True
            return self._fn(*args, **kwargs)
        if fp in self._seen:
            return self._fn(*args, **kwargs)
        if self.max_analysed is not None \
                and self._analysed >= self.max_analysed:
            return self._counted_call(fp, args, kwargs)
        return self._first_call(fp, args, kwargs)

    def probe(self, *args, **kwargs) -> bool:
        """The steady-state observation of a call without the call: the
        knob, the fingerprint and the lookup. True when the fingerprint
        was seen (what timing the observation's cost measures)."""
        if self._fallback or not global_config().xla_observatory_enabled:
            return False
        return _fingerprint(args, kwargs) in self._seen

    def _counted_call(self, fp: tuple, args, kwargs):
        """A new fingerprint past the analysed ones: the call as it is,
        then the fingerprint counted."""
        out = self._fn(*args, **kwargs)
        self._seen.add(fp)
        try:
            _record_first_call(self.program_name, fp, _describe(fp), None,
                               0.0)
        except Exception:  # noqa: BLE001 — the call ran: keep its result
            pass
        return out

    def _first_call(self, fp: tuple, args, kwargs):
        stack = contextlib.ExitStack()
        try:
            arg_keys = _arg_storages(args, kwargs)
            counting = stack.enter_context(_CountingMode(arg_keys))
            tally = stack.enter_context(KernelTally())
            _synchronize()
        except Exception:  # noqa: BLE001 — nothing ran yet: fall back
            stack.close()
            self._fallback = True
            return self._fn(*args, **kwargs)
        t_span = _fr.now()
        t0 = time.perf_counter()
        try:
            out = self._fn(*args, **kwargs)
            _synchronize()
        except BaseException:
            stack.close()
            raise
        dt = time.perf_counter() - t0
        _sp_first_call.end(t_span, self.program_name)
        self._seen.add(fp)
        self._analysed += 1
        try:
            stack.close()
            info = _analyses(counting, tally, sum(arg_keys.values()), out)
            _record_first_call(self.program_name, fp, _describe(fp), info,
                               dt)
            device_telemetry.record_compile_event("program.first_call", dt)
        except Exception:  # noqa: BLE001 — the call ran: keep its result
            pass
        return out


def observe_program(fn: Callable, name: str):
    """Register ``fn`` with the observatory under ``name`` and return
    the observing wrapper (:class:`ObservedProgram`), a drop-in
    replacement; with the ``xla_observatory_enabled`` knob off, ``fn``
    itself."""
    if not global_config().xla_observatory_enabled:
        return fn
    return ObservedProgram(fn, name)


def snapshot() -> Dict[str, Dict[str, Any]]:
    """This process's program registry as plain dicts."""
    with _LOCK:
        return {name: rec.to_dict() for name, rec in _REGISTRY.items()}


def get_program(name: str) -> Optional[Dict[str, Any]]:
    with _LOCK:
        rec = _REGISTRY.get(name)
        return rec.to_dict() if rec is not None else None


def program_names() -> List[str]:
    with _LOCK:
        return sorted(_REGISTRY)


def reset_for_tests() -> None:
    """Forget every program record (the metrics plane is cumulative and
    keeps its counts)."""
    with _LOCK:
        _REGISTRY.clear()


# --------------------------------------------------------------------------- #
# Peaks (roofline ceilings)
# --------------------------------------------------------------------------- #

# published dense bf16 peak (FLOP/s) and memory rate (B/s) by card name,
# NVIDIA data sheets, first match wins; the rates assume the card's full
# power limit
PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100 NVL", 835e12, 3.9e12),
    ("H100", 989e12, 3.35e12),
    ("H200", 989e12, 4.8e12),
)
# nominal CPU ceilings: trend-only, never an enforced verdict
_CPU_NOMINAL_FLOPS = 1e12
_CPU_NOMINAL_HBM = 100e9


def peaks_for(name: str) -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, bytes/s) of the card named ``name``
    (``torch.cuda.get_device_name``), or None for a card not in
    :data:`PEAKS`."""
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    return None


def _device_info() -> Tuple[str, str]:
    """(platform, device kind): ``cuda`` and the current card's name
    once this process has initialised CUDA, else ``cpu``. Never
    initialises CUDA itself."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return "cuda", torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu", "cpu"


@functools.lru_cache(maxsize=1)
def _host_cards() -> Tuple[str, int]:
    """(name, count) of this host's cards by ``nvidia-smi``, read once a
    process: a dashboard polling ``/api/xla`` starts no process a
    request."""
    cards = device_telemetry.query_cards()
    return (cards[0]["name"], len(cards)) if cards else ("", 0)


def _fold_device_info() -> Tuple[str, str, int]:
    """(platform, device kind, cards) for the head-side fold: this
    process's card once it has initialised CUDA, else the cards of this
    host (a head process never opens a context, and its workers run on
    the host's cards), else the CPU."""
    platform, kind = _device_info()
    if platform == "cuda":
        return platform, kind, torch.cuda.device_count()
    name, count = _host_cards()
    if count:
        return "cuda", name, count
    return "cpu", "cpu", 1


def _peak(override: float, index: int, nominal: float,
          device: Optional[Tuple[str, str]] = None) -> Optional[float]:
    if override > 0:
        return float(override)
    platform, kind = device or _device_info()
    if platform == "cuda":
        peaks = peaks_for(kind)
        return peaks[index] if peaks else None
    return nominal


def peak_flops_per_chip(device: Optional[Tuple[str, str]] = None
                        ) -> Optional[float]:
    """bf16 peak FLOP/s of the card (``xla_peak_flops`` overrides); None
    for a CUDA card not in :data:`PEAKS`. ``device`` is a (platform,
    kind) pair; default: this process's."""
    return _peak(global_config().xla_peak_flops, 0, _CPU_NOMINAL_FLOPS,
                 device)


def peak_hbm_bytes_per_sec(device: Optional[Tuple[str, str]] = None
                           ) -> Optional[float]:
    """Memory rate of the card in bytes/s (``xla_peak_hbm_bytes``
    overrides); None for a CUDA card not in :data:`PEAKS`."""
    return _peak(global_config().xla_peak_hbm_bytes, 1, _CPU_NOMINAL_HBM,
                 device)


# --------------------------------------------------------------------------- #
# The report
# --------------------------------------------------------------------------- #

# program -> the measured flight-recorder span family its executions
# land in. Programs without an entry get analytic columns only.
_MEASURE_SPAN = {
    "spmd.train_step": "spmd.compute",
    "llama.gspmd_train_step": "spmd.compute",
    "llama.decode": "serve.decode_step",
    "llama.prefill": "serve.prefill",
}

_COLUMNS = ("compiles", "analysed", "recompiles", "compile_seconds", "flops",
            "bytes_accessed", "peak_bytes", "variants", "churn", "avals",
            "memory", "kernels", "flops_by_op")


def _span_stats(payloads: List[dict]) -> Dict[str, Dict[str, float]]:
    """span name -> {count, total_s} over span payloads."""
    stats: Dict[str, Dict[str, float]] = {}
    for ev in _fr.build_span_events(payloads):
        if ev.get("ph") != "X" or ev.get("cat") != "span":
            continue
        row = stats.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
        row["count"] += 1
        row["total_s"] += ev.get("dur", 0.0) / 1e6
    return stats


def _measured_span_stats(since: int, head=None
                         ) -> Dict[str, Dict[str, float]]:
    """span name -> {count, total_s}: cluster-wide when a head is given
    (every process's drained payloads), else this process's ring from
    seq ``since`` on."""
    if head is not None:
        return _span_stats(_fr.cluster_span_payloads(head))
    return _span_stats([_fr.snapshot_payload_since(since)])


def _merged_program_columns() -> Dict[str, Dict[str, Any]]:
    """Per-program numeric columns from the (head-side merged) metrics
    registry: counters sum across sources, gauges take the max."""
    flat = aggregate_series(registry())
    programs: Dict[str, Dict[str, Any]] = {}

    def fold(metric: str, field: str, how: str) -> None:
        for tags, value in flat.get(metric, ()):
            prog = dict(tags).get("program")
            if not prog:
                continue
            row = programs.setdefault(prog, {})
            if how == "sum":
                row[field] = row.get(field, 0.0) + value
            else:
                row[field] = max(row.get(field, 0.0), value)

    fold("port_program_compiles_total", "compiles", "sum")
    fold("port_program_recompiles_total", "recompiles", "sum")
    fold("port_program_compile_seconds_total", "compile_seconds", "sum")
    fold("port_program_flops", "flops", "max")
    fold("port_program_bytes_accessed", "bytes_accessed", "max")
    fold("port_program_peak_bytes", "peak_bytes", "max")
    fold("port_program_variants", "variants", "max")
    for tags, _value in flat.get("port_program_shape_churn", ()):
        d = dict(tags)
        prog = d.get("program")
        if not prog:
            continue
        programs.setdefault(prog, {}).setdefault("churn", []).append(
            {"from": d.get("from", ""), "to": d.get("to", "")})
    return programs


# per-process detail the head adds to the merged columns of the programs
# it ran itself (the counts stay cluster-wide)
_DETAIL = ("avals", "memory", "kernels", "flops_by_op", "churn")


def program_report(spans_since: int = 0, head=None) -> Dict[str, Any]:
    """The program report, rooflined against the card's peaks; the
    report dict keeps the JAX package's keys.

    Without ``head``: this process's programs joined with its measured
    spans (those from flight-recorder seq ``spans_since`` on). With
    ``head`` (the head-side fold, the counterpart of ``xla_report``):
    every process's ``port_program_*`` series merged through the head's
    registry (counters summed, gauges at their max), the detail of the
    programs the head ran itself, the spans of every process
    (``cluster_span_payloads``) and the recompile storms the head's
    health monitor holds active. The fold's peaks are those of the card
    this process uses, or, in a head that never opened one, of this
    host's cards (``nvidia-smi``)."""
    if head is None:
        platform, kind = _device_info()
        n_devices = torch.cuda.device_count() if platform == "cuda" else 1
    else:
        platform, kind, n_devices = _fold_device_info()
    peak_f = peak_flops_per_chip((platform, kind))
    peak_b = peak_hbm_bytes_per_sec((platform, kind))
    ridge = peak_f / peak_b if peak_f and peak_b else None
    enforced = platform == "cuda"

    if head is None:
        programs: Dict[str, Dict[str, Any]] = {}
        for name, rec in snapshot().items():
            programs[name] = {k: rec[k] for k in _COLUMNS
                              if rec.get(k) not in (None, "", [])}
    else:
        programs = _merged_program_columns()
        for name, rec in snapshot().items():
            row = programs.setdefault(name, {})
            row.update({k: rec[k] for k in _DETAIL
                        if rec.get(k) not in (None, "", [])})
    spans = _measured_span_stats(spans_since, head)
    recompiles_total = 0
    for name, row in programs.items():
        recompiles_total += row.get("recompiles", 0)
        flops = row.get("flops", 0.0)
        nbytes = row.get("bytes_accessed", 0.0)
        if flops and nbytes:
            row["arithmetic_intensity"] = round(flops / nbytes, 4)
        measure = _MEASURE_SPAN.get(name)
        st = spans.get(measure) if measure else None
        if st and st["count"] and st["total_s"] > 0:
            mean_s = st["total_s"] / st["count"]
            row["measured_span"] = measure
            row["measured_steps"] = int(st["count"])
            row["mean_step_s"] = round(mean_s, 6)
            if flops:
                # the counts are one process's, one card's share of the
                # work: roofline against one card's peak
                achieved = flops / mean_s
                row["achieved_flops_per_s"] = round(achieved, 2)
                if peak_f:
                    row["mfu"] = round(achieved / peak_f, 6)
        ai = row.get("arithmetic_intensity")
        if ai is not None and ridge is not None:
            row["verdict"] = ("compute-bound" if ai >= ridge
                              else "memory-bound")
            row["verdict_enforced"] = enforced
    report: Dict[str, Any] = {
        "platform": platform,
        "device_kind": kind,
        "devices": n_devices,
        "peak_flops_per_chip": peak_f,
        "peak_hbm_bytes_per_sec": peak_b,
        "ridge_intensity": round(ridge, 4) if ridge else None,
        "programs": {k: programs[k] for k in sorted(programs)},
        "recompiles_total": int(recompiles_total),
    }
    monitor = getattr(head, "health_monitor", None)
    if monitor is not None and hasattr(monitor, "recompile"):
        report["storms"] = sorted(monitor.recompile.active)
    publish_report(report)
    return report


def publish_report(report: Dict[str, Any]) -> None:
    """Mirror the report onto the registry so /api/metrics/history has
    the program plane as time series."""
    _g_report_programs.set(float(len(report.get("programs", {}))))
    _g_report_recompiles.set(float(report.get("recompiles_total", 0)))


_g_report_programs = Gauge(
    "port_programs",
    "Observed programs (from the program report: this process's, or "
    "cluster-wide from the head fold)")
_g_report_recompiles = Gauge(
    "port_program_recompiles",
    "Recompile total (from the program report: this process's, or "
    "cluster-wide from the head fold)")


def _fmt_num(v: float) -> str:
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def format_programs(report: Dict[str, Any]) -> str:
    """Human rendering of :func:`program_report`."""
    lines = ["program observatory", "-" * 19]
    lines.append(
        f"platform: {report['platform']} ({report['device_kind']}), "
        f"{report['devices']} device(s)")
    peak_f, peak_b = (report["peak_flops_per_chip"],
                      report["peak_hbm_bytes_per_sec"])
    ridge = report.get("ridge_intensity")
    if peak_f and peak_b:
        lines.append(f"peaks: {_fmt_num(peak_f)}FLOP/s, "
                     f"{_fmt_num(peak_b)}B/s"
                     + (f", ridge {ridge:.1f} FLOP/B" if ridge else ""))
    else:
        lines.append("peaks: unknown card (no MFU, no verdict)")
    if report["platform"] != "cuda":
        lines.append("(CPU peaks are nominal: verdicts are trend-only, "
                     "not enforced)")
    progs = report.get("programs", {})
    if not progs:
        lines.append("no observed programs")
        return "\n".join(lines)
    lines.append("")
    lines.append(f"{'program':<24}{'compiles':>9}{'recomp':>7}"
                 f"{'compile_s':>10}{'GFLOPs':>9}{'AI':>7}"
                 f"{'MFU':>7}  verdict")
    for name, row in progs.items():
        flops = row.get("flops", 0.0)
        ai = row.get("arithmetic_intensity")
        mfu = row.get("mfu")
        lines.append(
            f"{name:<24}{int(row.get('compiles', 0) or 0):>9}"
            f"{int(row.get('recompiles', 0) or 0):>7}"
            f"{row.get('compile_seconds', 0.0):>10.3f}"
            f"{flops / 1e9:>9.2f}"
            f"{(f'{ai:.1f}' if ai is not None else '-'):>7}"
            f"{(f'{mfu:.3f}' if mfu is not None else '-'):>7}"
            f"  {row.get('verdict', '-')}")
        for c in (row.get("churn") or [])[-3:]:
            lines.append(f"    churn: {c.get('from', '?')} -> "
                         f"{c.get('to', '?')}")
        if row.get("measured_span"):
            lines.append(
                f"    measured: {row['measured_steps']} x "
                f"{row['measured_span']} spans, mean "
                f"{row['mean_step_s'] * 1e3:.2f} ms"
                + (f", achieved "
                   f"{_fmt_num(row['achieved_flops_per_s'])}FLOP/s"
                   if row.get("achieved_flops_per_s") else ""))
    storms = report.get("storms")
    if storms:
        lines.append("")
        lines.append("ACTIVE RECOMPILE STORMS: " + ", ".join(storms))
    return "\n".join(lines)

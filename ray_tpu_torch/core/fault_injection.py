"""Deterministic fault injection: the chaos harness's failure points.

Reference: the testing hooks the reference scatters through its C++ core
(``RAY_testing_asio_delay_us``, ray_config_def.h:821, and the
``RAY_testing_rpc_failure`` op-failure injection) — config-gated points
in production code paths that tests flip on to kill processes, drop or
delay specific wire messages, and crash at named places, WITHOUT
test-only forks of the logic under test.

Spec grammar (``RAY_TPU_TEST_FAULT_SPEC`` / ``Config.test_fault_spec``)::

    spec   := rule (';' rule)*
    rule   := point '=' action ('@' hit)?
    hit    := N        fire on the N-th hit of the point only (1-based)
            | N+       fire on every hit from the N-th on
    action := crash        hard process death (os._exit) at the point
            | raise        raise FaultInjected (surfaces as a task error)
            | drop         caller discards the message/op
            | fail         caller reports the op as failed without doing it
            | delay:MS     sleep MS milliseconds inline, then continue

Points are dotted names.  A ``fire(point, detail)`` call matches a rule
whose point is either the bare ``point`` or ``point.detail`` — so
``worker.exec=crash@2`` kills whichever worker executes the 2nd task in
that process, while ``worker.exec.boom=crash@1`` targets the first
execution of a function named ``boom``.  Hit counters are per-process
and per-rule-key, which is what makes a spec deterministic: the same
spec against the same workload kills the same operation every run.

The spec rides the normal Config snapshot, so daemons and workers adopt
the head's spec at registration — a single env var arms the whole
cluster.  Tests running in one process use :func:`configure` /
:func:`reset` directly.

Instrumented points (each one ``fire()`` call in production code):

    worker.exec[.<fn>]      worker_runtime._execute, before user code
    dag.exec[.<fn>]         compiled-graph exec loops, before each round
                            invokes its method (``crash`` = the replica-
                            death drill for the compiled serve plane)
    wire.send[.<tag>]       protocol.Channel.send (control-plane msgs)
    node.dispatch_worker    Node.dispatch_to_worker (``fail`` bounces
                            the dispatch as a dead-worker report)
    daemon.sync             NodeSyncer loop (``drop`` loses a snapshot)
    head.daemon_req[.<op>]  Head._handle_daemon_req
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple


class FaultInjected(RuntimeError):
    """Raised at a fault point armed with the ``raise`` action."""

    def __init__(self, point: str):
        self.point = point
        super().__init__(f"fault injected at {point!r}")


class _Rule:
    __slots__ = ("point", "action", "arg", "start", "open_ended")

    def __init__(self, point: str, action: str, arg: float,
                 start: int, open_ended: bool):
        self.point = point
        self.action = action
        self.arg = arg
        self.start = start
        self.open_ended = open_ended

    def matches(self, hit: int) -> bool:
        return hit >= self.start if self.open_ended else hit == self.start


_ACTIONS = ("crash", "raise", "drop", "fail", "delay")

_lock = threading.Lock()
_spec_loaded: Optional[str] = None
_rules: Dict[str, List[_Rule]] = {}
_counts: Dict[str, int] = {}


def parse_spec(spec: str) -> Dict[str, List[_Rule]]:
    """Parse a fault spec; raises ValueError on malformed rules."""
    rules: Dict[str, List[_Rule]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"fault rule {part!r} missing '='")
        point, rhs = part.split("=", 1)
        point = point.strip()
        hit = "1+" if "@" not in rhs else rhs.split("@", 1)[1].strip()
        action = rhs.split("@", 1)[0].strip()
        arg = 0.0
        if action.startswith("delay:"):
            arg = float(action.split(":", 1)[1]) / 1000.0
            action = "delay"
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} in {part!r}")
        open_ended = hit.endswith("+")
        start = int(hit[:-1] if open_ended else hit)
        if start < 1:
            raise ValueError(f"fault hit index must be >= 1 in {part!r}")
        rules.setdefault(point, []).append(
            _Rule(point, action, arg, start, open_ended))
    return rules


def configure(spec: str) -> None:
    """Arm (or clear, with "") the process-local fault spec and reset
    hit counters. Tests use this directly; separate processes pick the
    spec up from Config (see :func:`_ensure_loaded`)."""
    global _spec_loaded, _rules
    with _lock:
        _rules = parse_spec(spec)
        _spec_loaded = spec
        _counts.clear()


def reset() -> None:
    configure("")


def hits(point: str) -> int:
    """Hit count for an armed point (test assertions)."""
    with _lock:
        return _counts.get(point, 0)


def _ensure_loaded() -> bool:
    """Sync the parsed rules with the current Config spec. Returns True
    when any rules are armed. The fast path (no spec anywhere) is one
    global read + string compare."""
    global _spec_loaded, _rules
    from .config import global_config

    spec = global_config().test_fault_spec
    if spec == _spec_loaded:
        return bool(_rules)
    with _lock:
        if spec != _spec_loaded:
            try:
                _rules = parse_spec(spec)
            except ValueError:
                _rules = {}
            _spec_loaded = spec
            _counts.clear()
    return bool(_rules)


def fire(point: str, detail: Optional[str] = None) -> Optional[str]:
    """Hit a fault point. Returns the matched action name for actions
    the CALLER must apply ("drop" / "fail"), applies inline actions
    (crash / raise / delay) directly, or returns None."""
    if not _ensure_loaded():
        return None
    keys: Tuple[str, ...] = (point,) if detail is None \
        else (point, f"{point}.{detail}")
    matched: Optional[_Rule] = None
    with _lock:
        for key in keys:
            rules = _rules.get(key)
            if not rules:
                continue
            n = _counts.get(key, 0) + 1
            _counts[key] = n
            for rule in rules:
                if rule.matches(n):
                    matched = rule
                    break
            if matched is not None:
                break
    if matched is None:
        return None
    if matched.action == "crash":
        # hard process death, as close to kill -9 as Python allows: no
        # atexit, no finally blocks, no flushes. The one exception is
        # the crash FLIGHT RECORDER: its whole job is a last-N-seconds
        # span dump at exactly this kind of death, written synchronously
        # here (bounded, best-effort) before the exit
        try:
            from ray_tpu_torch.util import flight_recorder

            flight_recorder.dump(f"chaos:{matched.point}")
        except Exception:
            pass
        os._exit(13)
    if matched.action == "raise":
        raise FaultInjected(matched.point)
    if matched.action == "delay":
        time.sleep(matched.arg)
        return None
    return matched.action  # "drop" | "fail": caller applies


def should_drop(point: str, detail: Optional[str] = None) -> bool:
    """True when the caller must silently discard the message/op."""
    return fire(point, detail) == "drop"

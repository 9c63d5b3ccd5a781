"""Iteration-level continuous batching for generative decode (the
Orca/vLLM scheduling model, arXiv:2309.06180).

The :class:`DecodeScheduler` owns a RUNNING batch of multi-step
sequences. One ``step()`` call = one scheduling iteration: admit
newly-arrived prefills (the compiled exec loop drains them from the ring
backlog BETWEEN decode steps — admission is per-iteration, not
per-batch), run one model step over every running sequence, emit token
chunks, retire finished sequences immediately. A short request admitted
while a long one is mid-decode therefore finishes first — batch
membership is fluid.

Port of ``ray_tpu/serve/decode.py``: the same reply frames, the same
admission, copy-on-write and retirement logic, and the same hooks: the
``serve.prefill`` and ``serve.decode_step`` flight-recorder spans, the
KV-occupancy gauges and the tokens-generated and inter-token-latency
metrics (under the port's ``port_`` names).

Engines implement a small duck-typed protocol over the paged KV cache
(:mod:`ray_tpu_torch.serve.kv_cache`):

- ``engine.pool`` / ``engine.prefix_cache`` — page accounting
- ``engine.page_size`` — positions per page
- ``engine.prefill(tokens, pages) -> logits`` — write KV for positions
  ``[0, len(tokens))`` into ``pages``, return last-position logits (the
  numpy array a prefix hit must reproduce byte-identically)
- ``engine.decode(pos, token, pages) -> logits`` — write KV for
  ``token`` at ``pos``, return next-position logits
- ``engine.copy_page(src, dst)`` — duplicate one physical page
  (copy-on-write of a shared prefix's partial tail page)

Sampling is greedy (argmax) — deterministic by construction, which is
what makes the prefix-reuse logits identity testable.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.serve.kv_cache import (
    PagePool,
    PrefixCache,
    SequenceKV,
    flush_kv_gauges,
    pages_for,
)
from ray_tpu_torch.serve import observability as _obs
from ray_tpu_torch.util import flight_recorder as _fr

# one registration site per span name
_sp_prefill = _fr.register_span("serve.prefill", tag_keys=("deployment",))
_sp_decode_step = _fr.register_span("serve.decode_step",
                                    tag_keys=("deployment",))

_GAUGE_INTERVAL_S = 0.25


class _Seq:
    __slots__ = ("corr", "prompt", "max_tokens", "eos", "kv", "pos",
                 "generated", "eager", "cached_prefix", "last_chunk_ts")

    def __init__(self, corr, prompt, max_tokens, eos, kv, pos, eager,
                 cached_prefix):
        self.corr = corr
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos = eos
        self.kv = kv                  # SequenceKV
        self.pos = pos                # next KV write position
        self.generated: List[int] = []
        self.eager = eager
        self.cached_prefix = cached_prefix
        self.last_chunk_ts: Optional[float] = None  # ITL anchor


def parse_decode_request(value) -> dict:
    """Normalize a decode request payload: a dict (handle path) or raw
    JSON bytes (the TAG_BYTES proxy fast lane feeds the body through
    un-pickled)."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        value = json.loads(bytes(value).decode("utf-8"))
    if not isinstance(value, dict):
        raise TypeError(
            f"decode request must be a dict or JSON bytes, got "
            f"{type(value).__name__}")
    prompt = value.get("prompt")
    if not isinstance(prompt, (list, tuple)) or not prompt:
        raise ValueError("decode request needs a non-empty 'prompt' "
                         "token list")
    return {
        "prompt": [int(t) for t in prompt],
        "max_tokens": int(value.get("max_tokens", 16)),
        "eos": value.get("eos"),
    }


class DecodeScheduler:
    """Continuous-batching scheduler over one engine. Thread-safe: the
    compiled exec loop and the eager streaming plane both drive it (the
    lock covers one whole iteration, so model steps never interleave).

    Reply routing: compiled requests' frames are returned from
    :meth:`step` as ``(corr, kind, payload)`` for the exec loop to ship
    as TAG_STREAM slots; eager requests' frames land in a per-corr queue
    drained by the eager generator. An iteration stepped by an eager
    generator (``step(eager=True)``) also decodes the compiled
    requests' next tokens: their frames wait in the scheduler until the
    exec loop's next :meth:`step` takes them, so no frame is lost to the
    plane that did not ask for it."""

    def __init__(self, engine, deployment: str = "", max_batch: int = 8,
                 max_tokens_cap: int = 512):
        self.engine = engine
        self.pool: PagePool = engine.pool
        self.prefix_cache: PrefixCache = engine.prefix_cache
        self.page_size: int = engine.page_size
        self.deployment = deployment
        self.max_batch = max(1, int(max_batch))
        self.max_tokens_cap = max_tokens_cap
        self._lock = threading.Lock()
        self.waiting: deque = deque()           # (corr, req, eager)
        self.running: "OrderedDict[object, _Seq]" = OrderedDict()
        self._eager_out: Dict[object, deque] = {}
        # compiled requests' frames from iterations an eager generator
        # stepped, in order, until the exec loop's next step
        self._compiled_out: List[tuple] = []
        self._next_gauge = 0.0
        # observable scheduling history: (corr, n_generated) in retire
        # order — what the iteration-level admission test asserts on
        self.retired: List[Tuple[object, int]] = []
        self.steps = 0
        self.admitted = 0

    # ------------------------------------------------------------ intake

    def submit(self, corr, value, eager: bool = False) -> Optional[tuple]:
        """Queue one request. Returns an error reply frame immediately
        when the payload is malformed (never admits a poison request)."""
        try:
            req = parse_decode_request(value)
        except Exception as e:  # noqa: BLE001 — ship to this consumer
            return (corr, "error", e)
        with self._lock:
            if eager:
                self._eager_out.setdefault(corr, deque())
            self.waiting.append((corr, req, eager))
        return None

    def drain_eager(self, corr) -> List[tuple]:
        """Frames emitted for an eager request since the last drain."""
        with self._lock:
            q = self._eager_out.get(corr)
            if not q:
                return []
            out = list(q)
            q.clear()
            return out

    def forget_eager(self, corr) -> None:
        with self._lock:
            self._eager_out.pop(corr, None)

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        return {
            "kv_occupancy": self.pool.occupancy(),
            "kv_hit_rate": self.prefix_cache.hit_rate,
            "kv_pages_used": self.pool.used,
            "kv_pages_capacity": self.pool.n_pages,
            "prefix_entries": len(self.prefix_cache),
            "running": len(self.running),
            "waiting": len(self.waiting),
            "steps": self.steps,
            "admitted": self.admitted,
        }

    # ----------------------------------------------------------- the loop

    def step(self, eager: bool = False) -> Tuple[List[tuple], bool]:
        """One scheduling iteration. Returns ``(replies, active)`` in the
        stream exec-loop contract: replies for compiled corrs, active
        while any sequence is running or waiting. ``eager=True`` (an
        eager generator's step) returns no replies: the compiled corrs'
        frames are kept for the exec loop's next step."""
        with self._lock:
            replies: List[tuple] = []
            self._admit_locked(replies)
            self._decode_iteration_locked(replies)
            self.steps += 1
            self._flush_gauges_locked()
            out = [r for r in replies if not self._route_eager(r)]
            if eager:
                self._compiled_out.extend(out)
                out = []
            elif self._compiled_out:
                out = self._compiled_out + out
                self._compiled_out = []
            active = bool(self.running) or bool(self.waiting)
            return out, active

    def _route_eager(self, reply: tuple) -> bool:
        corr = reply[0]
        q = self._eager_out.get(corr)
        if q is None:
            return False
        q.append(reply)
        return True

    def _flush_gauges_locked(self) -> None:
        import time

        now = time.monotonic()
        if now < self._next_gauge:
            return
        self._next_gauge = now + _GAUGE_INTERVAL_S
        try:
            flush_kv_gauges(self.deployment, self.pool, self.prefix_cache)
        except Exception:
            pass

    # -------------------------------------------------------- admission

    def _admit_locked(self, replies: List[tuple]) -> None:
        """Admit waiting prefills into the RUNNING batch, prefix-cache
        first. A prefill that cannot get pages (even after evicting idle
        prefixes) stays queued — admission stops for this iteration so
        arrival order is preserved under memory pressure."""
        while self.waiting and len(self.running) < self.max_batch:
            corr, req, eager = self.waiting[0]
            prompt = req["prompt"]
            key = tuple(prompt)
            n_prompt = len(prompt)
            _t0 = _fr.now()
            entry = self.prefix_cache.lookup(key)
            was_hit = entry is not None
            if entry is not None:
                logits = entry.blob
            else:
                n_pages = pages_for(n_prompt, self.page_size)
                # +1: a non-aligned prompt also needs the COW tail page
                if n_pages + (1 if n_prompt % self.page_size else 0) \
                        > self.pool.n_pages:
                    self.waiting.popleft()
                    replies.append((corr, "error", ValueError(
                        f"prompt of {n_prompt} tokens can never fit: "
                        f"needs {n_pages} pages, pool holds "
                        f"{self.pool.n_pages}")))
                    continue
                pages = self.prefix_cache.alloc_with_evict(n_pages)
                if pages is None:
                    break  # pool pressure: retry next iteration
                try:
                    logits = self.engine.prefill(prompt, pages)
                except Exception as e:  # noqa: BLE001 — fail one request
                    self.pool.release(pages)
                    self.waiting.popleft()
                    replies.append((corr, "error", e))
                    continue
                entry = self.prefix_cache.insert(key, n_prompt, pages,
                                                 blob=logits)
            kv = self._sequence_kv(entry, n_prompt)
            if kv is None:  # tail-page copy could not get a page
                self.prefix_cache.release(entry)
                break
            self.waiting.popleft()
            first = int(np.argmax(logits))
            seq = _Seq(corr, prompt,
                       min(req["max_tokens"], self.max_tokens_cap),
                       req["eos"], kv, n_prompt, eager,
                       cached_prefix=was_hit)
            seq.generated.append(first)
            self.running[corr] = seq
            self.admitted += 1
            _sp_prefill.end(_t0, self.deployment)
            seq.last_chunk_ts = _fr.now()
            if _obs.enabled():
                _obs.TOKENS_GENERATED.inc(
                    tag_key=_obs.dep_key(self.deployment))
            replies.append((corr, "chunk", _chunk_payload(seq, first, 0)))
            if self._finished(seq, first):
                self._retire_locked(seq, replies)

    def _sequence_kv(self, entry, n_prompt: int) -> Optional[SequenceKV]:
        """Build the sequence's page table over a prefix entry: full
        prefix pages are shared read-only; a partial tail page is
        copy-on-write duplicated so concurrent sequences never write the
        same physical slot."""
        n_full, rem = divmod(n_prompt, self.page_size)
        kv = SequenceKV(page_size=self.page_size,
                        shared=list(entry.pages[:n_full]),
                        prefix=entry)
        if rem:
            tail = self.prefix_cache.alloc_with_evict(1)
            if tail is None:
                return None
            self.engine.copy_page(entry.pages[n_full], tail[0])
            kv.owned.append(tail[0])
        return kv

    # ----------------------------------------------------------- decode

    def _decode_iteration_locked(self, replies: List[tuple]) -> None:
        """One model step over every RUNNING sequence."""
        if not self.running:
            return
        _t0 = _fr.now()
        itl_samples: List[float] = []
        n_tokens = 0
        for corr in list(self.running):
            seq = self.running[corr]
            if seq.pos >= seq.kv.capacity():
                page = self.prefix_cache.alloc_with_evict(1)
                if page is None:
                    self._retire_locked(
                        seq, replies,
                        error=RuntimeError(
                            "kv-cache page pool exhausted mid-decode "
                            f"(capacity {self.pool.n_pages} pages)"))
                    continue
                seq.kv.owned.extend(page)
            token = seq.generated[-1]
            try:
                logits = self.engine.decode(seq.pos, token, seq.kv.pages)
            except Exception as e:  # noqa: BLE001 — fail one sequence
                self._retire_locked(seq, replies, error=e)
                continue
            seq.pos += 1
            nxt = int(np.argmax(logits))
            seq.generated.append(nxt)
            _now = _fr.now()
            if seq.last_chunk_ts is not None:
                itl_samples.append(_now - seq.last_chunk_ts)
            seq.last_chunk_ts = _now
            n_tokens += 1
            replies.append((corr, "chunk",
                            _chunk_payload(seq, nxt,
                                           len(seq.generated) - 1)))
            if self._finished(seq, nxt):
                self._retire_locked(seq, replies)
        _sp_decode_step.end(_t0, self.deployment)
        if n_tokens and _obs.enabled():
            key = _obs.dep_key(self.deployment)
            _obs.TOKENS_GENERATED.inc(float(n_tokens), tag_key=key)
            for s in itl_samples:
                _obs.ITL.observe(s, tag_key=key)

    def _finished(self, seq: _Seq, token: int) -> bool:
        if seq.eos is not None and token == seq.eos:
            return True
        return len(seq.generated) >= seq.max_tokens

    def _retire_locked(self, seq: _Seq, replies: List[tuple],
                       error=None) -> None:
        self.running.pop(seq.corr, None)
        if seq.kv.owned:
            self.pool.release(seq.kv.owned)
            seq.kv.owned = []
        if seq.kv.prefix is not None:
            self.prefix_cache.release(seq.kv.prefix)
            seq.kv.prefix = None
        self.retired.append((seq.corr, len(seq.generated)))
        if error is not None:
            replies.append((seq.corr, "error", error))
        else:
            replies.append((seq.corr, "final", json.dumps({
                "done": True,
                "tokens": seq.generated,
                "n_generated": len(seq.generated),
                "cached_prefix": seq.cached_prefix,
            }).encode("utf-8")))


def _chunk_payload(seq: _Seq, token: int, index: int) -> bytes:
    return json.dumps({"token": token, "i": index}).encode("utf-8")


# --------------------------------------------------------------------- #
# Toy engine (tests + decode bench)
# --------------------------------------------------------------------- #


class ToyEngine:
    """Deterministic engine whose 'KV cache' is the token ids themselves:
    ``decode`` recomputes its next token from the PAGED history, so a
    paging bug (wrong page table, freed page, cross-sequence write)
    changes the output — the cheap way to prove the page plumbing end to
    end without a model. ``vocab`` logits are one-hot on the chosen
    token."""

    def __init__(self, n_pages: int = 64, page_size: int = 8,
                 vocab: int = 256, step_delay_s: float = 0.0):
        self.pool = PagePool(n_pages, page_size)
        self.prefix_cache = PrefixCache(self.pool)
        self.page_size = page_size
        self.vocab = vocab
        self.step_delay_s = step_delay_s
        self.store = np.full((n_pages, page_size), -1, dtype=np.int64)
        self.prefill_calls = 0
        self.decode_calls = 0

    def _write(self, pos: int, token: int, pages: List[int]) -> None:
        pg, off = divmod(pos, self.page_size)
        self.store[pages[pg], off] = token

    def _history_sum(self, length: int, pages: List[int]) -> int:
        total = 0
        for pos in range(length):
            pg, off = divmod(pos, self.page_size)
            v = self.store[pages[pg], off]
            if v < 0:
                raise RuntimeError(
                    f"unwritten KV slot at position {pos} "
                    f"(page {pages[pg]})")
            total += int(v)
        return total

    def _logits(self, token: int) -> np.ndarray:
        out = np.zeros(self.vocab, dtype=np.float32)
        out[token % self.vocab] = 1.0
        return out

    def prefill(self, tokens: List[int], pages: List[int]) -> np.ndarray:
        self.prefill_calls += 1
        if self.step_delay_s:
            import time

            time.sleep(self.step_delay_s)
        for pos, t in enumerate(tokens):
            self._write(pos, int(t), pages)
        nxt = (self._history_sum(len(tokens), pages) * 31 + len(tokens)) \
            % self.vocab
        return self._logits(nxt)

    def decode(self, pos: int, token: int, pages: List[int]) -> np.ndarray:
        self.decode_calls += 1
        if self.step_delay_s:
            import time

            time.sleep(self.step_delay_s)
        self._write(pos, int(token), pages)
        nxt = (self._history_sum(pos + 1, pages) * 31 + pos + 1) \
            % self.vocab
        return self._logits(nxt)

    def copy_page(self, src: int, dst: int) -> None:
        self.store[dst] = self.store[src]

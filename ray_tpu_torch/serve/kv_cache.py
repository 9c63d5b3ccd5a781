"""Paged KV-cache management for generative decode (vLLM PagedAttention
model, arXiv:2309.06180 — fixed-size pages from a preallocated pool,
per-sequence page tables, prefix-hash reuse). Port of
``ray_tpu/serve/kv_cache.py``, with its occupancy gauges under the
port's ``port_`` prefix.

The pool is storage-agnostic: it hands out integer page ids and keeps the
alloc/free ledger; engines own the actual KV arrays indexed by page id
(``models/llama.py`` keeps device tensors, the toy engine an int
matrix). That split is what the invariant tests pin down: page accounting
must balance under churn regardless of what the pages hold.

Ownership rules (the eviction-safety contract):

- A prefix-cache entry OWNS the pages holding its prompt's KV. Running
  sequences that reuse the prefix hold a refcount on the entry and read
  those pages; eviction only ever frees entries with refcount 0, so a
  RUNNING sequence's prefix pages can never be freed under it.
- A sequence OWNS the pages it appends during decode (plus a
  copy-on-write duplicate of the prefix's partial tail page — two
  sequences must never write the same physical slot). Owned pages are
  freed exactly once, at retirement.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.util.metrics import Gauge as _Gauge

_g_kv_pages = _Gauge(
    "port_serve_kv_pages_used",
    "KV-cache pages currently allocated out of a replica's page pool",
    tag_keys=("deployment",))
_g_kv_capacity = _Gauge(
    "port_serve_kv_pages_capacity",
    "Total KV-cache pages in a replica's page pool",
    tag_keys=("deployment",))
_g_kv_hit_rate = _Gauge(
    "port_serve_kv_prefix_hit_rate",
    "Fraction of prefill admissions served from the prefix cache",
    tag_keys=("deployment",))


class CacheOOM(Exception):
    """The page pool cannot satisfy an allocation even after evicting
    every refcount-0 prefix entry."""


class PagePool:
    """Fixed-size page-id allocator. Thread-safe (the replica's compiled
    exec loop and the eager plane both allocate)."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(
                f"need n_pages >= 1 and page_size >= 1, got "
                f"{n_pages}/{page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._lock = threading.Lock()
        self.alloc_total = 0
        self.free_total = 0

    @property
    def used(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        return self.used / self.n_pages

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages; None (nothing taken) when the pool has
        fewer free — allocation is all-or-nothing so a half-admitted
        prefill never strands pages."""
        with self._lock:
            if n > len(self._free):
                return None
            pages = [self._free.pop() for _ in range(n)]
            self.alloc_total += n
            return pages

    def release(self, pages: List[int]) -> None:
        with self._lock:
            for p in pages:
                if not 0 <= p < self.n_pages:
                    raise ValueError(f"page id {p} out of range")
                if p in self._free:
                    raise ValueError(f"double free of page {p}")
                self._free.append(p)
            self.free_total += len(pages)


def pages_for(length: int, page_size: int) -> int:
    """Pages needed to hold ``length`` token positions."""
    return max(0, (length + page_size - 1) // page_size)


@dataclass
class PrefixEntry:
    """One cached prompt prefix: the pages holding its KV (owned by the
    cache), the prompt length, and an engine-opaque blob (the llama
    engine stores the cold prefill's last-position logits so a hit
    reproduces them byte-identically without recompute)."""

    key: Tuple[int, ...]
    length: int
    pages: List[int]
    blob: object = None
    refs: int = 0
    stamp: int = 0


class PrefixCache:
    """Prefix-hash reuse with LRU eviction of unreferenced entries.

    Keys are full prompt token tuples: a hit skips the entire prefill
    (shared prompts are the workload this serves — system prompts,
    few-shot preambles). Entries pin their pages in the pool until
    evicted; eviction is driven by allocation pressure via
    :meth:`alloc_with_evict`."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: Dict[Tuple[int, ...], PrefixEntry] = {}
        self._lock = threading.Lock()
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.evictions = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: Tuple[int, ...]) -> Optional[PrefixEntry]:
        """Hit: refcount taken for the caller (pair with release())."""
        with self._lock:
            self.lookups += 1
            e = self._entries.get(key)
            if e is None:
                return None
            self.hits += 1
            e.refs += 1
            self._clock += 1
            e.stamp = self._clock
            return e

    def insert(self, key: Tuple[int, ...], length: int, pages: List[int],
               blob=None) -> PrefixEntry:
        """Register a cold prefill's pages as a reusable prefix. The
        cache takes ownership of ``pages``; the caller's refcount is
        taken (pair with release())."""
        with self._lock:
            e = PrefixEntry(key=key, length=length, pages=list(pages),
                            blob=blob, refs=1)
            self._clock += 1
            e.stamp = self._clock
            old = self._entries.get(key)
            self._entries[key] = e
            if old is not None and old.refs == 0:
                # replaced an idle duplicate (two cold prefills raced on
                # the eager + compiled planes): drop its pages now
                self.pool.release(old.pages)
                self.evictions += 1
            return e

    def release(self, entry: PrefixEntry) -> None:
        with self._lock:
            entry.refs = max(0, entry.refs - 1)

    def evict_lru(self, need_pages: int) -> int:
        """Free refcount-0 entries, LRU first, until ``need_pages`` pool
        pages are free (or no evictable entry remains). NEVER touches a
        referenced entry — that is the running-sequence safety rule.
        Returns the number of entries evicted."""
        evicted = 0
        with self._lock:
            idle = sorted((e for e in self._entries.values() if e.refs == 0),
                          key=lambda e: e.stamp)
            for e in idle:
                if self.pool.free_count >= need_pages:
                    break
                del self._entries[e.key]
                self.pool.release(e.pages)
                evicted += 1
            self.evictions += evicted
        return evicted

    def alloc_with_evict(self, n: int) -> Optional[List[int]]:
        """Pool alloc that evicts idle prefixes under pressure; None when
        even a fully-evicted pool cannot serve ``n`` pages right now."""
        pages = self.pool.alloc(n)
        if pages is not None:
            return pages
        self.evict_lru(n)
        return self.pool.alloc(n)


@dataclass
class SequenceKV:
    """Per-sequence page table: ``shared`` prefix pages (read-only,
    owned by a PrefixEntry the sequence holds a ref on) followed by
    ``owned`` pages the sequence appends into. ``page_for(pos)`` is the
    logical->physical map; ``writable_for(pos)`` additionally enforces
    that writes never land in a shared page."""

    page_size: int
    shared: List[int] = field(default_factory=list)
    owned: List[int] = field(default_factory=list)
    prefix: Optional[PrefixEntry] = None

    @property
    def pages(self) -> List[int]:
        return self.shared + self.owned

    def capacity(self) -> int:
        return (len(self.shared) + len(self.owned)) * self.page_size

    def page_for(self, pos: int) -> Tuple[int, int]:
        table = self.pages
        idx, off = divmod(pos, self.page_size)
        if idx >= len(table):
            raise IndexError(
                f"position {pos} beyond page table "
                f"({len(table)} pages x {self.page_size})")
        return table[idx], off

    def writable_for(self, pos: int) -> Tuple[int, int]:
        idx, off = divmod(pos, self.page_size)
        if idx < len(self.shared):
            raise ValueError(
                f"write at position {pos} would land in shared prefix "
                f"page {idx} (copy-on-write the tail page instead)")
        return self.page_for(pos)


def flush_kv_gauges(deployment: str, pool: PagePool,
                    cache: PrefixCache) -> None:
    """Push pool/prefix ground truth into the registry gauges (the
    occupancy-gauge-equals-ground-truth invariant is tested against
    these exact sets)."""
    tags = {"deployment": deployment}
    _g_kv_pages.set(float(pool.used), tags=tags)
    _g_kv_capacity.set(float(pool.n_pages), tags=tags)
    _g_kv_hit_rate.set(cache.hit_rate, tags=tags)

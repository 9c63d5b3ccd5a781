"""@serve.batch — dynamic request batching inside a replica.

Reference: python/ray/serve/batching.py. Calls to the decorated async
method are queued; a background task flushes a batch when max_batch_size is
reached or batch_wait_timeout_s elapses, calls the underlying function once
with the list of inputs, and distributes results.
"""

from __future__ import annotations

import asyncio
import functools
import time
from typing import Any, Callable, List, Optional


def _record_batch_metrics(dep: str, waits, size: int,
                          max_size: int) -> None:
    """Deferred batch-stage records (observability drain thread)."""
    from ray_tpu_torch.serve import observability as obs

    key = obs.dep_key(dep)
    for wait in waits:
        obs.BATCH_WAIT.observe(wait, tag_key=key)
    obs.BATCH_SIZE.set(size, tag_key=key)
    obs.BATCH_UTILIZATION.set(size / max(1, max_size), tag_key=key)


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = timeout_s
        self._queue: Optional[asyncio.Queue] = None
        self._task = None

    def _ensure(self):
        if self._queue is None:
            self._queue = asyncio.Queue()
            self._task = asyncio.get_running_loop().create_task(
                self._loop())

    def _record_batch(self, batch) -> None:
        """Batch-assembly observability. Only the per-request context
        stamping runs inline (it must land BEFORE each future resolves,
        so the replica's access-log line carries the batch wait); the
        histogram/gauge records defer to the drain thread like every
        other stage — they'd otherwise tax the event loop between
        assembly and the user's batch fn."""
        from ray_tpu_torch.serve import observability as obs

        if not obs.enabled():
            return
        now = time.monotonic()
        dep = next((rc.meta.get("deployment", "")
                    for _a, _f, _t, rc in batch if rc is not None), "")
        waits = []
        for _arg, _fut, enq_ts, rc in batch:
            wait = max(0.0, now - enq_ts)
            waits.append(wait)
            if rc is not None:
                rc.timings["batch_wait_s"] = \
                    rc.timings.get("batch_wait_s", 0.0) + wait
        obs.defer(_record_batch_metrics, dep, waits, len(batch),
                  self._max)

    async def _loop(self):
        while True:
            first = await self._queue.get()
            batch = [first]
            deadline = asyncio.get_event_loop().time() + self._timeout
            while len(batch) < self._max:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    break
                try:
                    item = await asyncio.wait_for(self._queue.get(),
                                                  timeout=remaining)
                    batch.append(item)
                except asyncio.TimeoutError:
                    break
            try:
                self._record_batch(batch)
            except Exception:
                pass  # observability must never fail the batch
            args = [item[0] for item in batch]
            futures = [item[1] for item in batch]
            try:
                results = self._fn(args)
                if asyncio.iscoroutine(results):
                    results = await results
                if len(results) != len(batch):
                    raise ValueError(
                        f"batched fn returned {len(results)} results for "
                        f"{len(batch)} inputs")
                for fut, res in zip(futures, results):
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:  # noqa: BLE001
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)

    async def submit(self, arg) -> Any:
        self._ensure()
        from ray_tpu_torch.serve import observability as obs

        rc = obs.current_request() if obs.enabled() else None
        fut = asyncio.get_event_loop().create_future()
        await self._queue.put((arg, fut, time.monotonic(), rc))
        return await fut


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator for async single-item methods; the wrapped fn receives a
    list of items and must return a list of results."""

    def deco(fn):
        queues = {}

        @functools.wraps(fn)
        async def wrapper(*args):
            # methods: args = (self, item); functions: (item,)
            if len(args) == 2:
                owner, item = args
                key = id(owner)
                target = functools.partial(fn, owner)
            else:
                (item,) = args
                key = 0
                target = fn
            # one queue per (owner, event loop): an asyncio.Queue and
            # its flush task belong to ONE loop — sharing a queue across
            # loops parks a waiter that never wakes
            key = (key, id(asyncio.get_running_loop()))
            q = queues.get(key)
            if q is None:
                q = queues[key] = _BatchQueue(target, max_batch_size,
                                              batch_wait_timeout_s)
            return await q.submit(item)

        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco

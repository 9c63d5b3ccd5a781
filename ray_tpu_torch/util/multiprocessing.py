"""multiprocessing.Pool clone over actors.

Analog of the reference's ray.util.multiprocessing.Pool
(python/ray/util/multiprocessing/pool.py): the stdlib Pool API (map /
imap / imap_unordered / apply / apply_async / starmap) running each chunk
on a pool of actor processes, so existing multiprocessing code scales to
the cluster unchanged.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch

from .actor_pool import ActorPool


@ray_tpu_torch.remote
class _PoolWorker:
    def run_chunk(self, fn, chunk, star: bool):
        if star:
            return [fn(*args) for args in chunk]
        return [fn(x) for x in chunk]

    def run_one(self, fn, args, kwargs):
        return fn(*args, **kwargs)


class AsyncResult:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout: Optional[float] = None):
        return ray_tpu_torch.get(self._ref, timeout=timeout)

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait([self._ref], num_returns=1, timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait([self._ref], num_returns=1, timeout=0)
        return bool(ready)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")  # stdlib contract
        try:
            self.get(timeout=0)
            return True
        except Exception:  # noqa: BLE001
            return False


class Pool:
    def __init__(self, processes: Optional[int] = None, *,
                 actor_options: Optional[dict] = None):
        if processes is None:
            try:
                processes = max(1, int(
                    ray_tpu_torch.available_resources().get("CPU", os.cpu_count())))
            except Exception:  # noqa: BLE001
                processes = os.cpu_count() or 1
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 1)
        self._workers = [_PoolWorker.options(**opts).remote()
                         for _ in range(processes)]
        self._processes = processes
        self._closed = False
        self._rr = itertools.count()
        self._outstanding: List[Any] = []
        # single result-handler thread for callback dispatch (stdlib Pool
        # shape): apply_async with a callback enqueues here instead of
        # spawning a thread per call — joblib submits one per batch
        self._cb_pending: dict = {}  # ref -> (callback, error_callback)
        self._cb_lock = threading.Lock()
        self._cb_thread = None

    # ---- helpers ----

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        for i in range(0, len(items), chunksize):
            yield items[i:i + chunksize]

    def _map_refs(self, fn, iterable, chunksize, star):
        refs = []
        for worker, chunk in zip(itertools.cycle(self._workers),
                                 self._chunks(iterable, chunksize)):
            refs.append(worker.run_chunk.remote(fn, chunk, star))
        self._outstanding.extend(refs)
        return refs

    # ---- stdlib Pool API ----

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        out: List[Any] = []
        for chunk in ray_tpu_torch.get(refs):
            out.extend(chunk)
        return out

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        refs = self._map_refs(fn, iterable, chunksize, star=True)
        out: List[Any] = []
        for chunk in ray_tpu_torch.get(refs):
            out.extend(chunk)
        return out

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for ref in ready:
                yield from ray_tpu_torch.get(ref)

    def apply(self, fn: Callable, args: tuple = (), kwargs: dict = None):
        return self.apply_async(fn, args, kwargs).get()

    def _ensure_cb_thread(self) -> None:
        with self._cb_lock:
            if self._cb_thread is not None:
                return
            self._cb_thread = True  # claim before the thread object exists

        def handler():
            # run until closed AND drained: close() must not drop pending
            # callbacks (stdlib contract — submitted tasks' callbacks fire)
            while True:
                with self._cb_lock:
                    refs = list(self._cb_pending.keys())
                if not refs:
                    if self._closed:
                        return
                    time.sleep(0.01)
                    continue
                ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0.5)
                for ref in ready:
                    with self._cb_lock:
                        cbs = self._cb_pending.pop(ref, None)
                    if cbs is None:
                        continue
                    callback, error_callback = cbs
                    try:
                        value = ray_tpu_torch.get(ref)
                    except Exception as e:  # noqa: BLE001
                        if error_callback is not None:
                            error_callback(e)
                        continue
                    if callback is not None:
                        callback(value)

        self._cb_thread = threading.Thread(
            target=handler, daemon=True, name="pool-result-handler")
        self._cb_thread.start()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwargs: dict = None, callback: Callable = None,
                    error_callback: Callable = None) -> AsyncResult:
        if self._closed:
            raise ValueError("Pool not running")  # stdlib contract
        worker = self._workers[next(self._rr) % self._processes]
        ref = worker.run_one.remote(fn, args, kwargs or {})
        self._outstanding.append(ref)
        res = AsyncResult(ref)
        if callback is not None or error_callback is not None:
            self._ensure_cb_thread()
            with self._cb_lock:
                self._cb_pending[ref] = (callback, error_callback)
        return res

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still open")
        # stdlib contract: join() is the completion barrier for all
        # submitted work — including callback dispatch
        if self._outstanding:
            ray_tpu_torch.wait(self._outstanding,
                         num_returns=len(self._outstanding))
            self._outstanding.clear()
        t = self._cb_thread
        if isinstance(t, threading.Thread):
            t.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False

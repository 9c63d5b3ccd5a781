"""Model multiplexing: many models behind one deployment's replicas.

Reference: ``@serve.multiplexed`` + ``serve.get_multiplexed_model_id()``
(python/ray/serve/api.py multiplexed; _private/multiplex.py
_ModelMultiplexWrapper) — each replica LRU-caches up to N loaded models;
requests carry a model id (``handle.options(multiplexed_model_id=...)``)
and the router sticks a model id to the replica that already holds it, so
one deployment serves a fleet of fine-tunes without one-replica-per-model
(the TPU case: many LoRA adapters over one base).
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
from collections import OrderedDict
from typing import Any, Callable, Optional

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the request being handled."""
    return _model_id_ctx.get()


def _set_request_model_id(model_id: str):
    return _model_id_ctx.set(model_id or "")


class _LRUModelCache:
    def __init__(self, loader: Callable, max_models: int, owner):
        self._loader = loader
        self._max = max_models
        self._owner = owner
        self._cache: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = asyncio.Lock()

    async def get(self, model_id: str):
        async with self._lock:
            if model_id in self._cache:
                self._cache.move_to_end(model_id)
                return self._cache[model_id]
        # load outside the lock-held fast path (loads can be slow)
        if inspect.iscoroutinefunction(self._loader):
            model = await self._loader(self._owner, model_id)
        else:
            model = await asyncio.get_event_loop().run_in_executor(
                None, lambda: self._loader(self._owner, model_id))
        async with self._lock:
            self._cache[model_id] = model
            self._cache.move_to_end(model_id)
            while len(self._cache) > self._max:
                old_id, old = self._cache.popitem(last=False)
                evict = getattr(old, "__del__", None)
                del old  # release; models with __del__ free device memory
        return model

    def model_ids(self):
        return list(self._cache.keys())


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for a replica's model-loader method.

    Usage::

        class Multi:
            @serve.multiplexed(max_num_models_per_replica=4)
            async def get_model(self, model_id: str):
                return load_adapter(model_id)

            async def __call__(self, req):
                model = await self.get_model(
                    serve.get_multiplexed_model_id())
                return model(req)
    """

    def wrap(loader: Callable):
        attr = f"__serve_multiplex_{loader.__name__}"

        @functools.wraps(loader)
        async def method(self, model_id: Optional[str] = None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no model id: pass one explicitly or set "
                    "handle.options(multiplexed_model_id=...) on the call")
            cache = getattr(self, attr, None)
            if cache is None:
                cache = _LRUModelCache(loader,
                                       max_num_models_per_replica, self)
                setattr(self, attr, cache)
            return await cache.get(model_id)

        method.__serve_multiplexed__ = True
        return method

    if func is not None:
        return wrap(func)
    return wrap

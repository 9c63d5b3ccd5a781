"""Search-space DSL: tune.uniform/loguniform/choice/grid_search/...
(port of ``ray_tpu/tune/sample.py``).

Reference: python/ray/tune/search/sample.py (Domain classes) and
variant_generator grid expansion.
"""

from __future__ import annotations

import numpy as np
from typing import Any, Callable, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: np.random.RandomState) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False,
                 q: Optional[float] = None):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.lower),
                                         np.log(self.upper))))
        else:
            v = float(rng.uniform(self.lower, self.upper))
        if self.q:
            v = float(np.round(v / self.q) * self.q)
        return v


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False,
                 q: int = 1):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = int(np.exp(rng.uniform(np.log(self.lower),
                                       np.log(self.upper))))
        else:
            v = int(rng.randint(self.lower, self.upper))
        if self.q > 1:
            v = int(np.round(v / self.q) * self.q)
        return max(self.lower, min(v, self.upper - 1))


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[rng.randint(len(self.categories))]


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        try:
            return self.fn({})
        except TypeError:
            return self.fn()


class GridSearch:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def qloguniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, log=True, q=q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Function:
    return Function(lambda _=None: float(np.random.randn() * sd + mean))


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> Dict[str, Any]:
    return {"grid_search": list(values)}


def _is_grid(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cross-product over grid_search entries; other values pass through."""
    grids: List[tuple] = []

    def walk(prefix, node):
        if isinstance(node, dict) and not _is_grid(node):
            for k, v in node.items():
                walk(prefix + (k,), v)
        elif _is_grid(node):
            grids.append((prefix, node["grid_search"]))

    walk((), space)
    if not grids:
        return [space]
    import itertools

    combos = itertools.product(*(vals for _, vals in grids))
    out = []
    for combo in combos:
        import copy

        cfg = copy.deepcopy(space)
        for (path, _), val in zip(grids, combo):
            d = cfg
            for p in path[:-1]:
                d = d[p]
            d[path[-1]] = val
        out.append(cfg)
    return out


def resolve(space: Dict[str, Any], rng: np.random.RandomState
            ) -> Dict[str, Any]:
    """Sample every Domain in (a grid-expanded) config."""

    def walk(node):
        if isinstance(node, Domain):
            return node.sample(rng)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(space)

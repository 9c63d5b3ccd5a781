"""Standalone replay-buffer family shared by off-policy algorithms.

A copy of the JAX package's ``rllib/replay_buffers.py`` (numpy only).
Analog of the reference's ``rllib/utils/replay_buffers/`` package
(``replay_buffer.py`` uniform base, ``prioritized_episode_buffer.py``
proportional PER): numpy ring storage keyed by field name, uniform or
proportional-priority sampling. Transition-level (not episode-level) —
the learners consume flat minibatches, so episode slicing
happens at rollout-to-transition conversion instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class ReplayBuffer:
    """Uniform-sampling numpy ring buffer (reference:
    utils/replay_buffers/replay_buffer.py)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._data: Optional[Dict[str, np.ndarray]] = None
        self._pos = 0
        self.size = 0

    def _ensure(self, transitions: Dict[str, np.ndarray]) -> None:
        if self._data is None:
            self._data = {
                k: np.empty((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in transitions.items()
            }

    def _write(self, chunk: Dict[str, np.ndarray]) -> Tuple[int, int]:
        """Write one <=capacity chunk at the ring head; returns the
        (start, length) the rows landed at (wrap handled)."""
        m = len(next(iter(chunk.values())))
        start, end = self._pos, self._pos + m
        if end <= self.capacity:
            for k, v in chunk.items():
                self._data[k][start:end] = v
        else:
            head = self.capacity - start
            for k, v in chunk.items():
                self._data[k][start:] = v[:head]
                self._data[k][:end - self.capacity] = v[head:]
        self._pos = end % self.capacity
        self.size = min(self.capacity, self.size + m)
        return start, m

    def add(self, transitions: Dict[str, np.ndarray]) -> None:
        self._ensure(transitions)
        n = len(next(iter(transitions.values())))
        for s in range(0, n, self.capacity):
            self._write({k: v[s:s + self.capacity]
                         for k, v in transitions.items()})

    def sample(self, batch_size: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, batch_size)
        return {k: v[idx] for k, v in self._data.items()}

    def __len__(self) -> int:
        return self.size


class SumTree:
    """Flat-array binary sum tree: O(log n) priority update + prefix-sum
    sampling (reference: the segment trees under
    utils/replay_buffers/prioritized_episode_buffer.py)."""

    def __init__(self, capacity: int):
        self.capacity = int(2 ** np.ceil(np.log2(max(1, capacity))))
        self._tree = np.zeros(2 * self.capacity, np.float64)

    def set(self, idx: np.ndarray, priority: np.ndarray) -> None:
        leaf = np.asarray(idx, np.int64) + self.capacity
        self._tree[leaf] = priority
        # leaves share one level, so parent sets stay level-aligned
        parent = np.unique(leaf // 2)
        while parent[0] >= 1:
            self._tree[parent] = (self._tree[2 * parent]
                                  + self._tree[2 * parent + 1])
            if parent[0] == 1:
                break
            parent = np.unique(parent // 2)

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self._tree[np.asarray(idx) + self.capacity]

    @property
    def total(self) -> float:
        return float(self._tree[1])

    def find_prefix(self, prefix: np.ndarray) -> np.ndarray:
        """Vectorized descent: for each prefix sum, the leaf index whose
        cumulative-priority interval contains it."""
        prefix = np.asarray(prefix, np.float64).copy()
        idx = np.ones(len(prefix), np.int64)
        while idx[0] < self.capacity:
            left = 2 * idx
            left_sum = self._tree[left]
            go_right = prefix > left_sum
            prefix = np.where(go_right, prefix - left_sum, prefix)
            idx = np.where(go_right, left + 1, left)
        return idx - self.capacity


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER (Schaul et al.): P(i) ∝ p_i^alpha, importance
    weights w_i = (N * P(i))^-beta / max w (reference:
    utils/replay_buffers/prioritized_episode_buffer.py)."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6):
        super().__init__(capacity)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._tree = SumTree(capacity)
        self._max_priority = 1.0

    def add(self, transitions: Dict[str, np.ndarray]) -> None:
        self._ensure(transitions)
        n = len(next(iter(transitions.values())))
        for s in range(0, n, self.capacity):
            chunk = {k: v[s:s + self.capacity]
                     for k, v in transitions.items()}
            start, m = self._write(chunk)
            idx = (np.arange(start, start + m) % self.capacity)
            self._tree.set(idx, np.full(m, self._max_priority ** self.alpha))

    def sample(self, batch_size: int, rng: np.random.Generator
               ) -> Dict[str, np.ndarray]:
        """Returns the batch plus ``indices`` (for update_priorities) and
        ``weights`` (importance-sampling corrections)."""
        total = self._tree.total
        # stratified prefix sampling (one uniform draw per segment)
        seg = total / batch_size
        prefix = (np.arange(batch_size) + rng.random(batch_size)) * seg
        idx = self._tree.find_prefix(np.minimum(prefix, total - 1e-9))
        idx = np.minimum(idx, self.size - 1)
        p = self._tree.get(idx) / max(total, 1e-12)
        w = (self.size * np.maximum(p, 1e-12)) ** (-self.beta)
        w = (w / w.max()).astype(np.float32)
        out = {k: v[idx] for k, v in self._data.items()}
        out["indices"] = idx
        out["weights"] = w
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        p = np.abs(np.asarray(td_errors, np.float64)) + self.eps
        self._max_priority = max(self._max_priority, float(p.max()))
        self._tree.set(np.asarray(indices), p ** self.alpha)

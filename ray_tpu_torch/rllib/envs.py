"""Spaces, a synchronous vectorizer and CartPole-v1, on numpy alone.

The env runners of the JAX package step their envs through gymnasium's
``SyncVectorEnv`` and read spaces as ``gym.spaces.Box`` / ``Discrete``.
The port's RL path needs no gymnasium:

- ``Box`` and ``Discrete`` carry what the runners and modules read
  (``shape``, ``dtype``, ``low``, ``high``, ``n``); every reader of a
  space reads those attributes, so gymnasium's spaces serve as well.
- ``SyncVectorEnv`` steps a list of envs with gymnasium 1.x's NEXT_STEP
  autoreset: the step after an episode's end resets that env, ignores
  its action and reports reward 0, not terminated, not truncated.
  ``reset(seed=s)`` seeds env ``i`` with ``s + i``; observations come
  back as one ``float32`` array (copied), rewards as ``float64``.
- ``CartPoleEnv`` is gymnasium's ``CartPole-v1`` (the Barto, Sutton and
  Anderson cart-pole, Euler integration, the 500-step time limit of
  ``gym.make``), seeded as gymnasium seeds it
  (``np.random.default_rng(seed)``), so the same seed and actions give
  the same observations bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Box:
    """A box of ``shape`` between ``low`` and ``high`` (broadcast)."""

    def __init__(self, low, high, shape: Optional[Sequence[int]] = None,
                 dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype),
                                   self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype),
                                    self.shape).copy()

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Discrete:
    """The integers ``0 .. n-1``."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape: Tuple[int, ...] = ()
        self.dtype = np.dtype(np.int64)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class CartPoleEnv:
    """gymnasium's ``CartPole-v1`` as ``gym.make`` builds it: reward 1 a
    step, termination past 12 degrees or 2.4 of cart position,
    truncation at ``max_episode_steps``."""

    def __init__(self, max_episode_steps: int = 500):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        self.max_episode_steps = max_episode_steps
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.np_random: Optional[np.random.Generator] = None
        self.state: Optional[np.ndarray] = None
        self._elapsed = 0
        self._steps_beyond_terminated: Optional[int] = None

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.default_rng(seed)
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self._steps_beyond_terminated = None
        self._elapsed = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        if self.state is None:
            raise RuntimeError("call reset() before step()")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = (temp - self.polemass_length * thetaacc * costheta
                / self.total_mass)
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 1.0
        elif self._steps_beyond_terminated is None:
            self._steps_beyond_terminated = 0
            reward = 1.0
        else:
            self._steps_beyond_terminated += 1
            reward = 0.0
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return (np.array(self.state, dtype=np.float32), reward, terminated,
                truncated, {})

    def close(self) -> None:
        pass


class SyncVectorEnv:
    """``num_envs`` envs stepped in turn, gymnasium 1.x's NEXT_STEP
    autoreset (see the module's docstring)."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        obs_dtype = getattr(self.single_observation_space, "dtype",
                            np.float32)
        self._obs = np.zeros(
            (self.num_envs,) + tuple(self.single_observation_space.shape),
            obs_dtype)
        self._rewards = np.zeros(self.num_envs, np.float64)
        self._terminations = np.zeros(self.num_envs, bool)
        self._truncations = np.zeros(self.num_envs, bool)
        self._autoreset = np.zeros(self.num_envs, bool)

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[np.ndarray, Dict[str, Any]]:
        seeds: List[Optional[int]] = (
            [None] * self.num_envs if seed is None
            else [seed + i for i in range(self.num_envs)])
        self._terminations[:] = False
        self._truncations[:] = False
        self._autoreset[:] = False
        for i, (env, s) in enumerate(zip(self.envs, seeds)):
            self._obs[i], _ = env.reset(seed=s)
        return self._obs.copy(), {}

    def step(self, actions):
        for i, env in enumerate(self.envs):
            if self._autoreset[i]:
                self._obs[i], _ = env.reset()
                self._rewards[i] = 0.0
                self._terminations[i] = False
                self._truncations[i] = False
            else:
                (self._obs[i], self._rewards[i], self._terminations[i],
                 self._truncations[i], _) = env.step(actions[i])
        self._autoreset = self._terminations | self._truncations
        return (self._obs.copy(), self._rewards.copy(),
                self._terminations.copy(), self._truncations.copy(), {})

    def close(self) -> None:
        for env in self.envs:
            env.close()

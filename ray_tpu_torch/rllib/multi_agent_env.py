"""MultiAgentEnv API + a dependency-free cooperative benchmark env.

Port of the JAX package's ``rllib/multi_agent_env.py`` (its spaces are
the port's ``envs.Box`` / ``envs.Discrete``, so no gymnasium). Analog of
the reference's MultiAgentEnv (rllib/env/multi_agent_env.py) — the
parallel dict API: ``reset() -> (obs_dict, info_dict)`` and
``step(action_dict) -> (obs, rew, terminated, truncated, info)`` dicts
keyed by agent id, with the special ``"__all__"`` key in
terminated/truncated marking episode end for every agent.

``SimpleSpread`` is an in-repo reimplementation of the classic
cooperative multi-agent particle task (PettingZoo MPE ``simple_spread``
semantics, written from scratch): N agents must cover N landmarks; the
team reward each step is the negative sum over landmarks of the distance
to the closest agent, so agents only score well by *spreading out* —
independent greedy behavior (everyone rushing the same landmark) leaves
the other landmarks uncovered. It is the repo's learning-gate env for
multi-agent PPO (reference uses the MPE family the same way in
rllib/examples).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .envs import Box, Discrete


class MultiAgentEnv:
    """Base class: subclasses define ``possible_agents``,
    ``observation_spaces``/``action_spaces`` dicts, ``reset`` and
    ``step`` (reference: rllib/env/multi_agent_env.py)."""

    possible_agents: List[str] = []
    observation_spaces: Dict[str, Any] = {}
    action_spaces: Dict[str, Any] = {}

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def observation_space(self, agent_id: str):
        return self.observation_spaces[agent_id]

    def action_space(self, agent_id: str):
        return self.action_spaces[agent_id]

    def close(self) -> None:
        pass


_MOVES = np.array([[0.0, 0.0], [0.0, 1.0], [0.0, -1.0],
                   [-1.0, 0.0], [1.0, 0.0]], np.float32)


class SimpleSpread(MultiAgentEnv):
    """Cooperative coverage: N agents, N landmarks on the [-1, 1]^2 plane.

    Discrete(5) actions (noop/up/down/left/right) move an agent by
    ``step_size``. Every agent receives the same team reward:
    ``-sum_l min_a dist(agent_a, landmark_l)`` — maximized by a 1:1
    agent->landmark assignment. Episodes truncate at ``max_steps``.
    Observation per agent: own position, relative positions of the other
    agents, relative positions of all landmarks (fully observable).
    """

    def __init__(self, n_agents: int = 2, max_steps: int = 25,
                 step_size: float = 0.15, seed: int = 0):
        self.n = n_agents
        self.max_steps = max_steps
        self.step_size = step_size
        self.possible_agents = [f"agent_{i}" for i in range(n_agents)]
        self.agents: List[str] = []
        obs_dim = 2 + 2 * (n_agents - 1) + 2 * n_agents
        obs_space = Box(-4.0, 4.0, (obs_dim,), np.float32)
        act_space = Discrete(5)
        self.observation_spaces = {a: obs_space for a in self.possible_agents}
        self.action_spaces = {a: act_space for a in self.possible_agents}
        self._rng = np.random.default_rng(seed)
        self._pos = np.zeros((n_agents, 2), np.float32)
        self._landmarks = np.zeros((n_agents, 2), np.float32)
        self._t = 0

    def _obs(self) -> Dict[str, np.ndarray]:
        out = {}
        for i, a in enumerate(self.possible_agents):
            others = np.delete(self._pos, i, axis=0) - self._pos[i]
            lm = self._landmarks - self._pos[i]
            out[a] = np.concatenate(
                [self._pos[i], others.ravel(), lm.ravel()]).astype(np.float32)
        return out

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = self._rng.uniform(-1, 1, (self.n, 2)).astype(np.float32)
        self._landmarks = self._rng.uniform(
            -1, 1, (self.n, 2)).astype(np.float32)
        self._t = 0
        self.agents = list(self.possible_agents)
        return self._obs(), {a: {} for a in self.agents}

    def step(self, action_dict: Dict[str, int]):
        for i, a in enumerate(self.possible_agents):
            act = int(action_dict.get(a, 0))
            self._pos[i] = np.clip(
                self._pos[i] + _MOVES[act] * self.step_size, -2.0, 2.0)
        self._t += 1
        # team reward: every landmark wants its closest agent nearby
        d = np.linalg.norm(self._pos[None, :, :]
                           - self._landmarks[:, None, :], axis=-1)
        reward = float(-d.min(axis=1).sum())
        done = self._t >= self.max_steps
        obs = self._obs()
        rew = {a: reward for a in self.possible_agents}
        term = {a: False for a in self.possible_agents}
        term["__all__"] = False
        trunc = {a: done for a in self.possible_agents}
        trunc["__all__"] = done
        if done:
            self.agents = []
        return obs, rew, term, trunc, {a: {} for a in self.possible_agents}

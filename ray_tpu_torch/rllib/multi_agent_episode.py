"""MultiAgentEpisode: per-agent trajectories aligned on a global clock.

A copy of the JAX package's ``rllib/multi_agent_episode.py`` (numpy
only). Analog of the reference's MultiAgentEpisode
(rllib/env/multi_agent_episode.py — 2,754 LoC there; the load-bearing
subset here): one episode of a multi-agent env holds a *global* env-step
counter plus one trajectory per agent that actually acted, with an
env_t -> agent_t mapping so agents that step intermittently (turn-based
envs, agents joining late or dying early) still produce dense per-agent
training sequences. ``cut()`` carries live state across rollout
boundaries the way the reference's episode-chunking does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class _AgentTrajectory:
    """Dense per-agent sequence: obs[t] -> action[t] -> reward[t]."""

    __slots__ = ("obs", "actions", "rewards", "logp", "vf", "terminated",
                 "env_ts", "last_obs")

    def __init__(self):
        self.obs: List[np.ndarray] = []
        self.actions: List[int] = []
        self.rewards: List[float] = []
        self.logp: List[float] = []
        self.vf: List[float] = []
        self.env_ts: List[int] = []  # global env step of each agent step
        self.terminated = False
        self.last_obs: Optional[np.ndarray] = None  # bootstrap obs

    def __len__(self) -> int:
        return len(self.actions)

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "obs": np.asarray(self.obs, np.float32),
            "actions": np.asarray(self.actions, np.int64),
            "rewards": np.asarray(self.rewards, np.float32),
            "logp": np.asarray(self.logp, np.float32),
            "vf_preds": np.asarray(self.vf, np.float32),
        }


class MultiAgentEpisode:
    """One (possibly still-running) episode of a MultiAgentEnv."""

    def __init__(self):
        self.env_t = 0
        self.agent_episodes: Dict[str, _AgentTrajectory] = {}
        self.is_done = False
        self._pending_obs: Dict[str, np.ndarray] = {}
        self.total_reward = 0.0

    # ---- building -------------------------------------------------------

    def add_reset(self, obs: Dict[str, np.ndarray]) -> None:
        self._pending_obs = dict(obs)

    def pending_obs(self) -> Dict[str, np.ndarray]:
        """Agents that need an action for the next env step."""
        return self._pending_obs

    def add_step(self, actions: Dict[str, int], logp: Dict[str, float],
                 vf: Dict[str, float], next_obs: Dict[str, np.ndarray],
                 rewards: Dict[str, float], terminateds: Dict[str, bool],
                 truncateds: Dict[str, bool]) -> None:
        """Record one env step: the acting agents' (obs, action, reward)
        plus the global-clock mapping (reference: env_t_to_agent_t)."""
        for aid, act in actions.items():
            traj = self.agent_episodes.get(aid)
            if traj is None:
                traj = self.agent_episodes[aid] = _AgentTrajectory()
            traj.obs.append(self._pending_obs[aid])
            traj.actions.append(int(act))
            traj.logp.append(float(logp.get(aid, 0.0)))
            traj.vf.append(float(vf.get(aid, 0.0)))
            r = float(rewards.get(aid, 0.0))
            traj.rewards.append(r)
            traj.env_ts.append(self.env_t)
            self.total_reward += r
            if terminateds.get(aid, False):
                traj.terminated = True
        self.env_t += 1
        all_done = bool(terminateds.get("__all__", False)
                        or truncateds.get("__all__", False))
        self.is_done = all_done
        self._pending_obs = {
            aid: o for aid, o in next_obs.items()
            if not (all_done or terminateds.get(aid, False)
                    or truncateds.get(aid, False))}
        if all_done:
            for traj in self.agent_episodes.values():
                traj.last_obs = None  # no bootstrap needed
        else:
            for aid, o in next_obs.items():
                traj = self.agent_episodes.get(aid)
                if traj is not None:
                    traj.last_obs = np.asarray(o, np.float32)

    def cut(self) -> "MultiAgentEpisode":
        """Rollout boundary on a live episode: return a fresh episode
        that continues from the current observations (the consumed chunk
        keeps its ``last_obs`` for value bootstrap — reference: episode
        chunking in MultiAgentEnvRunner.sample)."""
        nxt = MultiAgentEpisode()
        nxt._pending_obs = dict(self._pending_obs)
        nxt.env_t = self.env_t
        return nxt

    # ---- consuming ------------------------------------------------------

    def agent_trajectories(self) -> Dict[str, Dict[str, Any]]:
        """Per-agent training arrays. ``terminated``=False with a
        ``last_obs`` means the trajectory was truncated (rollout boundary
        or time limit) and the critic bootstraps from ``last_obs``."""
        out = {}
        for aid, traj in self.agent_episodes.items():
            if len(traj) == 0:
                continue
            d = traj.arrays()
            d["terminated"] = traj.terminated
            d["last_obs"] = traj.last_obs
            out[aid] = d
        return out

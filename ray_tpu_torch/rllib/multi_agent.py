"""Multi-agent RL: MultiRLModule, MultiAgentEnvRunner, multi-agent PPO.

Port of the JAX package's ``rllib/multi_agent.py`` (reference:
MultiRLModule, rllib/core/rl_module/multi_rl_module.py;
MultiAgentEnvRunner, rllib/env/multi_agent_env_runner.py:55; the
policy-mapping plumbing in AlgorithmConfig.multi_agent()): a
MultiRLModule is a dict of modules, one forward per module batched over
every (env, agent) pair the policy controls that step, so adding agents
widens a batch instead of adding Python loop iterations.

Policies may be *shared* (several agents -> one module id, parameter
sharing) or *independent* (one module per agent); the
``policy_mapping_fn(agent_id) -> module_id`` decides, exactly like the
reference's ``policy_mapping_fn``.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .env_runner import (fit_threads_to_reservation, gumbel_argmax,
                          runner_probe)
from .multi_agent_episode import MultiAgentEpisode
from .rl_module import RLModuleSpec, load_numpy


def _default_mapping(agent_id: str) -> str:
    return "default_policy"


def map_all_to(policy_id: str, agent_id: str) -> str:
    """Picklable single-policy mapping: ``functools.partial(map_all_to,
    pid)`` maps every agent to ``pid`` (parameter sharing)."""
    return policy_id


@dataclass
class MultiRLModuleSpec:
    """Builds one module per policy id from the env's per-agent spaces
    (reference: MultiRLModuleSpec in multi_rl_module.py). The mapping fn
    must be picklable (top-level function / functools.partial) — it
    ships to remote env-runner actors."""

    module_specs: Dict[str, RLModuleSpec] = field(default_factory=dict)
    policy_mapping_fn: Callable[[str], str] = _default_mapping

    def module_spaces(self, env) -> Dict[str, Tuple[Any, Any]]:
        """module_id -> (obs_space, act_space), from the first agent the
        mapping assigns to each module."""
        spaces: Dict[str, Tuple[Any, Any]] = {}
        for aid in env.possible_agents:
            mid = self.policy_mapping_fn(aid)
            if mid not in spaces:
                spaces[mid] = (env.observation_space(aid),
                               env.action_space(aid))
        return spaces

    def build_all(self, env) -> Dict[str, Any]:
        modules = {}
        for mid, (obs_sp, act_sp) in self.module_spaces(env).items():
            spec = self.module_specs.get(mid, RLModuleSpec())
            modules[mid] = spec.build(obs_sp, act_sp)
        return modules


class MultiAgentEnvRunner:
    """Steps ``num_envs`` MultiAgentEnv instances, batching inference
    per policy module across all (env, agent) pairs (reference:
    multi_agent_env_runner.py:55 ``sample``). Same actor contract as
    SingleAgentEnvRunner, so EnvRunnerGroup drives either. Its modules
    are on the CPU; draws come from its ``torch.Generator``."""

    def __init__(self, env_creator: Callable, module_spec: MultiRLModuleSpec,
                 num_envs: int, rollout_len: int, seed: int = 0,
                 worker_idx: int = 0):
        fit_threads_to_reservation()
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.spec = module_spec
        self.envs = [env_creator() for _ in range(num_envs)]
        self.modules = module_spec.build_all(self.envs[0])
        self._map = module_spec.policy_mapping_fn
        self._params: Optional[Dict[str, Any]] = None
        self._rng = np.random.default_rng(seed * 10007 + worker_idx)
        self._gen = torch.Generator().manual_seed(
            int(self._rng.integers(0, 2 ** 31)))
        self.episodes: List[MultiAgentEpisode] = []
        for i, env in enumerate(self.envs):
            obs, _ = env.reset(seed=seed * 10007 + worker_idx * 131 + i)
            ep = MultiAgentEpisode()
            ep.add_reset(obs)
            self.episodes.append(ep)
        self._completed: List[MultiAgentEpisode] = []

    # ---- weights ----

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for mid, w in weights.items():
            load_numpy(self.modules[mid], w)
        self._params = weights

    def get_weights(self):
        return self._params

    def ping(self) -> str:
        return "ok"

    def probe(self) -> Dict[str, object]:
        return runner_probe()

    # ---- inference ----

    def _draw_actions(self, logits: torch.Tensor) -> torch.Tensor:
        return gumbel_argmax(logits, self._gen)

    def _forward_module(self, mid: str, obs: np.ndarray):
        with torch.no_grad():
            logits, value = self.modules[mid](torch.from_numpy(obs))
            action = self._draw_actions(logits)
            logp = torch.log_softmax(logits, -1).gather(
                1, action[:, None])[:, 0]
        return (action.numpy(), logp.numpy().astype(np.float32),
                value.numpy().astype(np.float32))

    def _value(self, mid: str, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.modules[mid](torch.from_numpy(obs))[1].numpy()

    # ---- sampling ----

    def sample(self, weights: Optional[Dict[str, Any]] = None,
               **_kw) -> Tuple[Dict[str, List[Dict]], Dict[str, Any]]:
        """``rollout_len`` global env steps across all envs. Returns
        (per-module trajectory lists, stats). Each trajectory dict has
        flat [T_agent] arrays + ``vf_last`` for truncation bootstrap."""
        if weights is not None:
            self.set_weights(weights)
        if self._params is None:
            raise RuntimeError("no weights set")
        t0 = time.perf_counter()
        chunks: List[Tuple[str, MultiAgentEpisode]] = []  # done episodes
        for _ in range(self.rollout_len):
            # batch per module over (env, agent) pairs needing an action
            per_mid: Dict[str, List[Tuple[int, str]]] = {}
            for ei, ep in enumerate(self.episodes):
                for aid in ep.pending_obs():
                    per_mid.setdefault(self._map(aid), []).append((ei, aid))
            acts: List[Dict[str, int]] = [{} for _ in self.envs]
            logps: List[Dict[str, float]] = [{} for _ in self.envs]
            vfs: List[Dict[str, float]] = [{} for _ in self.envs]
            for mid, pairs in per_mid.items():
                obs = np.stack([self.episodes[ei].pending_obs()[aid]
                                for ei, aid in pairs])
                a, lp, v = self._forward_module(mid, obs)
                for j, (ei, aid) in enumerate(pairs):
                    acts[ei][aid] = int(a[j])
                    logps[ei][aid] = float(lp[j])
                    vfs[ei][aid] = float(v[j])
            for ei, env in enumerate(self.envs):
                ep = self.episodes[ei]
                obs, rew, term, trunc, _ = env.step(acts[ei])
                ep.add_step(acts[ei], logps[ei], vfs[ei], obs, rew,
                            term, trunc)
                if ep.is_done:
                    chunks.append(("done", ep))
                    self._completed.append(ep)
                    nobs, _ = env.reset()
                    nep = MultiAgentEpisode()
                    nep.add_reset(nobs)
                    self.episodes[ei] = nep
        # rollout boundary: consume live chunks, continue fresh ones
        for ei, ep in enumerate(self.episodes):
            if ep.env_t > 0 and ep.agent_episodes:
                chunks.append(("cut", ep))
                self.episodes[ei] = ep.cut()
        out: Dict[str, List[Dict]] = {}
        n_agent_steps = 0
        for _kind, ep in chunks:
            for aid, traj in ep.agent_trajectories().items():
                mid = self._map(aid)
                last = traj.pop("last_obs")
                if traj["terminated"] or last is None:
                    traj["vf_last"] = 0.0
                else:
                    traj["vf_last"] = float(self._value(mid, last[None, :])[0])
                n_agent_steps += len(traj["actions"])
                out.setdefault(mid, []).append(traj)
        stats = {
            "episode_returns": [ep.total_reward for ep in self._completed],
            "episode_lens": [ep.env_t for ep in self._completed],
            "env_steps": self.rollout_len * self.num_envs,
            "agent_steps": n_agent_steps,
            "sample_time_s": time.perf_counter() - t0,
        }
        self._completed = []
        return out, stats


def gae_trajectory(traj: Dict[str, Any], gamma: float,
                   lam: float) -> Dict[str, np.ndarray]:
    """GAE over one flat [T] agent trajectory (bootstraps ``vf_last``)."""
    rew, vf = traj["rewards"], traj["vf_preds"]
    T = len(rew)
    next_vf = np.append(vf[1:], np.float32(traj["vf_last"]))
    # only the final transition can be terminal in a per-episode chunk
    nonterminal = np.ones(T, np.float32)
    if traj["terminated"]:
        nonterminal[-1] = 0.0
    adv = np.zeros(T, np.float32)
    last = 0.0
    for t in range(T - 1, -1, -1):
        delta = rew[t] + gamma * next_vf[t] * nonterminal[t] - vf[t]
        last = delta + gamma * lam * nonterminal[t] * last
        adv[t] = last
    return {
        "obs": traj["obs"], "actions": traj["actions"],
        "logp": traj["logp"], "advantages": adv,
        "value_targets": adv + vf, "vf_preds": vf,
    }


class MultiAgentLearnerGroup:
    """One Learner per policy module (reference: LearnerGroup holding a
    MultiRLModule — per-module optimizers, joint update call)."""

    def __init__(self, config, ma_spec: MultiRLModuleSpec,
                 module_spaces: Dict[str, Tuple[Any, Any]], loss_fn):
        """Each policy's minibatch order is seeded from
        ``zlib.crc32`` of its id: stable across processes, where the JAX
        group's ``hash(mid)`` of a ``str`` changes with the interpreter's
        hash salt (``PYTHONHASHSEED``)."""
        from .learner import Learner

        if config.num_learners > 0:
            raise NotImplementedError(
                "multi-agent with remote learner actors is not wired yet; "
                "use num_learners=0")
        self._learners: Dict[str, Any] = {}
        for mid, (obs_sp, act_sp) in module_spaces.items():
            spec = ma_spec.module_specs.get(mid, RLModuleSpec())
            module = spec.build(obs_sp, act_sp)
            self._learners[mid] = Learner(module, config, loss_fn)

    def update(self, per_module_flat: Dict[str, Dict[str, np.ndarray]], *,
               num_epochs: int, minibatch_size: int,
               seed: int = 0) -> Dict[str, Dict[str, float]]:
        out = {}
        for mid, flat in per_module_flat.items():
            out[mid] = self._learners[mid].update(
                flat, num_epochs=num_epochs, minibatch_size=minibatch_size,
                rng=np.random.default_rng(
                    seed * 997 + zlib.crc32(mid.encode()) % 1000))
        return out

    def get_weights(self) -> Dict[str, Any]:
        return {mid: lr.get_weights() for mid, lr in self._learners.items()}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for mid, w in weights.items():
            self._learners[mid].set_weights(w)

    def get_state(self):
        import pickle

        return pickle.dumps(
            {mid: lr.get_state() for mid, lr in self._learners.items()})

    def set_state(self, blob) -> None:
        import pickle

        for mid, st in pickle.loads(blob).items():
            self._learners[mid].set_state(st)

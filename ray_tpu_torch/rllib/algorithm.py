"""Algorithm base + fault-tolerant EnvRunnerGroup.

Port of the JAX package's ``rllib/algorithm.py`` (reference:
rllib/algorithms/algorithm.py:227 — a Tune Trainable whose .step() runs
one training iteration — and rllib/env/env_runner_group.py:71 with the
FaultTolerantActorManager behavior, rllib/utils/actor_manager.py:196):
sampling skips dead runners, and restore_workers() recreates them
mid-training. Runners are CPU actors of the port's runtime; the
learners are built by each algorithm (on the card by default).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.tune.controller import Trainable

from .env_runner import SingleAgentEnvRunner


class EnvRunnerGroup:
    def __init__(self, config, env_creator, module_spec,
                 runner_cls=SingleAgentEnvRunner):
        self.config = config
        self._env_creator = env_creator
        self._module_spec = module_spec
        self._runner_cls = rt.remote(
            num_cpus=config.num_cpus_per_env_runner)(runner_cls)
        self._runners: List[Any] = []
        self._healthy: List[bool] = []
        self.num_restarts = 0
        self._local: Optional[Any] = None
        if config.num_env_runners <= 0:
            self._local = runner_cls(
                env_creator, module_spec, config.num_envs_per_env_runner,
                config.rollout_fragment_length, seed=config.seed)
            return
        for i in range(config.num_env_runners):
            self._runners.append(self._make_runner(i))
            self._healthy.append(True)

    def _make_runner(self, idx: int):
        return self._runner_cls.remote(
            self._env_creator, self._module_spec,
            self.config.num_envs_per_env_runner,
            self.config.rollout_fragment_length,
            seed=self.config.seed, worker_idx=idx + self.num_restarts * 1000)

    @property
    def num_healthy(self) -> int:
        if self._local is not None:
            return 1
        return sum(self._healthy)

    def sample(self, weights, **kw) -> Tuple[List[Dict], List[Dict]]:
        """Fan out sample() to healthy runners; mark failures dead instead
        of raising (reference: foreach_worker fault-tolerant fanout).
        Extra kwargs (e.g. ``epsilon``) pass through to the runners."""
        if self._local is not None:
            b, s = self._local.sample(weights, **kw)
            return [b], [s]
        wref = rt.put(weights)
        refs = []
        for i, r in enumerate(self._runners):
            if self._healthy[i]:
                refs.append((i, r.sample.remote(wref, **kw)))
        batches, stats = [], []
        for i, ref in refs:
            try:
                b, s = rt.get(ref, timeout=120)
                batches.append(b)
                stats.append(s)
            except Exception:  # noqa: BLE001 — actor death / timeout
                self._healthy[i] = False
        return batches, stats

    def restore_workers(self) -> int:
        """Recreate dead runners (reference: Algorithm.restore_workers
        :1615 + probe_unhealthy_workers)."""
        if self._local is not None:
            return 0
        restored = 0
        for i, ok in enumerate(self._healthy):
            if not ok:
                try:
                    # a HUNG (not dead) runner would otherwise keep its
                    # worker process + CPU reservation forever
                    rt.kill(self._runners[i])
                except Exception:  # noqa: BLE001
                    pass
                self.num_restarts += 1
                self._runners[i] = self._make_runner(i)
                self._healthy[i] = True
                restored += 1
        return restored

    def probe(self) -> None:
        if self._local is not None:
            return
        for i, r in enumerate(self._runners):
            if not self._healthy[i]:
                continue
            try:
                rt.get(r.ping.remote(), timeout=30)
            except Exception:  # noqa: BLE001
                self._healthy[i] = False

    def stop(self) -> None:
        for r in self._runners:
            try:
                rt.kill(r)
            except Exception:  # noqa: BLE001
                pass


class Algorithm(Trainable):
    """Subclass Trainable: runs standalone via .train() or under Tune."""

    config_class = None

    def setup(self, config) -> None:
        from .config import AlgorithmConfig

        if isinstance(config, dict):
            base = self.config_class() if self.config_class else None
            if base is None:
                raise ValueError("dict config requires a concrete Algorithm")
            for k, v in config.items():
                setattr(base, k, v)
            config = base
        if not isinstance(config, AlgorithmConfig):
            raise TypeError(f"an AlgorithmConfig or a dict, not "
                            f"{type(config).__name__}")
        self.algo_config = config
        self._iteration = 0
        self._timesteps_total = 0
        env_creator = config.make_env_creator()
        probe_env = env_creator()
        self.ma_spec = None
        self.module_spaces = None
        if config.is_multi_agent():
            if not getattr(self, "_supports_multi_agent", False):
                raise ValueError(
                    f"{type(self).__name__} does not support multi-agent "
                    "configs (use PPO)")
            self.ma_spec = self._make_multi_spec(config)
            self.module_spaces = self.ma_spec.module_spaces(probe_env)
            self.obs_space = self.act_space = None
        else:
            self.obs_space = probe_env.observation_space
            self.act_space = probe_env.action_space
        probe_env.close()
        self.env_runner_group = self._make_env_runner_group(
            config, env_creator)
        self.learner_group = self._build_learner_group()

    @staticmethod
    def _make_multi_spec(config):
        import functools

        from .multi_agent import MultiRLModuleSpec, map_all_to
        from .rl_module import RLModuleSpec

        policies = config.policies or {"default_policy": None}
        specs = {pid: (s if s is not None else RLModuleSpec())
                 for pid, s in policies.items()}
        mapping = config.policy_mapping_fn
        if mapping is None:
            if len(specs) != 1:
                raise ValueError(
                    "multiple policies need a policy_mapping_fn")
            mapping = functools.partial(map_all_to, next(iter(specs)))
        return MultiRLModuleSpec(module_specs=specs,
                                 policy_mapping_fn=mapping)

    def _make_env_runner_group(self, config, env_creator) -> EnvRunnerGroup:
        """Hook for algorithms with non-default runners (e.g. SAC's
        continuous-action runner)."""
        if self.ma_spec is not None:
            from .multi_agent import MultiAgentEnvRunner

            return EnvRunnerGroup(config, env_creator, self.ma_spec,
                                  runner_cls=MultiAgentEnvRunner)
        return EnvRunnerGroup(config, env_creator, config.rl_module_spec)

    # subclasses provide the loss / update wiring
    def _build_learner_group(self):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        result = self.training_step()
        self._iteration += 1
        self._timesteps_total += result.get("num_env_steps_sampled", 0)
        result.update(
            training_iteration=self._iteration,
            timesteps_total=self._timesteps_total,
            time_this_iter_s=time.perf_counter() - t0,
            num_healthy_workers=self.env_runner_group.num_healthy,
        )
        return result

    # standalone API (outside Tune)
    def train(self) -> Dict[str, Any]:
        return self.step()

    def get_weights(self):
        return self.learner_group.get_weights()

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        state = {
            "learner": self.learner_group.get_state(),
            "iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
        }
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"), "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]

    # reference naming
    def save(self, checkpoint_dir: str) -> str:
        self.save_checkpoint(checkpoint_dir)
        return checkpoint_dir

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, config) -> "Algorithm":
        algo = cls(config=config if not hasattr(config, "copy")
                   else config.copy())
        algo.load_checkpoint(checkpoint_dir)
        return algo

    def cleanup(self) -> None:
        self.env_runner_group.stop()
        stop = getattr(self.learner_group, "stop", None)
        if stop is not None:
            stop()

    stop = cleanup

    def __init__(self, config=None, **kwargs):
        # Trainable.__init__ expects a dict; accept AlgorithmConfig too
        super().__init__(config if config is not None else {})


def summarize_episode_stats(stats: List[Dict]) -> Dict[str, float]:
    returns: List[float] = []
    lens: List[int] = []
    steps = 0
    for s in stats:
        returns.extend(s.get("episode_returns", []))
        lens.extend(s.get("episode_lens", []))
        steps += s.get("env_steps", 0)
    out = {"num_env_steps_sampled": steps}
    if returns:
        out["episode_return_mean"] = float(np.mean(returns))
        out["episode_return_max"] = float(np.max(returns))
        out["episode_return_min"] = float(np.min(returns))
        out["episode_len_mean"] = float(np.mean(lens))
    return out

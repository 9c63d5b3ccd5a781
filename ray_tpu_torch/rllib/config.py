"""AlgorithmConfig: fluent builder for RL algorithms.

Port of the JAX package's ``rllib/config.py`` (reference:
rllib/algorithms/algorithm_config.py — 5,106 LoC of validation; here the
load-bearing subset): .environment() / .env_runners() / .training() /
.learners() / .multi_agent() chain, then .build() -> Algorithm.

``learners(num_gpus_per_learner=...)`` is upstream Ray's name: cards a
learner takes, 1 by default (0: the learner on the CPU). The JAX
package's ``learners(mesh=...)`` is kept as a name, and the learner
refuses a mesh (see ``learner.py``).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

from .rl_module import RLModuleSpec


class AlgorithmConfig:
    algo_class: Optional[type] = None

    def __init__(self):
        # environment
        self.env: Optional[str] = None
        self.env_creator: Optional[Callable] = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners: int = 2
        self.num_envs_per_env_runner: int = 8
        self.rollout_fragment_length: int = 64
        self.num_cpus_per_env_runner: float = 1.0
        self.restart_failed_env_runners: bool = True
        # training
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 2048
        self.seed: int = 0
        # module
        self.rl_module_spec: RLModuleSpec = RLModuleSpec()
        # learners
        self.num_learners: int = 0  # 0 = learner in the driver process
        self.num_cpus_per_learner: float = 1.0
        self.num_gpus_per_learner: float = 1.0  # 0 = learner on the CPU
        self.mesh = None  # refused by the learner (see learner.py)
        # multi-agent (reference: AlgorithmConfig.multi_agent —
        # policies + policy_mapping_fn select the MultiAgentEnvRunner /
        # MultiRLModule path)
        self.policies: Dict[str, Optional[RLModuleSpec]] = {}
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None

    # ---- builder sections (each returns self for chaining) ----

    def environment(self, env=None, *, env_config=None, env_creator=None):
        if env is not None:
            self.env = env
        if env_creator is not None:
            self.env_creator = env_creator
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None,
                    rollout_fragment_length=None,
                    num_cpus_per_env_runner=None,
                    restart_failed_env_runners=None):
        for k, v in locals().items():
            if k != "self" and v is not None:
                setattr(self, k, v)
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def rl_module(self, *, spec=None, hiddens=None, activation=None):
        if spec is not None:
            self.rl_module_spec = spec
        if hiddens is not None:
            self.rl_module_spec.hiddens = tuple(hiddens)
        if activation is not None:
            self.rl_module_spec.activation = activation
        return self

    def learners(self, *, num_learners=None, num_cpus_per_learner=None,
                 num_gpus_per_learner=None, mesh=None):
        if num_learners is not None:
            self.num_learners = num_learners
        if num_cpus_per_learner is not None:
            self.num_cpus_per_learner = num_cpus_per_learner
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        if mesh is not None:
            self.mesh = mesh
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None):
        """Declare policy modules + the agent->policy mapping.
        ``policies`` is a dict {policy_id: RLModuleSpec | None} or an
        iterable of policy ids; the mapping fn must be picklable (it
        ships to env-runner actors)."""
        if policies is not None:
            if isinstance(policies, dict):
                self.policies = dict(policies)
            else:
                self.policies = {pid: None for pid in policies}
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def is_multi_agent(self) -> bool:
        return bool(self.policies) or self.policy_mapping_fn is not None

    def debugging(self, *, seed=None):
        if seed is not None:
            self.seed = seed
        return self

    # ---- finalization ----

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def make_env_creator(self) -> Callable:
        """The env factory: ``env_creator`` if given, else
        ``gymnasium.make(env, **env_config)`` (imported on first call;
        the port's own envs need no gymnasium)."""
        if self.env_creator is not None:
            return self.env_creator
        env_id, env_cfg = self.env, self.env_config

        def creator():
            import gymnasium as gym

            return gym.make(env_id, **env_cfg)

        return creator

    def build(self):
        if self.algo_class is None:
            raise ValueError("use a concrete config (e.g. PPOConfig)")
        return self.algo_class(config=self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if k not in ("env_creator", "mesh")}

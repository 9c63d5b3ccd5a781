"""RL training on the port (port of the JAX package's ``rllib``;
reference: rllib/, new API stack subset).

Core pieces: AlgorithmConfig builder, Algorithm (a Tune Trainable of the
port's ``tune``), EnvRunnerGroup (fault-tolerant sampling actors on the
CPU), TorchRLModule (policy/value nets as ``nn.Module`` s, params named
as the JAX keys), Learner/LearnerGroup (updates on the card by default;
several learners sync grads over a collective group), PPO, IMPALA,
APPO, DQN, SAC, BC, CQL and multi-agent PPO. ``envs`` holds spaces, a
vectorizer and CartPole-v1 on numpy, so the RL path needs no gymnasium.
"""

from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("rllib")
del _rlu


from .algorithm import Algorithm, EnvRunnerGroup
from .appo import APPO, APPOConfig
from .config import AlgorithmConfig
from .continuous import (ContinuousEnvRunner, ContinuousModuleSpec,
                         ContinuousRLModule)
from .dqn import DQN, DQNConfig
from .env_runner import SingleAgentEnvRunner, compute_gae
from .learner import Learner, LearnerGroup
from .impala import IMPALA, IMPALAConfig
from .multi_agent import (MultiAgentEnvRunner, MultiAgentLearnerGroup,
                          MultiRLModuleSpec, map_all_to)
from .multi_agent_env import MultiAgentEnv, SimpleSpread
from .multi_agent_episode import MultiAgentEpisode
from .offline import (BC, BCConfig, CQL, CQLConfig, OfflineData,
                      record_transitions)
from .ppo import PPO, PPOConfig
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer, SumTree
from .rl_module import RLModuleSpec, TorchRLModule
from .sac import SAC, SACConfig

__all__ = [
    "Algorithm", "AlgorithmConfig", "EnvRunnerGroup",
    "SingleAgentEnvRunner", "compute_gae", "Learner", "LearnerGroup",
    "PPO", "PPOConfig", "IMPALA", "IMPALAConfig", "DQN", "DQNConfig",
    "APPO", "APPOConfig", "SAC", "SACConfig",
    "BC", "BCConfig", "CQL", "CQLConfig", "OfflineData",
    "record_transitions",
    "ReplayBuffer", "PrioritizedReplayBuffer", "SumTree",
    "ContinuousRLModule", "ContinuousModuleSpec", "ContinuousEnvRunner",
    "TorchRLModule", "RLModuleSpec",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentEpisode",
    "MultiAgentLearnerGroup", "MultiRLModuleSpec", "SimpleSpread",
    "map_all_to",
]

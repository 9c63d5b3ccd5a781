"""DQN: off-policy Q-learning with replay, target network, double-Q.

Port of the JAX package's ``rllib/dqn.py`` (reference: the new-stack
DQN/Rainbow core, rllib/algorithms/dqn/dqn.py:593 training_step —
sample with epsilon-greedy -> replay buffer -> TD updates on the Learner
-> periodic target-net sync; loss per dqn_rainbow_torch_learner). The
target network lives on the learner's device beside the online params,
as its own storage: the minibatch carries it into the loss, and a sync
copies the online params into it in place.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .algorithm import Algorithm, summarize_episode_stats
from .config import AlgorithmConfig
from .learner import LearnerGroup
from .replay_buffers import ReplayBuffer


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DQN
        self.buffer_size: int = 50_000
        self.learning_starts: int = 1_000
        self.target_update_freq: int = 500     # updates between target syncs
        self.updates_per_iteration: int = 32
        self.batch_size: int = 64              # replay minibatch
        self.double_q: bool = True
        self.epsilon_start: float = 1.0
        self.epsilon_end: float = 0.05
        self.epsilon_decay_steps: int = 10_000
        self.grad_clip: float = 10.0
        self.num_epochs: int = 1               # unused; kept for API parity

    def epsilon_at(self, timestep: int) -> float:
        frac = min(1.0, timestep / max(1, self.epsilon_decay_steps))
        return self.epsilon_start + frac * (self.epsilon_end
                                            - self.epsilon_start)


def transitions_from_rollout(batch: Dict[str, np.ndarray]
                             ) -> Dict[str, np.ndarray]:
    """[T, N] rollout -> flat (s, a, r, s', done) transitions.

    next_obs[t] = obs[t+1] (last row bootstraps from the runner's live
    obs); rows invalidated by vector-env autoreset are dropped; the reset
    row after a terminal is never used as next state because done=1 masks
    its target.
    """
    obs, act = batch["obs"], batch["actions"]
    T, N = act.shape
    next_obs = np.concatenate([obs[1:], batch["last_obs"][None, :]], axis=0)
    m = batch["valid"].reshape(-1)
    return {
        "obs": obs.reshape(T * N, -1)[m],
        "actions": act.reshape(-1)[m],
        "rewards": batch["rewards"].reshape(-1).astype(np.float32)[m],
        "next_obs": next_obs.reshape(T * N, -1)[m],
        "dones": batch["dones"].reshape(-1).astype(np.float32)[m],
    }


def dqn_loss(config: DQNConfig):
    """(module, params, minibatch) -> (loss, stats). The minibatch carries
    ``target_params`` (a dict of tensors on the learner's device) so the
    TD target is computed in the same graph."""
    gamma = config.gamma
    double_q = config.double_q

    def loss_fn(module, params, mb):
        q_all, _ = module.forward_with(params, mb["obs"])
        q_sa = q_all.gather(1, mb["actions"][:, None])[:, 0]
        q_next_t, _ = module.forward_with(mb["target_params"], mb["next_obs"])
        if double_q:
            q_next_o, _ = module.forward_with(params, mb["next_obs"])
            a_star = torch.argmax(q_next_o, dim=-1)
        else:
            a_star = torch.argmax(q_next_t, dim=-1)
        q_next = q_next_t.gather(1, a_star[:, None])[:, 0]
        target = mb["rewards"] + gamma * (1.0 - mb["dones"]) * \
            q_next.detach()
        td = q_sa - target.detach()
        # Huber (reference dqn learner default)
        loss = torch.where(td.abs() < 1.0, 0.5 * td ** 2,
                           td.abs() - 0.5).mean()
        stats = {"qf_loss": loss, "qf_mean": q_all.mean(),
                 "td_error_abs": td.abs().mean()}
        return loss, stats

    return loss_fn


class DQN(Algorithm):
    config_class = DQNConfig

    def _build_learner_group(self) -> LearnerGroup:
        return LearnerGroup(self.algo_config, self.algo_config.rl_module_spec,
                            self.obs_space, self.act_space,
                            dqn_loss(self.algo_config))

    def setup(self, config) -> None:
        super().setup(config)
        cfg = self.algo_config
        self.buffer = ReplayBuffer(cfg.buffer_size)
        self._timesteps = 0
        self._num_updates = 0
        self._rng = np.random.default_rng(cfg.seed)
        self._target = self._online_params_copy()

    def _online_params_copy(self) -> Dict[str, torch.Tensor]:
        """The target network: a copy of the online params on the
        learner's device, in storage of its own."""
        learner = self.learner_group._local
        if learner is None:
            raise NotImplementedError(
                "DQN's TD updates run on the local learner; use "
                "num_learners=0")
        return {k: p.detach().clone() for k, p in learner.params.items()}

    def _sync_target(self) -> None:
        params = self.learner_group._local.params
        with torch.no_grad():
            for k, t in self._target.items():
                t.copy_(params[k])

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        eps = cfg.epsilon_at(self._timesteps)
        weights = self.learner_group.get_weights()

        batches, stats = [], []
        got, target_steps = 0, cfg.train_batch_size
        while got < target_steps:
            if self.env_runner_group.num_healthy == 0:
                if cfg.restart_failed_env_runners:
                    self.env_runner_group.restore_workers()
                else:
                    raise RuntimeError("all env runners are dead")
            bs, ss = self.env_runner_group.sample(weights, epsilon=eps)
            for b, s in zip(bs, ss):
                self.buffer.add(transitions_from_rollout(b))
                stats.append(s)
                got += s["env_steps"]
            if not bs:
                self.env_runner_group.restore_workers()
        self._timesteps += got

        learner_stats: Dict[str, float] = {}
        if self.buffer.size >= cfg.learning_starts:
            agg = []
            for _ in range(cfg.updates_per_iteration):
                mb = self.buffer.sample(cfg.batch_size, self._rng)
                mb["target_params"] = self._target
                agg.append(self.learner_group.update(
                    mb, num_epochs=1, minibatch_size=cfg.batch_size,
                    sequence_batch=True))
                self._num_updates += 1
                if self._num_updates % cfg.target_update_freq == 0:
                    self._sync_target()
            keys = agg[0].keys() if agg else ()
            learner_stats = {k: float(np.mean([a[k] for a in agg]))
                             for k in keys}
        if cfg.restart_failed_env_runners:
            self.env_runner_group.restore_workers()
        result = summarize_episode_stats(stats)
        result["learner"] = learner_stats
        result["epsilon"] = eps
        result["buffer_size"] = self.buffer.size
        result["num_updates"] = self._num_updates
        return result

"""PPO: clipped-surrogate policy optimization.

Port of the JAX package's ``rllib/ppo.py`` (reference: the new-stack
PPO, rllib/algorithms/ppo/ppo.py:427 training_step; loss per
ppo_torch_learner): sample via EnvRunnerGroup -> GAE -> minibatch SGD
epochs on the LearnerGroup (on the card) -> weight sync.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .algorithm import Algorithm, summarize_episode_stats
from .config import AlgorithmConfig
from .env_runner import compute_gae
from .learner import LearnerGroup


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = PPO
        self.lambda_: float = 0.95
        self.clip_param: float = 0.2
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        self.num_epochs: int = 10
        self.minibatch_size: int = 128
        self.grad_clip: float = 0.5
        self.kl_target: float = 0.02  # reported; no adaptive coeff (clip-only)


def ppo_loss(config: PPOConfig):
    """Returns (module, params, minibatch) -> (loss, stats).

    The advantages are normalised by their population std
    (``correction=0``), as ``jnp.std`` computes it; torch's default is
    the unbiased one."""
    clip, vf_clip = config.clip_param, config.vf_clip_param
    vf_coeff, ent_coeff = config.vf_loss_coeff, config.entropy_coeff

    def loss_fn(module, params, mb):
        logits, values = module.forward_with(params, mb["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(1, mb["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["advantages"]
        adv = (adv - adv.mean()) / torch.clamp(adv.std(correction=0),
                                               min=1e-6)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        policy_loss = -surrogate.mean()
        # clipped value loss (reference ppo learner)
        vf_err = (values - mb["value_targets"]) ** 2
        vf_clipped = mb["vf_preds"] + torch.clamp(
            values - mb["vf_preds"], -vf_clip, vf_clip)
        vf_err2 = (vf_clipped - mb["value_targets"]) ** 2
        vf_loss = torch.maximum(vf_err, vf_err2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
        stats = {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_kl": (mb["logp"] - logp).mean(),
            "clip_frac": ((ratio - 1.0).abs() > clip).float().mean(),
        }
        return total, stats

    return loss_fn


class PPO(Algorithm):
    config_class = PPOConfig
    _supports_multi_agent = True  # via config.multi_agent(...)

    def _build_learner_group(self) -> LearnerGroup:
        if self.ma_spec is not None:
            from .multi_agent import MultiAgentLearnerGroup

            return MultiAgentLearnerGroup(
                self.algo_config, self.ma_spec, self.module_spaces,
                ppo_loss(self.algo_config))
        return LearnerGroup(self.algo_config, self.algo_config.rl_module_spec,
                            self.obs_space, self.act_space,
                            ppo_loss(self.algo_config))

    def _multi_agent_training_step(self) -> Dict[str, Any]:
        """Sample per-policy trajectory chunks, GAE each, update each
        policy's learner on its own experience (reference:
        multi_agent_env_runner.py sample + LearnerGroup.update over a
        MultiRLModule)."""
        from .multi_agent import gae_trajectory

        cfg = self.algo_config
        weights = self.learner_group.get_weights()
        per_module: Dict[str, list] = {}
        stats = []
        got = 0
        while got < cfg.train_batch_size:
            if self.env_runner_group.num_healthy == 0:
                if cfg.restart_failed_env_runners:
                    self.env_runner_group.restore_workers()
                else:
                    raise RuntimeError("all env runners are dead")
            bs, ss = self.env_runner_group.sample(weights)
            for b, s in zip(bs, ss):
                for mid, trajs in b.items():
                    per_module.setdefault(mid, []).extend(trajs)
                stats.append(s)
                got += s["env_steps"]
            if not bs:
                self.env_runner_group.restore_workers()
        flat = {}
        for mid, trajs in per_module.items():
            parts = [gae_trajectory(t, cfg.gamma, cfg.lambda_)
                     for t in trajs]
            flat[mid] = {k: np.concatenate([p[k] for p in parts])
                         for k in parts[0]}
        learner_stats = self.learner_group.update(
            flat, num_epochs=cfg.num_epochs,
            minibatch_size=cfg.minibatch_size, seed=self._iteration)
        if cfg.restart_failed_env_runners:
            self.env_runner_group.restore_workers()
        result = summarize_episode_stats(stats)
        result["learner"] = learner_stats
        return result

    def training_step(self) -> Dict[str, Any]:
        if self.ma_spec is not None:
            return self._multi_agent_training_step()
        cfg = self.algo_config
        weights = self.learner_group.get_weights()
        batches, stats = [], []
        target = cfg.train_batch_size
        got = 0
        while got < target:
            if self.env_runner_group.num_healthy == 0:
                if cfg.restart_failed_env_runners:
                    self.env_runner_group.restore_workers()
                else:
                    raise RuntimeError("all env runners are dead")
            bs, ss = self.env_runner_group.sample(weights)
            for b, s in zip(bs, ss):
                batches.append(b)
                stats.append(s)
                got += s["env_steps"]
            if not bs:  # every healthy runner failed this round
                self.env_runner_group.restore_workers()
        flat_parts = [compute_gae(b, cfg.gamma, cfg.lambda_)
                      for b in batches]
        flat = {k: np.concatenate([p[k] for p in flat_parts])
                for k in flat_parts[0]}
        learner_stats = self.learner_group.update(
            flat, num_epochs=cfg.num_epochs,
            minibatch_size=cfg.minibatch_size, seed=self._iteration)
        if cfg.restart_failed_env_runners:
            self.env_runner_group.restore_workers()
        result = summarize_episode_stats(stats)
        result["learner"] = learner_stats
        return result

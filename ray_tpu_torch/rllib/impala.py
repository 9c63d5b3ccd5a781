"""IMPALA: async actor-learner RL with V-trace off-policy correction.

Port of the JAX package's ``rllib/impala.py`` (reference:
rllib/algorithms/impala/impala.py + vtrace implementation): env runners
sample continuously and the learner consumes batches as they arrive (no
synchronization barrier, unlike PPO); the policy lag between the
behavior policy that sampled and the target policy that learns is
corrected with V-trace (Espeholt et al. 2018, arXiv:1802.01561)
computed inside the loss by a reverse loop over time (the JAX loss's
reverse ``lax.scan``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch as rt

from .algorithm import Algorithm, summarize_episode_stats
from .config import AlgorithmConfig
from .learner import LearnerGroup


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = IMPALA
        self.lr = 5e-4
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.clip_rho_threshold: float = 1.0
        self.clip_pg_rho_threshold: float = 1.0
        self.grad_clip: float = 40.0
        self.num_epochs: int = 1  # IMPALA consumes each batch once
        # must stay 0: time-major sequence batches are consumed whole
        # (training_step raises on a non-zero value)
        self.minibatch_size: int = 0


def vtrace(values, boot, rewards, dones, target_logp, behavior_logp,
           *, gamma: float, rho_bar: float, pg_rho_bar: float):
    """V-trace targets + policy-gradient advantages (Espeholt et al.).

    [T, N] time-major inputs; returns (vs, pg_adv, rho), everything
    detached. IMPORTANT: rho feeds the V-trace TARGETS; without the
    detach the value loss backprops through rho into the policy with an
    inverted sign (it lowers vs by lowering the probability of
    positive-delta actions) and training diverges. Shared by the IMPALA
    and APPO losses — fix V-trace math HERE, once.
    """
    boot = boot.detach()
    rho = torch.exp(target_logp - behavior_logp).detach()
    clipped_rho = torch.clamp(rho, max=rho_bar)
    cs = torch.clamp(rho, max=1.0)
    discounts = gamma * (1.0 - dones)
    values_sg = values.detach()
    next_values = torch.cat([values_sg[1:], boot[None, :]], dim=0)
    deltas = clipped_rho * (rewards + discounts * next_values - values_sg)
    acc = torch.zeros_like(boot)
    vs_minus_v = [None] * deltas.shape[0]
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = (torch.stack(vs_minus_v) + values_sg).detach()
    vs_next = torch.cat([vs[1:], boot[None, :]], dim=0)
    pg_adv = (torch.clamp(rho, max=pg_rho_bar) * (
        rewards + discounts * vs_next - values_sg)).detach()
    return vs, pg_adv, rho


def sequence_logits(module, params, mb):
    """The module over a [T, N] batch and its bootstrap obs: ``(logp_all
    [T, N, A], target_logp [T, N], values [T, N], boot [N])`` under the
    CURRENT params."""
    actions = mb["actions"]
    T, N = actions.shape
    logits, values = module.forward_with(params, mb["obs"].reshape(T * N, -1))
    logp_all = torch.log_softmax(logits.reshape(T, N, -1), -1)
    target_logp = logp_all.gather(-1, actions[..., None])[..., 0]
    _, boot = module.forward_with(params, mb["last_obs"])
    return logp_all, target_logp, values.reshape(T, N), boot


def impala_loss(config: IMPALAConfig):
    """(module, params, batch) -> (loss, stats) with inline V-trace.

    Batch arrays are [T, N] time-major sequences plus a validity mask;
    the learner recomputes values under the CURRENT params and corrects
    the behavior-policy returns with clipped importance weights.
    """
    gamma = config.gamma
    rho_bar = config.clip_rho_threshold
    pg_rho_bar = config.clip_pg_rho_threshold
    vf_coeff = config.vf_loss_coeff
    ent_coeff = config.entropy_coeff

    def loss_fn(module, params, mb):
        dones = mb["dones"].float()
        valid = mb["valid"].float()
        logp_all, target_logp, values, boot = sequence_logits(
            module, params, mb)
        vs, pg_adv, rho = vtrace(
            values, boot, mb["rewards"], dones, target_logp, mb["logp"],
            gamma=gamma, rho_bar=rho_bar, pg_rho_bar=pg_rho_bar)

        w = valid / torch.clamp(valid.sum(), min=1.0)
        policy_loss = -(target_logp * pg_adv * w).sum()
        vf_loss = 0.5 * (((vs - values) ** 2) * w).sum()
        entropy = (-(torch.exp(logp_all) * logp_all).sum(-1) * w).sum()
        total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
        stats = {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_rho": (rho * w).sum(),
        }
        return total, stats

    return loss_fn


class IMPALA(Algorithm):
    config_class = IMPALAConfig

    def _build_learner_group(self) -> LearnerGroup:
        return LearnerGroup(self.algo_config, self.algo_config.rl_module_spec,
                            self.obs_space, self.act_space,
                            impala_loss(self.algo_config))

    def setup(self, config) -> None:
        super().setup(config)
        self._inflight: Dict[Any, int] = {}  # sample ref -> runner idx

    def _kick(self, idx: int, weights_ref) -> None:
        group = self.env_runner_group
        if group._local is not None:
            return
        ref = group._runners[idx].sample.remote(weights_ref)
        self._inflight[ref] = idx

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        group = self.env_runner_group
        weights = self.learner_group.get_weights()

        if group._local is not None:
            batches_stats = [group._local.sample(weights)]
        else:
            wref = rt.put(weights)
            for i in range(len(group._runners)):
                if group._healthy[i] and i not in self._inflight.values():
                    self._kick(i, wref)
            # async harvest: take whatever finished first; stragglers keep
            # sampling (the IMPALA architecture: no gang barrier)
            batches_stats = []
            deadline_refs = list(self._inflight)
            ready, _ = rt.wait(deadline_refs, num_returns=1,
                                    timeout=120)
            for ref in ready:
                idx = self._inflight.pop(ref)
                try:
                    b, s = rt.get(ref, timeout=60)
                    batches_stats.append((b, s))
                    self._kick(idx, wref)  # resample with fresh weights
                except Exception:  # noqa: BLE001 — runner died
                    group._healthy[idx] = False
            if not batches_stats:
                group.restore_workers()
                return {"num_env_steps_sampled": 0}

        all_stats: List[dict] = []
        learner_stats: Dict[str, float] = {}
        for batch, stats in batches_stats:
            all_stats.append(stats)
            seq = {
                "obs": batch["obs"].astype(np.float32),
                "actions": batch["actions"],
                "rewards": batch["rewards"],
                "dones": batch["dones"],
                "valid": batch["valid"],
                "logp": batch["logp"],
                "last_obs": batch["last_obs"],
            }
            if cfg.minibatch_size:
                raise ValueError(
                    "IMPALA/APPO consume whole time-major sequence "
                    "batches; minibatch_size must stay 0")
            learner_stats = self.learner_group.update(
                seq, num_epochs=cfg.num_epochs,
                minibatch_size=0, seed=self._iteration,
                sequence_batch=True)
        if cfg.restart_failed_env_runners:
            group.restore_workers()
        result = summarize_episode_stats(all_stats)
        result["learner"] = learner_stats
        return result

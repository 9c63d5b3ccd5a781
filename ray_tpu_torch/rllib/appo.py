"""APPO: asynchronous PPO — IMPALA's actor-learner loop, PPO's clipping.

Port of the JAX package's ``rllib/appo.py`` (reference:
rllib/algorithms/appo/appo.py — "IMPALA architecture + surrogate-loss
clipping + a target network"): env runners sample continuously with no
gang barrier; V-trace corrects policy lag to produce advantages; the
policy update uses the PPO clipped surrogate against those V-trace
advantages instead of IMPALA's raw pg term, giving the update-size
safety of PPO at IMPALA's throughput. Inherits the async harvest loop
from :class:`IMPALA`; only the loss differs.
"""

from __future__ import annotations

import torch

from .config import AlgorithmConfig
from .impala import IMPALA, sequence_logits, vtrace
from .learner import LearnerGroup


class APPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.lr = 5e-4
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.clip_param: float = 0.2          # PPO surrogate clip
        self.clip_rho_threshold: float = 1.0  # V-trace target clip
        self.grad_clip: float = 40.0
        self.num_epochs: int = 1
        self.minibatch_size: int = 0  # must stay 0 (whole sequence batch)


def appo_loss(config: APPOConfig):
    """(module, params, batch) -> (loss, stats): V-trace targets + PPO
    clipped surrogate on [T, N] time-major sequences."""
    gamma = config.gamma
    rho_bar = config.clip_rho_threshold
    clip = config.clip_param
    vf_coeff = config.vf_loss_coeff
    ent_coeff = config.entropy_coeff

    def loss_fn(module, params, mb):
        dones = mb["dones"].float()
        valid = mb["valid"].float()
        behavior_logp = mb["logp"]
        logp_all, target_logp, values, boot = sequence_logits(
            module, params, mb)

        ratio = torch.exp(target_logp - behavior_logp)
        vs, adv, rho = vtrace(
            values, boot, mb["rewards"], dones, target_logp, behavior_logp,
            gamma=gamma, rho_bar=rho_bar, pg_rho_bar=rho_bar)

        # PPO clipped surrogate on the V-trace advantages (the APPO
        # difference from IMPALA's plain -logp * adv)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        w = valid / torch.clamp(valid.sum(), min=1.0)
        policy_loss = -(surrogate * w).sum()
        vf_loss = 0.5 * (((vs - values) ** 2) * w).sum()
        entropy = (-(torch.exp(logp_all) * logp_all).sum(-1) * w).sum()
        total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "clip_frac": (((ratio - 1.0).abs() > clip).float() * w).sum(),
        }

    return loss_fn


class APPO(IMPALA):
    """Same training_step as IMPALA (async harvest); APPO loss."""

    config_class = APPOConfig

    def _build_learner_group(self) -> LearnerGroup:
        return LearnerGroup(self.algo_config, self.algo_config.rl_module_spec,
                            self.obs_space, self.act_space,
                            appo_loss(self.algo_config))

"""SAC: soft actor-critic with twin critics and auto-tuned entropy.

Port of the JAX package's ``rllib/sac.py`` (reference: the new-stack
SAC, rllib/algorithms/sac/sac.py:524 training_step; losses per
sac_torch_learner.py): squashed-Gaussian actor, twin Q networks with
polyak-averaged targets, temperature alpha tuned against a target
entropy. One update — critic step, actor step, alpha step, target
polyak — runs on the learner's device (the card by default); the
replay buffer (uniform or prioritized) feeds it numpy minibatches.

The update's two normal draws (the next action's and the policy's
reparameterised sample) come from the learner's ``torch.Generator`` on
its device, or are given to :meth:`SACLearner.update` as ``draws``
(the JAX update draws them from its key's splits).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .algorithm import Algorithm, EnvRunnerGroup, summarize_episode_stats
from .config import AlgorithmConfig
from .continuous import ContinuousEnvRunner, ContinuousModuleSpec
from .learner import ClippedAdam, grads_of, learner_device, to_tensors
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = SAC
        self.rl_module_spec = ContinuousModuleSpec()
        self.buffer_size: int = 100_000
        self.prioritized_replay: bool = False
        self.learning_starts: int = 1_500
        self.batch_size: int = 256
        self.updates_per_iteration: int = 64
        self.tau: float = 0.005              # polyak rate
        self.actor_lr: float = 3e-4
        self.critic_lr: float = 3e-4
        self.alpha_lr: float = 3e-4
        self.initial_alpha: float = 1.0
        self.target_entropy: float | None = None  # None => -act_dim
        self.grad_clip: float = 40.0
        self.num_epochs: int = 1             # unused; API parity


class SACLearner:
    """Owns the SAC state on its device; one update per minibatch.

    Not the generic Learner: SAC needs three optimizers, target params in
    the state, and a generator carried across updates.
    """

    def __init__(self, module, config: SACConfig):
        self.config = config
        self.device = learner_device(config)
        module.init_params(torch.Generator().manual_seed(config.seed))
        self.module = module.to(self.device)
        self.target_entropy = (config.target_entropy
                               if config.target_entropy is not None
                               else -float(module.act_dim))
        self.actor = dict(module.actor)
        self.critic = {"q1": dict(module.q1), "q2": dict(module.q2)}
        # the target critic: copies in storage of their own
        self.target_critic = {
            part: {k: p.detach().clone() for k, p in params.items()}
            for part, params in self.critic.items()}
        self.log_alpha = torch.tensor(
            float(np.log(config.initial_alpha)), dtype=torch.float32,
            device=self.device, requires_grad=True)
        self._opt_actor = ClippedAdam(self.actor, config.actor_lr,
                                      config.grad_clip)
        self._opt_critic = ClippedAdam(self._critic_flat(),
                                       config.critic_lr, config.grad_clip)
        self._opt_alpha = ClippedAdam({"log_alpha": self.log_alpha},
                                      config.alpha_lr)
        self.gen = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.steps = 0

    def _critic_flat(self) -> Dict[str, torch.Tensor]:
        return {f"{part}.{k}": p for part, params in self.critic.items()
                for k, p in params.items()}

    def q_both(self, critic, obs, act):
        return (self.module.forward_q(critic["q1"], obs, act),
                self.module.forward_q(critic["q2"], obs, act))

    def draw(self, batch: int) -> Dict[str, torch.Tensor]:
        """The update's normal draws, from the learner's generator."""
        shape = (batch, self.module.act_dim)
        return {k: torch.randn(shape, generator=self.gen, device=self.device)
                for k in ("next", "pi")}

    def _critic_target(self, mb, alpha, noise):
        """y = r + gamma (1 - d) (min Q'(s', a') - alpha logp(a'|s'))."""
        with torch.no_grad():
            a_next, logp_next = self.module.forward_actor(
                self.actor, mb["next_obs"], noise)
            q1_t, q2_t = self.q_both(self.target_critic, mb["next_obs"],
                                     a_next)
            return mb["rewards"] + self.config.gamma * (1.0 - mb["dones"]) * (
                torch.minimum(q1_t, q2_t) - alpha * logp_next)

    def critic_loss(self, mb, draws, alpha):
        """``(loss, q1, y)``: the twin critics' TD loss against the target
        critic's backup, weighted by the minibatch's importance
        ``weights`` where it has them."""
        y = self._critic_target(mb, alpha, draws["next"])
        q1, q2 = self.q_both(self.critic, mb["obs"], mb["actions"])
        td = 0.5 * ((q1 - y) ** 2 + (q2 - y) ** 2)
        iw = mb.get("weights")
        return (td.mean() if iw is None else (iw * td).mean()), q1, y

    def _bc_phase(self) -> bool:
        return False

    def actor_loss(self, mb, noise, alpha):
        """``(loss, logp)``: alpha logp - min Q at the policy's sample
        (the critics as they stand), or, in a BC phase, the squared error
        of the squashed mean against the data's actions."""
        a, logp = self.module.forward_actor(self.actor, mb["obs"], noise)
        if self._bc_phase():
            mean, _ = self.module.actor_dist(self.actor, mb["obs"])
            return ((torch.tanh(mean) - mb["actions"]) ** 2).mean(), logp
        q1, q2 = self.q_both(self.critic, mb["obs"], a)
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def critic_params(self):
        return list(self._critic_flat().values())

    def update(self, mb: Mapping[str, Any],
               draws: Optional[Mapping[str, Any]] = None):
        """One minibatch update — critic step, actor step (critic frozen
        at its new values), alpha step, target polyak; returns (stats,
        |td| per row). ``draws``: the update's standard normals (``draw``'s
        keys), else drawn here."""
        mb = to_tensors(mb, self.device)
        draws = to_tensors(draws, self.device) if draws is not None \
            else self.draw(mb["rewards"].shape[0])
        alpha = torch.exp(self.log_alpha.detach())
        c_loss, q1, y = self.critic_loss(mb, draws, alpha)
        critic = self.critic_params()
        self._opt_critic.step(critic, grads_of(c_loss, critic))

        a_loss, logp = self.actor_loss(mb, draws["pi"], alpha)
        actor = list(self.actor.values())
        self._opt_actor.step(actor, grads_of(a_loss, actor))

        logp = logp.detach()
        al_loss = (-self.log_alpha * (logp + self.target_entropy)).mean()
        (al_grad,) = torch.autograd.grad(al_loss, [self.log_alpha])
        self._opt_alpha.step([self.log_alpha], [al_grad])

        with torch.no_grad():
            for part, params in self.critic.items():
                for k, p in params.items():
                    self.target_critic[part][k].lerp_(p, self.config.tau)
        self.steps += 1
        return self._stats(c_loss, a_loss.detach(), al_loss.detach(), alpha,
                           q1, logp, (q1 - y).abs())

    @staticmethod
    def _stats(c_loss, a_loss, al_loss, alpha, q1, logp_pi, td_abs):
        vals = torch.stack([c_loss.detach(), a_loss, al_loss, alpha,
                            q1.detach().mean(), -logp_pi.mean()]).tolist()
        names = ("critic_loss", "actor_loss", "alpha_loss", "alpha",
                 "q1_mean", "entropy")
        return dict(zip(names, vals)), td_abs.detach().cpu().numpy()

    def get_weights(self) -> Dict[str, np.ndarray]:
        # the actor part — exactly what the runner's forward_actor takes
        return {k: p.detach().cpu().numpy().copy()
                for k, p in self.actor.items()}

    def get_state(self) -> bytes:
        def np_tree(tree):
            return {k: np_tree(v) if isinstance(v, dict)
                    else v.detach().cpu().numpy().copy()
                    for k, v in tree.items()}

        return pickle.dumps({
            "actor": np_tree(self.actor), "critic": np_tree(self.critic),
            "target_critic": np_tree(self.target_critic),
            "log_alpha": float(self.log_alpha.detach()),
            "opt_actor": self._opt_actor.state_dict(),
            "opt_critic": self._opt_critic.state_dict(),
            "opt_alpha": self._opt_alpha.state_dict(),
            "gen": (self.device.type, self.gen.get_state().numpy()),
            "steps": self.steps})

    def set_state(self, blob: bytes) -> None:
        state = pickle.loads(blob)
        with torch.no_grad():
            for mine, saved in ((self.actor, state["actor"]),
                                *((self.critic[p], state["critic"][p])
                                  for p in self.critic),
                                *((self.target_critic[p],
                                   state["target_critic"][p])
                                  for p in self.target_critic)):
                for k, t in mine.items():
                    t.copy_(torch.as_tensor(saved[k]))
            self.log_alpha.fill_(state["log_alpha"])
        self._opt_actor.load_state_dict(state["opt_actor"])
        self._opt_critic.load_state_dict(state["opt_critic"])
        self._opt_alpha.load_state_dict(state["opt_alpha"])
        device_type, gen_state = state["gen"]
        if device_type == self.device.type:
            # a CUDA generator's state does not load into a CPU one: a
            # state restored on the other device keeps its own draws
            self.gen.set_state(torch.from_numpy(gen_state))
        self.steps = state["steps"]


class SAC(Algorithm):
    config_class = SACConfig

    def _build_learner_group(self):
        module = self.algo_config.rl_module_spec.build(self.obs_space,
                                                       self.act_space)
        return SACLearner(module, self.algo_config)

    def setup(self, config) -> None:
        super().setup(config)
        cfg = self.algo_config
        buf_cls = (PrioritizedReplayBuffer if cfg.prioritized_replay
                   else ReplayBuffer)
        self.buffer = buf_cls(cfg.buffer_size)
        self._timesteps = 0
        self._num_updates = 0
        self._rng = np.random.default_rng(cfg.seed)

    def _make_env_runner_group(self, config, env_creator):
        return EnvRunnerGroup(config, env_creator, config.rl_module_spec,
                              runner_cls=ContinuousEnvRunner)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        warmup = self.buffer.size < cfg.learning_starts
        weights = None if warmup else self.learner_group.get_weights()

        stats = []
        got, target_steps = 0, cfg.train_batch_size
        while got < target_steps:
            if self.env_runner_group.num_healthy == 0:
                if cfg.restart_failed_env_runners:
                    self.env_runner_group.restore_workers()
                else:
                    raise RuntimeError("all env runners are dead")
            bs, ss = self.env_runner_group.sample(weights, random=warmup)
            for b, s in zip(bs, ss):
                self.buffer.add(b)
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
                indices = mb.pop("indices", None)
                s, td_abs = self.learner_group.update(mb)
                if indices is not None:
                    self.buffer.update_priorities(indices, td_abs)
                agg.append(s)
                self._num_updates += 1
            keys = agg[0].keys() if agg else ()
            learner_stats = {k: float(np.mean([a[k] for a in agg]))
                             for k in keys}
        if cfg.restart_failed_env_runners:
            self.env_runner_group.restore_workers()
        result = summarize_episode_stats(stats)
        result["learner"] = learner_stats
        result["buffer_size"] = self.buffer.size
        result["num_updates"] = self._num_updates
        return result

"""Offline RL: dataset recording, offline data pipeline, BC and CQL.

Port of the JAX package's ``rllib/offline.py`` (reference:
rllib/offline/offline_data.py:18 OfflineData — reads episodes from
ray.data datasets into the learner loop; rllib/algorithms/bc/bc.py;
rllib/algorithms/cql/cql.py + the conservative penalty in
cql_torch_learner.py). The offline learner loop is dataset-driven (the
port's ``data`` parquet shards -> numpy minibatches) feeding one update
on the learner's device, CQL's logsumexp over sampled actions included.

Components:
- ``record_transitions``: roll a behavior policy, write transition shards
  as parquet via the port's ``data`` (the recording side of the pipeline).
- ``OfflineData``: wraps a ``data.Dataset`` of transitions;
  materializes column arrays once and serves uniform minibatches.
- ``BC``: behavior cloning (discrete cross-entropy / continuous MSE-to-
  squashed-mean) on the standard modules.
- ``CQL``: SAC's update + the CQL(H) conservative penalty —
  ``alpha_prime * (logsumexp_a Q(s,a) - Q(s, a_data))`` over uniform +
  policy-sampled actions (reference: cql.py:21 default config,
  cql_torch_learner.py compute_loss_for_module).

Spaces are read by duck typing: a space with ``n`` is discrete, one with
``low``/``high`` a box (the port's ``envs`` spaces or gymnasium's).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .algorithm import Algorithm
from .config import AlgorithmConfig
from .continuous import ContinuousModuleSpec
from .learner import ClippedAdam, grads_of, learner_device, to_tensors
from .rl_module import RLModuleSpec
from .sac import SACLearner


def is_discrete(space) -> bool:
    return hasattr(space, "n")


# --------------------------------------------------------------------------
# recording
# --------------------------------------------------------------------------


def record_transitions(env_creator: Callable, policy_fn: Callable,
                       num_steps: int, path: str, *, seed: int = 0,
                       shard_rows: int = 4096) -> Dict[str, float]:
    """Roll ``policy_fn(obs) -> action`` for ``num_steps`` env steps and
    write (obs, action, reward, next_obs, done) rows as parquet shards
    under ``path`` (readable with the port's ``data.read_parquet`` — the
    recording half of the reference's offline pipeline). Returns rollout
    stats (episodes, mean return) so callers can sanity-check the
    behavior policy's quality."""
    import ray_tpu_torch.data as rd

    env = env_creator()
    os.makedirs(path, exist_ok=True)
    rows: List[dict] = []
    shard = 0
    obs, _ = env.reset(seed=seed)
    ep_ret, rets = 0.0, []

    def flush():
        nonlocal rows, shard
        if rows:
            rd.from_items(rows).write_parquet(
                os.path.join(path, f"shard-{shard:05d}"))
            shard += 1
            rows = []

    for _ in range(num_steps):
        a = policy_fn(np.asarray(obs, np.float32))
        next_obs, r, term, trunc, _ = env.step(a)
        rows.append({
            "obs": np.asarray(obs, np.float32).tolist(),
            "action": (a.tolist() if isinstance(a, np.ndarray) else a),
            "reward": float(r),
            "next_obs": np.asarray(next_obs, np.float32).tolist(),
            # termination only — time-limit truncation still bootstraps
            "done": float(term),
        })
        ep_ret += float(r)
        if term or trunc:
            rets.append(ep_ret)
            ep_ret = 0.0
            obs, _ = env.reset()
        else:
            obs = next_obs
        if len(rows) >= shard_rows:
            flush()
    flush()
    env.close()
    return {"episodes": len(rets),
            "mean_return": float(np.mean(rets)) if rets else 0.0}


class OfflineData:
    """Transition dataset -> uniform numpy minibatches for the learner.

    Reference: rllib/offline/offline_data.py:18 (ray.data-backed sampling
    into the learner). Columns are materialized once (one pass over the
    dataset's blocks) — offline RL re-samples the same data thousands of
    times, so paying one gather beats re-decoding parquet per epoch.
    """

    def __init__(self, dataset):
        cols = dataset.to_numpy()
        self.obs = np.stack([np.asarray(o, np.float32)
                             for o in cols["obs"]])
        acts = cols["action"]
        if isinstance(acts[0], (list, np.ndarray)):
            self.actions = np.stack([np.asarray(a, np.float32)
                                     for a in acts])
        else:
            self.actions = np.asarray(acts, np.int32)
        self.rewards = np.asarray(cols["reward"], np.float32)
        self.next_obs = np.stack([np.asarray(o, np.float32)
                                  for o in cols["next_obs"]])
        self.dones = np.asarray(cols["done"], np.float32)
        self.size = len(self.rewards)

    @classmethod
    def from_path(cls, path: str) -> "OfflineData":
        import ray_tpu_torch.data as rd

        return cls(rd.read_parquet(path))

    def sample(self, batch_size: int, rng: np.random.Generator
               ) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "dones": self.dones[idx],
        }


# --------------------------------------------------------------------------
# offline algorithm base
# --------------------------------------------------------------------------


class OfflineAlgorithmConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.input_path: Optional[str] = None
        self.input_dataset = None  # a data.Dataset, alternatively
        self.batch_size: int = 256
        self.updates_per_iteration: int = 200
        self.num_env_runners = 0  # offline: no sampling workers

    def offline_data(self, *, input_path=None, dataset=None,
                     batch_size=None, updates_per_iteration=None):
        """Builder section (reference: AlgorithmConfig.offline_data)."""
        if input_path is not None:
            self.input_path = input_path
        if dataset is not None:
            self.input_dataset = dataset
        if batch_size is not None:
            self.batch_size = batch_size
        if updates_per_iteration is not None:
            self.updates_per_iteration = updates_per_iteration
        return self


class OfflineAlgorithm(Algorithm):
    """Dataset-driven training: no env runners; the env is only probed
    for spaces and used by ``evaluate()``."""

    def setup(self, config) -> None:
        if isinstance(config, dict):
            base = self.config_class()
            for k, v in config.items():
                setattr(base, k, v)
            config = base
        self.algo_config = config
        self._iteration = 0
        self._timesteps_total = 0
        env_creator = config.make_env_creator()
        self._env_creator = env_creator
        probe_env = env_creator()
        self.obs_space = probe_env.observation_space
        self.act_space = probe_env.action_space
        probe_env.close()
        if config.input_dataset is not None:
            self.offline_data = OfflineData(config.input_dataset)
        elif config.input_path:
            self.offline_data = OfflineData.from_path(config.input_path)
        else:
            raise ValueError("offline algorithm needs input_path or "
                             "input_dataset")
        self._rng = np.random.default_rng(config.seed)
        self.learner_group = self._build_learner_group()

    class _NoRunners:
        num_healthy = 0

        def stop(self):
            pass

    @property
    def env_runner_group(self):
        return self._NoRunners()

    @env_runner_group.setter
    def env_runner_group(self, v):  # base class compat
        pass

    def _normalize_box_actions(self) -> None:
        """Map recorded env-scale Box actions into the module's squashed
        [-1, 1] space (the runner applies the inverse at the env boundary;
        offline data records env-scale, so mirror it here)."""
        if is_discrete(self.act_space):
            return
        low = np.asarray(self.act_space.low, np.float32)
        high = np.asarray(self.act_space.high, np.float32)
        a = self.offline_data.actions
        self.offline_data.actions = np.clip(
            2.0 * (a - low) / (high - low) - 1.0, -1.0, 1.0)

    def evaluate(self, num_episodes: int = 5, seed: int = 1000) -> float:
        """Greedy rollout of the learned policy; mean episode return."""
        env = self._env_creator()
        act_fn = self.learner_group.greedy_action
        rets = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=seed + ep)
            total, done = 0.0, False
            steps = 0
            while not done and steps < 1000:
                a = act_fn(np.asarray(obs, np.float32))
                obs, r, term, trunc, _ = env.step(a)
                total += float(r)
                done = term or trunc
                steps += 1
            rets.append(total)
        env.close()
        return float(np.mean(rets))


# --------------------------------------------------------------------------
# BC
# --------------------------------------------------------------------------


class BCConfig(OfflineAlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = BC
        self.lr = 1e-3
        self.grad_clip: float = 10.0


class BCLearner:
    """Supervised policy imitation, one update a minibatch on the
    learner's device.

    Discrete: cross-entropy over the module's logits. Continuous: MSE of
    the squashed actor mean against the recorded [-1,1] actions
    (reference: bc_torch_learner — -logp of the action dist)."""

    def __init__(self, module, config, discrete: bool,
                 act_bounds=None):
        self.device = learner_device(config)
        self.discrete = discrete
        self.act_bounds = act_bounds
        module.init_params(torch.Generator().manual_seed(config.seed))
        self.module = module.to(self.device)
        self.params = (module.params() if discrete
                       else dict(module.actor))
        self._opt = ClippedAdam(self.params, config.lr, config.grad_clip)

    def loss(self, mb) -> torch.Tensor:
        if self.discrete:
            logits, _ = self.module.forward_with(self.params, mb["obs"])
            logp = torch.log_softmax(logits, -1)
            onehot = torch.nn.functional.one_hot(
                mb["actions"].long(), logits.shape[-1]).to(logp.dtype)
            return -(onehot * logp).sum(-1).mean()
        mean, _ = self.module.actor_dist(self.params, mb["obs"])
        return ((torch.tanh(mean) - mb["actions"]) ** 2).mean()

    def update(self, mb) -> float:
        loss = self.loss(to_tensors(mb, self.device))
        grads = grads_of(loss, list(self.params.values()))
        self._opt.step(list(self.params.values()), grads)
        return float(loss)

    def greedy_action(self, obs: np.ndarray):
        with torch.no_grad():
            o = torch.as_tensor(obs, device=self.device)[None]
            if self.discrete:
                logits, _ = self.module.forward_with(self.params, o)
                return int(torch.argmax(logits, -1)[0])
            mean, _ = self.module.actor_dist(self.params, o)
            a = torch.tanh(mean)[0].cpu().numpy()
        low, high = self.act_bounds
        return low + (a + 1.0) * 0.5 * (high - low)

    def get_weights(self) -> Dict[str, np.ndarray]:
        return {k: p.detach().cpu().numpy().copy()
                for k, p in self.params.items()}

    def get_state(self) -> bytes:
        import pickle

        return pickle.dumps({"params": self.get_weights(),
                             "opt_state": self._opt.state_dict()})

    def set_state(self, blob) -> None:
        import pickle

        state = pickle.loads(blob)
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(torch.as_tensor(state["params"][k]))
        self._opt.load_state_dict(state["opt_state"])


class BC(OfflineAlgorithm):
    config_class = BCConfig

    def setup(self, config) -> None:
        super().setup(config)
        self._normalize_box_actions()

    def _build_learner_group(self):
        if is_discrete(self.act_space):
            spec = self.algo_config.rl_module_spec
            if not isinstance(spec, RLModuleSpec):
                spec = RLModuleSpec()
            module = spec.build(self.obs_space, self.act_space)
            return BCLearner(module, self.algo_config, True)
        spec = ContinuousModuleSpec()
        module = spec.build(self.obs_space, self.act_space)
        bounds = (np.asarray(self.act_space.low, np.float32),
                  np.asarray(self.act_space.high, np.float32))
        return BCLearner(module, self.algo_config, False, bounds)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        losses = []
        for _ in range(cfg.updates_per_iteration):
            mb = self.offline_data.sample(cfg.batch_size, self._rng)
            losses.append(self.learner_group.update(mb))
        return {"bc_loss": float(np.mean(losses)),
                "dataset_size": self.offline_data.size}


# --------------------------------------------------------------------------
# CQL
# --------------------------------------------------------------------------


class CQLConfig(OfflineAlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        # SAC backbone knobs (tuned on the Pendulum offline gate: a fast
        # actor lr + small fixed-ish entropy temperature keep the policy
        # near the data manifold after warmup)
        self.tau: float = 0.005
        self.actor_lr: float = 1e-3
        self.critic_lr: float = 3e-4
        self.alpha_lr: float = 3e-4
        self.initial_alpha: float = 0.2
        self.target_entropy: Optional[float] = None
        self.grad_clip: float = 40.0
        # conservative penalty (reference: cql.py min_q_weight; moderate
        # weight — large weights carve Q valleys at the policy's own
        # samples and chase it off the data)
        self.cql_alpha: float = 2.0
        self.num_cql_actions: int = 4
        # BC warmup steps before switching to the SAC actor loss
        # (reference: cql.py bc_iters)
        self.bc_iters: int = 1500
        self.rl_module_spec = ContinuousModuleSpec()


class CQLLearner(SACLearner):
    """SAC learner + CQL(H) conservative critic penalty.

    The penalty lower-bounds the learned Q off-dataset:
      L_cons = a' * E_s[ logsumexp_{a ~ unif + pi} Q(s,a) - Q(s, a_D) ]
    computed inside the same update (reference: cql_torch_learner.py
    compute_loss_for_module). Its draws: SAC's two normals, plus
    ``unif`` [n, B, A] uniform on [-1, 1) and ``cur`` / ``nxt``
    [n, B, A] normals for the policy's samples at s and s', n being
    ``num_cql_actions``.
    """

    def draw(self, batch: int) -> Dict[str, torch.Tensor]:
        n, A = self.config.num_cql_actions, self.module.act_dim
        out = super().draw(batch)
        out["unif"] = torch.rand((n, batch, A), generator=self.gen,
                                 device=self.device) * 2.0 - 1.0
        for k in ("cur", "nxt"):
            out[k] = torch.randn((n, batch, A), generator=self.gen,
                                 device=self.device)
        return out

    def _policy_samples(self, obs, noise):
        """The actor's n samples at each row of ``obs``: ([n, B, A],
        [n, B]), no gradient (the penalty's actions are constants)."""
        with torch.no_grad():
            return self.module.forward_actor(
                self.actor, obs[None].expand(noise.shape[0], -1, -1), noise)

    def critic_loss(self, mb, draws, alpha):
        """SAC's TD loss (unweighted) plus ``cql_alpha`` times the
        conservative penalty over uniform, pi(s) and pi(s') actions."""
        cfg = self.config
        n, act_dim = cfg.num_cql_actions, mb["actions"].shape[-1]
        y = self._critic_target(mb, alpha, draws["next"])
        # conservative action samples: uniform + pi(s) + pi(s')
        a_cur, logp_cur = self._policy_samples(mb["obs"], draws["cur"])
        a_nxt, logp_nxt = self._policy_samples(mb["next_obs"], draws["nxt"])
        # importance weights (CQL(H)): uniform density = (1/2)^d,
        # pi samples use their own logp
        log_unif = act_dim * math.log(0.5)
        obs_n = mb["obs"][None].expand(n, -1, -1)
        q1, q2 = self.q_both(self.critic, mb["obs"], mb["actions"])
        td = 0.5 * ((q1 - y) ** 2 + (q2 - y) ** 2)
        cons = 0.0
        for qk, qd in (("q1", q1), ("q2", q2)):
            qp = self.critic[qk]
            cat_q = torch.cat([
                self.module.forward_q(qp, obs_n, draws["unif"]) - log_unif,
                self.module.forward_q(qp, obs_n, a_cur) - logp_cur,
                self.module.forward_q(qp, obs_n, a_nxt) - logp_nxt,
            ], dim=0)
            cons = cons + (torch.logsumexp(cat_q, dim=0) - qd).mean()
        return td.mean() + cfg.cql_alpha * cons, q1, y

    def _bc_phase(self) -> bool:
        # BC warmup -> SAC objective (reference: cql.py bc_iters). Warmup
        # imitates via MSE on the squashed mean: an NLL objective explodes
        # on saturated (bang-bang) dataset actions (arctanh of |a|->1),
        # and an entropy bonus fights the imitation gradient.
        return self.steps < self.config.bc_iters

    def greedy_action(self, obs: np.ndarray):
        with torch.no_grad():
            o = torch.as_tensor(obs, device=self.device)[None]
            mean, _ = self.module.actor_dist(self.actor, o)
            a = torch.tanh(mean)[0].cpu().numpy()
        low, high = self.act_bounds
        return low + (a + 1.0) * 0.5 * (high - low)


class CQL(OfflineAlgorithm):
    config_class = CQLConfig

    def setup(self, config) -> None:
        super().setup(config)
        self._normalize_box_actions()

    def _build_learner_group(self):
        spec = self.algo_config.rl_module_spec
        if not isinstance(spec, ContinuousModuleSpec):
            spec = ContinuousModuleSpec()
        module = spec.build(self.obs_space, self.act_space)
        learner = CQLLearner(module, self.algo_config)
        learner.act_bounds = (
            np.asarray(self.act_space.low, np.float32),
            np.asarray(self.act_space.high, np.float32))
        return learner

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        agg: List[Dict[str, float]] = []
        for _ in range(cfg.updates_per_iteration):
            mb = self.offline_data.sample(cfg.batch_size, self._rng)
            stats, _ = self.learner_group.update(mb)
            agg.append(stats)
        keys = agg[0].keys() if agg else ()
        out = {k: float(np.mean([a[k] for a in agg])) for k in keys}
        out["dataset_size"] = self.offline_data.size
        return out


# --------------------------------------------------------------------------
# scripted behavior policies (dataset generators for tests/examples)
# --------------------------------------------------------------------------


def cartpole_expert_policy(obs: np.ndarray) -> int:
    """Scripted CartPole balancer (~500 return): push toward the pole's
    lean + angular velocity."""
    return 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0


def pendulum_expert_policy(obs: np.ndarray) -> np.ndarray:
    """Energy-shaping swing-up + PD catch for Pendulum-v1 (~-220 mean
    return; tuned empirically — solves from most starts in one swing)."""
    c, s, thdot = float(obs[0]), float(obs[1]), float(obs[2])
    th = np.arctan2(s, c)
    energy = 0.5 * thdot ** 2 + 10.0 * c  # 10 at the upright target
    if c > 0.9 and abs(thdot) < 3.0:
        u = -10.0 * th - 2.0 * thdot
    else:
        d = 10.0 - energy
        u = 2.0 * np.sign(thdot * d) if abs(thdot) > 0.1 else 2.0
    return np.clip(np.asarray([u], np.float32), -2.0, 2.0)

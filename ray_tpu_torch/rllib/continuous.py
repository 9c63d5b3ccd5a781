"""Continuous-action (Box space) RL components: module + env runner.

Port of the JAX package's ``rllib/continuous.py``. The discrete stack
(rl_module.py / env_runner.py) covers categorical policies; SAC-family
algorithms need a squashed-Gaussian actor, twin Q(s,a) critics, and
float action rollouts (reference: rllib/algorithms/sac/sac_torch_model.py
+ SingleAgentEnvRunner with Box spaces). The module's params are three
``nn.ParameterDict`` s, ``actor``, ``q1`` and ``q2`` (the JAX init's
subtrees, keys ``w0``, ``b0``, ..., ``w_out``, ``b_out``); its methods
take the dict of one part, as the JAX functions take a subtree, so a
learner can pass a target critic's or a step's copies.

Draws are inputs: ``forward_actor`` takes the standard-normal noise
of its reparameterised sample (the JAX function draws it from a key), so
the runner draws from its ``torch.Generator`` and a learner's update can
take draws given to it.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .env_runner import fit_threads_to_reservation, runner_probe
from .envs import SyncVectorEnv
from .rl_module import ACTIVATIONS, load_numpy

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def _mlp_params(dims, out_dim) -> nn.ParameterDict:
    params = nn.ParameterDict()
    d = dims[0]
    for i, h in enumerate(dims[1:]):
        params[f"w{i}"] = nn.Parameter(torch.zeros(d, h))
        params[f"b{i}"] = nn.Parameter(torch.zeros(h))
        d = h
    params["w_out"] = nn.Parameter(torch.zeros(d, out_dim))
    params["b_out"] = nn.Parameter(torch.zeros(out_dim))
    return params


def _mlp_init(params: nn.ParameterDict, gen: torch.Generator,
              out_scale: float = 1.0) -> None:
    """The JAX ``_mlp_init`` distributions: hidden weights ``normal *
    sqrt(2 / fan_in)``, the head ``normal * out_scale``, zero biases."""
    with torch.no_grad():
        for name, p in params.items():
            if name.startswith("b"):
                p.zero_()
            else:
                scale = out_scale if name == "w_out" else math.sqrt(
                    2.0 / p.shape[0])
                p.copy_(torch.randn(p.shape, generator=gen) * scale)


def _mlp_apply(params: Mapping[str, torch.Tensor], x, act, n_hidden):
    for i in range(n_hidden):
        x = act(x @ params[f"w{i}"] + params[f"b{i}"])
    return x @ params["w_out"] + params["b_out"]


class ContinuousRLModule(nn.Module):
    """Squashed-Gaussian actor + twin Q critics over a Box action space.

    forward_actor(actor_params, obs, noise) -> (action in [-1,1], logp)
    actor_dist(actor_params, obs)           -> (mean, log_std)
    forward_q(q_params, obs, act)           -> q values [B]
    Each takes the dict of its part (``dict(module.actor)``, ...).
    Action scaling to env bounds happens in the runner/algorithm.
    """

    def __init__(self, obs_dim: int, act_dim: int,
                 hiddens: Sequence[int] = (256, 256),
                 activation: str = "relu"):
        super().__init__()
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hiddens = tuple(hiddens)
        self.activation = activation
        self.act = ACTIVATIONS[activation]
        dims = (obs_dim,) + self.hiddens
        q_dims = (obs_dim + act_dim,) + self.hiddens
        self.actor = _mlp_params(dims, 2 * act_dim)
        self.q1 = _mlp_params(q_dims, 1)
        self.q2 = _mlp_params(q_dims, 1)

    def init_params(self, gen: torch.Generator) -> "ContinuousRLModule":
        _mlp_init(self.actor, gen, out_scale=0.01)
        _mlp_init(self.q1, gen)
        _mlp_init(self.q2, gen)
        return self

    def actor_dist(self, actor_params, obs):
        out = _mlp_apply(actor_params, obs.to(torch.float32), self.act,
                         len(self.hiddens))
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def forward_actor(self, actor_params, obs, noise):
        """Reparameterized tanh-squashed sample + its log-prob; ``noise``
        is standard normal of the mean's shape."""
        mean, log_std = self.actor_dist(actor_params, obs)
        std = torch.exp(log_std)
        u = mean + std * noise
        a = torch.tanh(u)
        # N(u; mean, std) log-density + tanh change-of-variables
        logp_u = (-0.5 * ((u - mean) / std) ** 2 - log_std
                  - 0.5 * math.log(2.0 * math.pi)).sum(-1)
        logp = logp_u - torch.log1p(-a ** 2 + 1e-6).sum(-1)
        return a, logp

    def forward_q(self, q_params, obs, act):
        x = torch.cat([obs.to(torch.float32), act.to(torch.float32)],
                      dim=-1)
        return _mlp_apply(q_params, x, self.act, len(self.hiddens))[..., 0]


@dataclass
class ContinuousModuleSpec:
    """Builds a continuous module from env spaces (Box action)."""

    module_class: type = ContinuousRLModule
    hiddens: Sequence[int] = (256, 256)
    activation: str = "relu"
    module_kwargs: Dict[str, Any] = field(default_factory=dict)

    def build(self, obs_space, act_space, device="cpu"
              ) -> ContinuousRLModule:
        obs_dim = int(np.prod(obs_space.shape))
        act_dim = int(np.prod(act_space.shape))
        module = self.module_class(obs_dim, act_dim, hiddens=self.hiddens,
                                   activation=self.activation,
                                   **self.module_kwargs)
        return module.to(device)


class ContinuousEnvRunner:
    """Vectorized Box-action rollouts producing flat transitions.

    Mirrors SingleAgentEnvRunner's fault-tolerance surface (sample /
    set_weights / ping) but returns (s, a, r, s', done) transitions
    directly — the natural unit for off-policy replay. ``random=True``
    samples uniform actions (SAC warmup before learning_starts).
    """

    def __init__(self, env_creator: Callable, module_spec, num_envs: int,
                 rollout_len: int, seed: int = 0, worker_idx: int = 0):
        fit_threads_to_reservation()
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.env = SyncVectorEnv([env_creator for _ in range(num_envs)])
        space = self.env.single_action_space
        self.act_low = np.asarray(space.low, np.float32)
        self.act_high = np.asarray(space.high, np.float32)
        self.module = module_spec.build(self.env.single_observation_space,
                                        space, device="cpu")
        self._rng = np.random.default_rng(seed * 10007 + worker_idx)
        self._gen = torch.Generator().manual_seed(
            int(self._rng.integers(0, 2**31)))
        self._params = None
        obs, _ = self.env.reset(seed=seed * 10007 + worker_idx)
        self._obs = np.asarray(obs, np.float32)
        self._prev_done = np.zeros(num_envs, bool)
        self._ep_returns = np.zeros(num_envs, np.float64)
        self._ep_lens = np.zeros(num_envs, np.int64)
        self._completed_returns: list = []
        self._completed_lens: list = []

    def set_weights(self, weights) -> None:
        """The actor's weights (``get_weights`` of the SAC learner: the
        actor part, keys without the ``actor.`` prefix)."""
        if weights is not None:
            load_numpy(self.module.actor, weights)
        self._params = weights

    def ping(self) -> str:
        return "ok"

    def probe(self) -> Dict[str, object]:
        return {**runner_probe(),
                "module_device": str(next(self.module.parameters()).device)}

    def _scale(self, a: np.ndarray) -> np.ndarray:
        """[-1, 1] -> env bounds."""
        return self.act_low + (a + 1.0) * 0.5 * (self.act_high - self.act_low)

    def _forward(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            actor = dict(self.module.actor)
            obs_t = torch.from_numpy(obs)
            noise = torch.randn((obs.shape[0], self.module.act_dim),
                                generator=self._gen)
            a, _ = self.module.forward_actor(actor, obs_t, noise)
        return a.numpy()

    def sample(self, weights: Optional[Dict] = None,
               random: bool = False) -> Tuple[Dict, Dict]:
        """One rollout of [rollout_len * num_envs] flat transitions.

        Autoreset rows (gymnasium NEXT_STEP mode) are dropped; actions in
        the batch are the squashed [-1,1] actions (what the learner needs),
        env stepping uses the scaled version.
        """
        if weights is not None:
            self.set_weights(weights)
        T, N = self.rollout_len, self.num_envs
        obs_l, act_l, rew_l, nobs_l, done_l, valid_l = [], [], [], [], [], []
        t0 = time.perf_counter()
        for _ in range(T):
            if random or self._params is None:
                a = self._rng.uniform(-1.0, 1.0,
                                      (N,) + self.act_low.shape).astype(
                    np.float32)
            else:
                a = self._forward(self._obs)
            next_obs, reward, term, trunc, _ = self.env.step(self._scale(a))
            next_obs = np.asarray(next_obs, np.float32)
            done = term | trunc
            valid = ~self._prev_done
            obs_l.append(self._obs.copy())
            act_l.append(a)
            rew_l.append(np.asarray(reward, np.float32))
            nobs_l.append(next_obs.copy())
            # bootstrap masking uses TERMINATION only (time-limit
            # truncation still bootstraps — standard SAC practice)
            done_l.append(term.astype(np.float32))
            valid_l.append(valid)

            self._ep_returns[valid] += reward[valid]
            self._ep_lens[valid] += 1
            for i in np.nonzero(done & valid)[0]:
                self._completed_returns.append(float(self._ep_returns[i]))
                self._completed_lens.append(int(self._ep_lens[i]))
                self._ep_returns[i] = 0.0
                self._ep_lens[i] = 0
            self._prev_done = done
            self._obs = next_obs

        m = np.concatenate(valid_l)
        batch = {
            "obs": np.concatenate(obs_l)[m],
            "actions": np.concatenate(act_l)[m],
            "rewards": np.concatenate(rew_l)[m],
            "next_obs": np.concatenate(nobs_l)[m],
            "dones": np.concatenate(done_l)[m],
        }
        stats = {
            "episode_returns": self._completed_returns,
            "episode_lens": self._completed_lens,
            "env_steps": int(m.sum()),
            "sample_time_s": time.perf_counter() - t0,
        }
        self._completed_returns = []
        self._completed_lens = []
        return batch, stats

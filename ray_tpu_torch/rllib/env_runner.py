"""SingleAgentEnvRunner: vectorized env stepping + policy inference.

Port of the JAX package's ``rllib/env_runner.py`` (reference:
rllib/env/single_agent_env_runner.py:61, sample :131): owns a
synchronous vector env (``envs.SyncVectorEnv``, gymnasium 1.x's
NEXT_STEP autoreset, no gymnasium needed), holds the current module
weights, and produces fixed-length rollout batches. It runs as a CPU
actor: its module is built on ``device="cpu"`` and it never touches
CUDA; inference is a CPU forward under ``torch.no_grad``.

NEXT_STEP autoreset: the step after a terminal is a reset transition
whose action is ignored — those rows are marked invalid in the batch
(``valid`` mask) and filtered before training.

Draws come from the runner's own ``torch.Generator`` (the JAX runner
splits a PRNG key): categorical sampling by the Gumbel-max rule, as
``jax.random.categorical`` draws; with ``epsilon`` the epsilon-greedy
path draws a random action and a uniform per env whatever epsilon is,
so at ``epsilon=0.0`` the actions are the greedy ones.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .envs import SyncVectorEnv
from .rl_module import load_numpy


def gumbel_argmax(logits: torch.Tensor, gen: torch.Generator
                  ) -> torch.Tensor:
    """A categorical draw per row: ``argmax(logits + Gumbel noise)``."""
    tiny = torch.finfo(logits.dtype).tiny
    u = torch.rand(logits.shape, generator=gen).clamp_(min=tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def fit_threads_to_reservation() -> None:
    """In an actor (a runner, a remote learner), torch's intra-op
    threads to the actor's CPU reservation (at least one). Torch starts
    a thread a core in every process; two runners that each spin a
    thread a core over the same cores sample many times slower than one
    alone. In the driver's process (``num_env_runners=0``, a local
    learner) the driver's setting stays."""
    from ray_tpu_torch.core.runtime_context import get_runtime_context

    try:
        ctx = get_runtime_context()
        if ctx.get_actor_id() is None:
            return
        cpus = ctx.get_assigned_resources().get("CPU", 1.0)
    except RuntimeError:  # no runtime: a runner built outside one
        return
    torch.set_num_threads(max(1, int(cpus)))


def runner_probe() -> Dict[str, object]:
    """What a runner's process has loaded: its pid, whether it created a
    CUDA context, whether JAX or the JAX package is in ``sys.modules``,
    and torch's intra-op threads."""
    import os

    return {"pid": os.getpid(), "torch_threads": torch.get_num_threads(),
            "cuda_initialized": bool(torch.cuda.is_initialized()),
            "jax_loaded": any(m == "jax" or m.startswith("jax.")
                              or m == "ray_tpu" or m.startswith("ray_tpu.")
                              for m in sys.modules)}


class SingleAgentEnvRunner:
    def __init__(self, env_creator: Callable, module_spec, num_envs: int,
                 rollout_len: int, seed: int = 0, worker_idx: int = 0):
        fit_threads_to_reservation()
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.env = SyncVectorEnv([env_creator for _ in range(num_envs)])
        self.module = module_spec.build(self.env.single_observation_space,
                                        self.env.single_action_space,
                                        device="cpu")
        self._rng = np.random.default_rng(seed * 10007 + worker_idx)
        self._gen = torch.Generator().manual_seed(
            int(self._rng.integers(0, 2**31)))
        self._params = None
        obs, _ = self.env.reset(seed=seed * 10007 + worker_idx)
        self._obs = np.asarray(obs, np.float32)
        self._prev_done = np.zeros(num_envs, bool)
        self._ep_returns = np.zeros(num_envs, np.float64)
        self._ep_lens = np.zeros(num_envs, np.int64)
        # drained on each sample() so an episode is reported exactly once
        self._completed_returns: list = []
        self._completed_lens: list = []

    # ---- weights ----

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        load_numpy(self.module, weights)
        self._params = weights

    def get_weights(self):
        return self._params

    def ping(self) -> str:
        return "ok"

    def probe(self) -> Dict[str, object]:
        return {**runner_probe(),
                "module_device": str(next(self.module.parameters()).device)}

    def _forward(self, obs: np.ndarray, epsilon: Optional[float] = None):
        """Policy inference: categorical sampling (on-policy algorithms)
        or, with ``epsilon``, epsilon-greedy over the logits/Q-values
        (value-based algorithms — reference: EpsilonGreedy exploration)."""
        with torch.no_grad():
            logits, value = self.module(torch.from_numpy(obs))
            if epsilon is None:
                action = gumbel_argmax(logits, self._gen)
                logp = torch.log_softmax(logits, -1).gather(
                    1, action[:, None])[:, 0]
            else:
                greedy = torch.argmax(logits, dim=-1)
                rand = torch.randint(0, logits.shape[-1], greedy.shape,
                                     generator=self._gen)
                explore = torch.rand(greedy.shape, generator=self._gen) \
                    < epsilon
                action = torch.where(explore, rand, greedy)
                logp = torch.zeros_like(value)
        return (action.numpy(), logp.numpy().astype(np.float32),
                value.numpy().astype(np.float32))

    # ---- sampling ----

    def sample(self, weights: Optional[Dict] = None,
               epsilon: Optional[float] = None) -> Tuple[Dict, Dict]:
        """One rollout of [rollout_len, num_envs] steps.

        Returns (batch, stats). Batch arrays are [T, N]; ``valid`` masks
        out autoreset rows; ``vf_last`` is V(s_T) per env for GAE
        bootstrap. ``epsilon`` switches inference to epsilon-greedy.
        """
        if weights is not None:
            self.set_weights(weights)
        if self._params is None:
            raise RuntimeError("no weights set")
        T, N = self.rollout_len, self.num_envs
        obs_buf = np.empty((T, N) + self._obs.shape[1:], np.float32)
        act_buf = np.empty((T, N), np.int64)
        rew_buf = np.empty((T, N), np.float32)
        term_buf = np.empty((T, N), bool)
        done_buf = np.empty((T, N), bool)
        logp_buf = np.empty((T, N), np.float32)
        vf_buf = np.empty((T, N), np.float32)
        valid_buf = np.empty((T, N), bool)

        t0 = time.perf_counter()
        for t in range(T):
            action, logp, value = self._forward(self._obs, epsilon)
            next_obs, reward, term, trunc, _ = self.env.step(action)
            obs_buf[t] = self._obs
            act_buf[t] = action
            rew_buf[t] = reward
            term_buf[t] = term
            done_buf[t] = term | trunc
            logp_buf[t] = logp
            vf_buf[t] = value
            valid_buf[t] = ~self._prev_done  # autoreset rows are invalid

            live = valid_buf[t]
            self._ep_returns[live] += reward[live]
            self._ep_lens[live] += 1
            for i in np.nonzero(done_buf[t] & live)[0]:
                self._completed_returns.append(float(self._ep_returns[i]))
                self._completed_lens.append(int(self._ep_lens[i]))
                self._ep_returns[i] = 0.0
                self._ep_lens[i] = 0
            self._prev_done = done_buf[t]
            self._obs = np.asarray(next_obs, np.float32)

        _, _, vf_last = self._forward(self._obs)
        batch = {
            "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
            "terminateds": term_buf, "dones": done_buf, "logp": logp_buf,
            "vf_preds": vf_buf, "valid": valid_buf, "vf_last": vf_last,
            "last_obs": self._obs.copy(),
        }
        stats = {
            "episode_returns": self._completed_returns,
            "episode_lens": self._completed_lens,
            "env_steps": int(valid_buf.sum()),
            "sample_time_s": time.perf_counter() - t0,
        }
        self._completed_returns = []
        self._completed_lens = []
        return batch, stats


def compute_gae(batch: Dict[str, np.ndarray], gamma: float, lam: float):
    """Generalized advantage estimation over [T, N] arrays.

    Truncated episodes are treated as terminated (no final-obs bootstrap) —
    a small bias near time limits, standard in compact PPO implementations.
    Returns flat, valid-row-filtered training arrays.
    """
    rew, vf = batch["rewards"], batch["vf_preds"]
    term, done, valid = batch["terminateds"], batch["dones"], batch["valid"]
    T, N = rew.shape
    next_vf = np.vstack([vf[1:], batch["vf_last"][None, :]])
    adv = np.zeros((T, N), np.float32)
    last = np.zeros(N, np.float32)
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - done[t].astype(np.float32)
        delta = rew[t] + gamma * next_vf[t] * nonterminal - vf[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
    ret = adv + vf
    m = valid.reshape(-1)
    flat = {
        "obs": batch["obs"].reshape(T * N, -1)[m],
        "actions": batch["actions"].reshape(-1)[m],
        "logp": batch["logp"].reshape(-1)[m],
        "advantages": adv.reshape(-1)[m],
        "value_targets": ret.reshape(-1)[m],
        "vf_preds": vf.reshape(-1)[m],
    }
    return flat

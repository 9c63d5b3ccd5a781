"""The port's other RL algorithms held to the JAX package's on the CPU:
V-trace and the IMPALA and APPO losses, the DQN loss, the SAC and CQL
updates with injected draws, the replay buffers and ``SumTree``, the
multi-agent runner and learner group; and the cases of
``tests/test_dqn.py``, ``tests/test_sac.py``,
``tests/test_offline_rl.py``, ``tests/test_multi_agent_rl.py``,
``tests/test_appo_budget.py`` and ``tests/test_rl_learning_gates.py`` on
the port (learning gates the JAX package marks ``slow`` are ``slow``
here too).

Draws are never compared: the SAC and CQL updates take the normal and
uniform draws that the JAX update's key splits give; the multi-agent
runners of both packages take the same numpy draws through a
monkeypatch. Learners run on the CPU (``num_gpus_per_learner=0``).
Nothing at this module's top imports JAX or the JAX package.
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import (APPOConfig, BC, BCConfig, CQL, CQLConfig,
                                 DQN, DQNConfig, IMPALAConfig,
                                 MultiAgentEnvRunner, MultiAgentEpisode,
                                 MultiRLModuleSpec, PPOConfig,
                                 PrioritizedReplayBuffer, ReplayBuffer,
                                 RLModuleSpec, SAC, SACConfig, SimpleSpread,
                                 SumTree, TorchRLModule, map_all_to,
                                 record_transitions)
from ray_tpu_torch.rllib import appo as port_appo
from ray_tpu_torch.rllib import dqn as port_dqn
from ray_tpu_torch.rllib import impala as port_impala
from ray_tpu_torch.rllib.continuous import ContinuousRLModule
from ray_tpu_torch.rllib.dqn import transitions_from_rollout
from ray_tpu_torch.rllib.envs import CartPoleEnv
from ray_tpu_torch.rllib.learner import ClippedAdam, grads_of
from ray_tpu_torch.rllib.offline import (CQLLearner, OfflineData,
                                         cartpole_expert_policy,
                                         pendulum_expert_policy)
from ray_tpu_torch.rllib.rl_module import from_jax_params
from ray_tpu_torch.rllib.sac import SACLearner

LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-5
FORWARD_RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test's torch ops on one thread, the setting restored after.
    The models here are tiny: a thread a core in each of several test
    processes sharing the cores made the CartPole gates many times
    slower (as two runner actors were, before they capped theirs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def assert_leaves_close(got, want, rel=LEAF_RTOL, what="leaf"):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, f"{what} {k}: |diff| {err} > {rel}*{scale}"


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_module(obs_dim=4, num_actions=2, seed=0):
    import jax

    from ray_tpu.rllib.rl_module import JaxRLModule

    module = JaxRLModule(obs_dim, num_actions)
    return module, {k: np.asarray(v) for k, v in
                    module.init(jax.random.PRNGKey(seed)).items()}


def _port_module(params, obs_dim=4, num_actions=2):
    module = TorchRLModule(obs_dim, num_actions)
    module.load_state_dict(from_jax_params(params))
    return module


def _grads_both(jax_loss, port_loss, jmod, params, mb):
    import jax

    (jl, js), jg = jax.value_and_grad(
        lambda p: jax_loss(jmod, p, mb), has_aux=True)(params)
    module = _port_module(params, jmod.obs_dim, jmod.num_actions)
    p = module.params()
    pl, ps = port_loss(module, p, {k: torch.as_tensor(v)
                                   for k, v in mb.items()})
    pg = torch.autograd.grad(pl, list(p.values()))
    return ((float(jl), {k: float(v) for k, v in js.items()},
             {k: np.asarray(v) for k, v in jg.items()}),
            (float(pl.detach()), {k: float(v) for k, v in ps.items()},
             {k: g.numpy() for k, g in zip(p, pg)}))


def _check(want, got):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert_leaves_close(got[2], want[2], what="grad")


def _sequence_batch(seed, T=16, N=4):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, N)).astype(np.int64),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": rng.random((T, N)) < 0.1,
        "valid": rng.random((T, N)) > 0.1,
        "logp": np.log(rng.uniform(0.2, 0.8, (T, N))).astype(np.float32),
        "last_obs": rng.normal(size=(N, 4)).astype(np.float32),
    }


# --------------------------------------------------------------------------- #
# V-trace, IMPALA, APPO, DQN losses
# --------------------------------------------------------------------------- #


def test_vtrace_matches_jax():
    import jax.numpy as jnp

    from ray_tpu.rllib.impala import vtrace as jax_vtrace

    rng = np.random.default_rng(3)
    T, N = 20, 5
    args = [rng.normal(size=(T, N)).astype(np.float32),
            rng.normal(size=(N,)).astype(np.float32),
            rng.normal(size=(T, N)).astype(np.float32),
            (rng.random((T, N)) < 0.1).astype(np.float32),
            np.log(rng.uniform(0.1, 0.9, (T, N))).astype(np.float32),
            np.log(rng.uniform(0.1, 0.9, (T, N))).astype(np.float32)]
    kw = dict(gamma=0.99, rho_bar=1.0, pg_rho_bar=0.8)
    want = jax_vtrace(*[jnp.asarray(a) for a in args], **kw)
    got = port_impala.vtrace(*[torch.from_numpy(a) for a in args], **kw)
    for g, w, name in zip(got, want, ("vs", "pg_adv", "rho")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=LOSS_RTOL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_sequence_losses_match_jax(algo):
    from ray_tpu.rllib import appo as jax_appo
    from ray_tpu.rllib import impala as jax_impala

    if algo == "impala":
        jloss = jax_impala.impala_loss(jax_impala.IMPALAConfig())
        ploss = port_impala.impala_loss(IMPALAConfig())
    else:
        jloss = jax_appo.appo_loss(jax_appo.APPOConfig())
        ploss = port_appo.appo_loss(APPOConfig())
    jmod, params = _jax_module(seed=1)
    want, got = _grads_both(jloss, ploss, jmod, params, _sequence_batch(7))
    _check(want, got)


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_loss_matches_jax(double_q):
    from ray_tpu.rllib import dqn as jax_dqn

    jmod, params = _jax_module(seed=0)
    _, target = _jax_module(seed=5)
    rng = np.random.default_rng(2)
    B = 32
    mb = {"obs": rng.normal(size=(B, 4)).astype(np.float32),
          "actions": rng.integers(0, 2, B).astype(np.int64),
          "rewards": rng.normal(size=B).astype(np.float32),
          "next_obs": rng.normal(size=(B, 4)).astype(np.float32),
          "dones": (rng.random(B) < 0.2).astype(np.float32)}
    jcfg = jax_dqn.DQNConfig().training(double_q=double_q)
    pcfg = DQNConfig().training(double_q=double_q)
    import jax

    (jl, js), jg = jax.value_and_grad(
        lambda p: jax_dqn.dqn_loss(jcfg)(jmod, p, {**mb,
                                                   "target_params": target}),
        has_aux=True)(params)
    module = _port_module(params)
    p = module.params()
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    tmb["target_params"] = {k: torch.as_tensor(v) for k, v in target.items()}
    pl, ps = port_dqn.dqn_loss(pcfg)(module, p, tmb)
    pg = grads_of(pl, list(p.values()))  # the value tower's are zeros
    _check((float(jl), {k: float(v) for k, v in js.items()},
            {k: np.asarray(v) for k, v in jg.items()}),
           (float(pl.detach()), {k: float(v) for k, v in ps.items()},
            {k: g.numpy() for k, g in zip(p, pg)}))


def test_impala_vtrace_gradient_direction():
    """Regression (the JAX suite's): V-trace targets must be detached —
    without it the value loss backprops through rho and pushes GOOD
    actions' logp down (the bandit below would converge to the
    zero-reward arm)."""
    cfg = IMPALAConfig()
    module = TorchRLModule(4, 2).init_params(torch.Generator().manual_seed(0))
    params = module.params()
    loss_fn = port_impala.impala_loss(cfg)
    opt = ClippedAdam(params, 1e-2)
    T, N = 32, 4
    rng = np.random.RandomState(0)
    obs = torch.ones((T, N, 4))
    p0 = 0.5
    for _ in range(150):
        with torch.no_grad():
            logits, _ = module(torch.ones((1, 4)))
            p0 = float(torch.softmax(logits, -1)[0, 0])
        actions = (rng.rand(T, N) > p0).astype(np.int64)
        logp = np.where(actions == 0, np.log(p0 + 1e-9),
                        np.log(1 - p0 + 1e-9)).astype(np.float32)
        mb = {"obs": obs, "actions": torch.from_numpy(actions),
              "rewards": torch.from_numpy((actions == 0).astype(np.float32)),
              "dones": torch.zeros((T, N), dtype=torch.bool),
              "valid": torch.ones((T, N), dtype=torch.bool),
              "logp": torch.from_numpy(logp),
              "last_obs": torch.ones((N, 4))}
        loss, _ = loss_fn(module, params, mb)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.step(list(params.values()), grads)
    assert p0 > 0.9, f"policy failed to prefer the paying arm: P(a0)={p0}"


# --------------------------------------------------------------------------- #
# SAC and CQL updates with injected draws
# --------------------------------------------------------------------------- #


def _pendulum_batch(rng, B=16, obs_dim=3, act_dim=1, weights=False):
    mb = {"obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
          "actions": rng.uniform(-1, 1, (B, act_dim)).astype(np.float32),
          "rewards": rng.normal(size=B).astype(np.float32),
          "next_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
          "dones": (rng.random(B) < 0.2).astype(np.float32)}
    if weights:
        mb["weights"] = rng.uniform(0.2, 1.0, B).astype(np.float32)
    return mb


def _carry_sac_state(jl, pl):
    """The JAX learner's actor, critics, target critics and log alpha
    into the port learner (fresh optimizer state on both)."""
    state = pickle.loads(pl.get_state())
    js = jl.state
    state["actor"] = {k: np.asarray(v) for k, v in js["actor"].items()}
    for part in ("critic", "target_critic"):
        state[part] = {q: {k: np.asarray(v) for k, v in js[part][q].items()}
                       for q in ("q1", "q2")}
    state["log_alpha"] = float(js["log_alpha"])
    pl.set_state(pickle.dumps(state))


def _sac_draws(key, B, act_dim, n_cql=0):
    """The draws of one JAX SAC (``n_cql`` 0) or CQL update from the
    state's key: (next key, draws)."""
    import jax

    if not n_cql:
        key, k_next, k_pi = jax.random.split(key, 3)
        return key, {"next": np.asarray(jax.random.normal(k_next,
                                                          (B, act_dim))),
                     "pi": np.asarray(jax.random.normal(k_pi, (B, act_dim)))}
    key, k_next, k_pi, k_unif, k_cur, k_nxt = jax.random.split(key, 6)
    return key, {
        "next": np.asarray(jax.random.normal(k_next, (B, act_dim))),
        "pi": np.asarray(jax.random.normal(k_pi, (B, act_dim))),
        "unif": np.asarray(jax.random.uniform(
            k_unif, (n_cql, B, act_dim), minval=-1.0, maxval=1.0)),
        "cur": np.stack([np.asarray(jax.random.normal(k, (B, act_dim)))
                         for k in jax.random.split(k_cur, n_cql)]),
        "nxt": np.stack([np.asarray(jax.random.normal(k, (B, act_dim)))
                         for k in jax.random.split(k_nxt, n_cql)])}


def _port_sac_params(pl):
    return {**{f"actor.{k}": v for k, v in flat(
        {k: p.detach().numpy() for k, p in pl.actor.items()}).items()},
            **flat({"critic": {q: {k: p.detach().numpy()
                                   for k, p in pl.critic[q].items()}
                               for q in pl.critic},
                    "target_critic": {q: {k: t.numpy() for k, t in
                                          pl.target_critic[q].items()}
                                      for q in pl.target_critic}}),
            "log_alpha": pl.log_alpha.detach().numpy()}


def _jax_sac_params(jl):
    js = jl.state
    return {**{f"actor.{k}": np.asarray(v) for k, v in js["actor"].items()},
            **flat({"critic": js["critic"],
                    "target_critic": js["target_critic"]}),
            "log_alpha": np.asarray(js["log_alpha"])}


@pytest.mark.parametrize("algo,weights", [("sac", False), ("sac", True),
                                          ("cql", False)])
def test_sac_and_cql_updates_match_jax_with_injected_draws(algo, weights):
    """Three updates from the same state and minibatches, the port's
    taking the draws of the JAX update's key splits: stats rtol 1e-5,
    |td| and every param (actor, twin critics, their polyak targets, log
    alpha) within 1e-5 of the leaf's largest |value|. CQL runs its BC
    warm-up on the first update and the SAC actor loss after."""
    from ray_tpu.rllib import offline as jax_offline
    from ray_tpu.rllib import sac as jax_sac
    from ray_tpu.rllib.continuous import ContinuousRLModule as JModule

    hid = dict(hiddens=(32, 32))
    if algo == "sac":
        jcfg = jax_sac.SACConfig().training(tau=0.05, grad_clip=1.0)
        pcfg = SACConfig().training(tau=0.05, grad_clip=1.0).learners(
            num_gpus_per_learner=0)
        jl = jax_sac.SACLearner(JModule(3, 1, **hid), jcfg)
        pl = SACLearner(ContinuousRLModule(3, 1, **hid), pcfg)
        n_cql = 0
    else:
        jcfg = jax_offline.CQLConfig()
        jcfg.bc_iters, jcfg.tau = 1, 0.05
        pcfg = CQLConfig().learners(num_gpus_per_learner=0)
        pcfg.bc_iters, pcfg.tau = 1, 0.05
        jl = jax_offline.CQLLearner(JModule(3, 1, **hid), jcfg)
        pl = CQLLearner(ContinuousRLModule(3, 1, **hid), pcfg)
        n_cql = jcfg.num_cql_actions
    _carry_sac_state(jl, pl)
    rng = np.random.default_rng(4)
    key = jl.state["key"]
    for _ in range(3):
        mb = _pendulum_batch(rng, weights=weights)
        key, draws = _sac_draws(key, 16, 1, n_cql)
        want, want_td = jl.update(mb)
        got, got_td = pl.update(mb, draws=draws)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(
            got_td, want_td, rtol=0,
            atol=LEAF_RTOL * float(np.abs(want_td).max()))
    assert_leaves_close(_port_sac_params(pl), _jax_sac_params(jl),
                        what="param")
    # the target critic is its own storage, not a view of the online one
    for q in ("q1", "q2"):
        for k, p in pl.critic[q].items():
            assert p.data_ptr() != pl.target_critic[q][k].data_ptr()
            assert not torch.equal(p.detach(), pl.target_critic[q][k])


def test_sac_learner_draws_from_its_generator():
    cfg = SACConfig().learners(num_gpus_per_learner=0)
    a = SACLearner(ContinuousRLModule(3, 1, (16,)), cfg)
    b = SACLearner(ContinuousRLModule(3, 1, (16,)), cfg)
    mb = _pendulum_batch(np.random.default_rng(0))
    sa, _ = a.update(mb)
    sb, _ = b.update(mb)
    assert sa == sb
    blob = a.get_state()
    c = SACLearner(ContinuousRLModule(3, 1, (16,)), cfg.copy().debugging(
        seed=7))
    c.set_state(blob)
    assert c.update(mb)[0] == a.update(mb)[0]


# --------------------------------------------------------------------------- #
# replay buffers
# --------------------------------------------------------------------------- #


def test_replay_buffers_and_sumtree_bitwise():
    from ray_tpu.rllib import replay_buffers as jrb

    def fill(buf, rng):
        buf.add({"obs": rng.normal(size=(70, 3)).astype(np.float32),
                 "actions": rng.integers(0, 4, 70)})

    for port_cls, jax_cls in ((ReplayBuffer, jrb.ReplayBuffer),
                              (PrioritizedReplayBuffer,
                               jrb.PrioritizedReplayBuffer)):
        port, ref = port_cls(50), jax_cls(50)
        for seed in range(3):
            fill(port, np.random.default_rng(seed))
            fill(ref, np.random.default_rng(seed))
        rp, rj = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(4):
            got, want = port.sample(16, rp), ref.sample(16, rj)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            if "indices" in want:
                td = np.random.default_rng(len(want["indices"])).normal(
                    size=16)
                port.update_priorities(got["indices"], td)
                ref.update_priorities(want["indices"], td)
    tp, tj = SumTree(20), jrb.SumTree(20)
    pri = np.random.default_rng(1).uniform(0, 5, 20)
    tp.set(np.arange(20), pri)
    tj.set(np.arange(20), pri)
    assert tp.total == tj.total
    prefix = np.random.default_rng(2).random(500) * tp.total
    np.testing.assert_array_equal(tp.find_prefix(prefix),
                                  tj.find_prefix(prefix))


class TestReplayBuffer:
    def test_ring_wraparound(self):
        buf = ReplayBuffer(10)
        buf.add({"actions": np.arange(7), "obs": np.arange(7.0)[:, None]})
        assert buf.size == 7
        buf.add({"actions": np.arange(7, 14),
                 "obs": np.arange(7.0, 14.0)[:, None]})
        assert buf.size == 10
        assert set(buf._data["actions"].tolist()) == set(range(4, 14))

    def test_sumtree_proportional(self):
        t = SumTree(16)
        t.set(np.arange(16), np.ones(16))
        t.set(np.array([5]), np.array([9.0]))
        assert abs(t.total - 24.0) < 1e-9
        found = t.find_prefix(np.random.default_rng(0).random(8000)
                              * t.total)
        assert 0.25 < (found == 5).mean() < 0.5

    def test_per_reprioritization(self):
        rng = np.random.default_rng(0)
        p = PrioritizedReplayBuffer(128)
        p.add({"obs": np.arange(64, dtype=np.float32).reshape(64, 1),
               "actions": np.arange(64)})
        s = p.sample(8, rng)
        assert s["weights"].max() <= 1.0 + 1e-6
        boosted = s["indices"]
        p.update_priorities(boosted, np.full(len(boosted), 50.0))
        s2 = p.sample(1000, rng)
        assert np.isin(s2["indices"], boosted).mean() > 0.5


# --------------------------------------------------------------------------- #
# DQN, SAC, IMPALA, APPO end to end
# --------------------------------------------------------------------------- #


def _dqn_config(**training):
    base = dict(train_batch_size=256, lr=5e-4)
    base.update(training)
    return (DQNConfig()
            .environment(env_creator=CartPoleEnv)
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=32)
            .training(**base)
            .learners(num_gpus_per_learner=0)
            .debugging(seed=0))


def test_transitions_next_obs_alignment():
    T, N = 3, 2
    obs = np.arange(T * N, dtype=np.float32).reshape(T, N, 1)
    batch = {"obs": obs, "actions": np.zeros((T, N), np.int64),
             "rewards": np.ones((T, N), np.float32),
             "dones": np.zeros((T, N), bool), "valid": np.ones((T, N), bool),
             "last_obs": np.full((N, 1), 99.0, np.float32)}
    tr = transitions_from_rollout(batch)
    assert tr["next_obs"][0, 0] == obs[1, 0, 0]
    assert tr["next_obs"][1, 0] == obs[1, 1, 0]
    assert tr["next_obs"][-1, 0] == 99.0


def test_dqn_smoke_target_sync_and_checkpoint(tmp_path):
    cfg = _dqn_config(buffer_size=5000, learning_starts=200,
                      updates_per_iteration=4, batch_size=32,
                      target_update_freq=4)
    assert cfg.epsilon_at(0) == 1.0
    assert abs(cfg.epsilon_at(10_000) - 0.05) < 1e-6
    algo = DQN(cfg)
    params = algo.learner_group._local.params
    for k, t in algo._target.items():
        assert t.data_ptr() != params[k].data_ptr()
    r1 = algo.train()
    assert r1["buffer_size"] > 0 and 0.0 < r1["epsilon"] <= 1.0
    assert r1["num_updates"] == 4
    # synced after the 4th update: equal values, separate storage
    for k, t in algo._target.items():
        assert torch.equal(t, params[k].detach())
        assert t.data_ptr() != params[k].data_ptr()
    algo.save_checkpoint(str(tmp_path))
    algo2 = DQN(_dqn_config(buffer_size=5000))
    algo2.load_checkpoint(str(tmp_path))
    for k, v in algo.get_weights().items():
        np.testing.assert_array_equal(algo2.get_weights()[k], v)
    algo.cleanup()
    algo2.cleanup()


def test_dqn_learns_cartpole():
    cfg = _dqn_config(buffer_size=20_000, learning_starts=500,
                      updates_per_iteration=64, batch_size=64,
                      target_update_freq=100, lr=5e-4,
                      epsilon_decay_steps=8_000)
    algo = DQN(cfg)
    best = 0.0
    for _ in range(40):
        ret = algo.train().get("episode_return_mean") or 0.0
        best = max(best, ret)
        if best >= 120.0:
            break
    algo.cleanup()
    assert best >= 120.0, f"DQN failed to learn CartPole: best={best}"


def _sac_config(**training):
    return (SACConfig()
            .environment("Pendulum-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(**training)
            .learners(num_gpus_per_learner=0)
            .debugging(seed=0))


class TestSAC:
    def test_sac_mechanics(self):
        algo = _sac_config(train_batch_size=128, learning_starts=200,
                           updates_per_iteration=4, batch_size=64).build()
        r1 = algo.train()
        r2 = algo.train()
        algo.cleanup()
        assert r2["buffer_size"] > r1["buffer_size"]
        assert r2["learner"], "no learner stats after learning_starts"
        assert np.isfinite(r2["learner"]["critic_loss"])
        assert r2["learner"]["alpha"] != 1.0

    def test_sac_prioritized_replay(self):
        algo = (_sac_config(train_batch_size=64, learning_starts=64,
                            updates_per_iteration=4, batch_size=32,
                            prioritized_replay=True)
                .env_runners(rollout_fragment_length=16)).build()
        algo.train()
        r = algo.train()
        algo.cleanup()
        assert np.isfinite(r["learner"]["critic_loss"])

    def test_sac_checkpoint_roundtrip(self, tmp_path):
        cfg = (_sac_config(train_batch_size=16, learning_starts=16,
                           updates_per_iteration=2, batch_size=8)
               .env_runners(num_envs_per_env_runner=2,
                            rollout_fragment_length=8))
        algo = cfg.build()
        algo.train()
        algo.save_checkpoint(str(tmp_path))
        w0 = algo.learner_group.get_weights()
        algo.cleanup()
        algo2 = SAC.from_checkpoint(str(tmp_path), cfg.copy())
        w1 = algo2.learner_group.get_weights()
        algo2.cleanup()
        assert sorted(w0) == sorted(w1)
        for k in w0:
            np.testing.assert_array_equal(w0[k], w1[k])


@pytest.fixture
def port_runtime():
    rt.init(num_cpus=6, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_async_remote_runners(port_runtime, algo):
    """Async harvest: the learner consumes whichever runner finishes
    first and resamples it (no gang barrier)."""
    cls = IMPALAConfig if algo == "impala" else APPOConfig
    config = (cls()
              .environment(env_creator=CartPoleEnv)
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=32,
                           num_cpus_per_env_runner=1)
              .learners(num_gpus_per_learner=0)
              .debugging(seed=0))
    a = config.build()
    r1 = a.train()
    assert r1["num_env_steps_sampled"] > 0
    r2 = a.train()
    assert r2["training_iteration"] == 2
    assert np.isfinite(r2["learner"].get("policy_loss", 0.0))
    a.cleanup()


def _learning_gate(config, iters, threshold):
    algo = config.build()
    best = -np.inf
    for _ in range(iters):
        r = algo.train()
        best = max(best, r.get("episode_return_mean", -np.inf))
        if best >= threshold:
            break
    algo.cleanup()
    return best


@pytest.mark.slow  # a learning curve: the JAX suite marks it slow
@pytest.mark.parametrize("cls,threshold", [(IMPALAConfig, 400),
                                           (APPOConfig, 400),
                                           (APPOConfig, 300)])
def test_async_algorithms_learn_cartpole(cls, threshold):
    training = dict(lr=5e-4, entropy_coeff=0.01)
    if threshold == 300:  # tests/test_appo_budget.py's config
        training["train_batch_size"] = 512
    config = (cls()
              .environment(env_creator=CartPoleEnv)
              .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                           rollout_fragment_length=64)
              .training(**training)
              .learners(num_gpus_per_learner=0)
              .debugging(seed=0))
    best = _learning_gate(config, 350, threshold)
    assert best >= threshold, f"{cls.__name__}: best={best}"


@pytest.mark.slow  # a learning curve: the JAX suite marks it slow
def test_dqn_learning_gate_300():
    config = _dqn_config(buffer_size=50_000, learning_starts=1000,
                         target_update_freq=250, updates_per_iteration=64,
                         batch_size=64, epsilon_decay_steps=12_000)
    best = _learning_gate(config, 200, 300)
    assert best >= 300, f"DQN failed to learn CartPole: best={best}"


@pytest.mark.slow  # a learning curve: the JAX suite marks it slow
def test_sac_learns_pendulum():
    config = _sac_config(train_batch_size=128, learning_starts=1000,
                         updates_per_iteration=128, batch_size=128,
                         actor_lr=1e-3, critic_lr=1e-3, alpha_lr=1e-3)
    best = _learning_gate(config, 120, -500)
    assert best >= -600, f"SAC failed to learn Pendulum: best={best}"


# --------------------------------------------------------------------------- #
# offline RL
# --------------------------------------------------------------------------- #


def test_record_transitions_roundtrip(port_runtime, tmp_path):
    path = str(tmp_path / "data")
    stats = record_transitions(CartPoleEnv, cartpole_expert_policy, 600,
                               path, seed=0)
    assert stats["episodes"] >= 1
    data = OfflineData.from_path(path)
    assert data.size == 600
    assert data.obs.shape == (600, 4)
    mb = data.sample(32, np.random.default_rng(0))
    assert mb["obs"].shape == (32, 4)
    assert mb["actions"].dtype == np.int32


def test_bc_and_cql_train_from_a_dataset(port_runtime, tmp_path):
    """A few updates of each on recorded data, no env sampling: finite
    losses, the BC loss falling, the actions scaled into [-1, 1] for
    CQL, a greedy evaluation on the env."""
    import gymnasium as gym

    cart = str(tmp_path / "cartpole")
    record_transitions(CartPoleEnv, cartpole_expert_policy, 1000, cart)
    cfg = BCConfig().learners(num_gpus_per_learner=0)
    cfg.environment(env_creator=CartPoleEnv)
    cfg.offline_data(input_path=cart, batch_size=64,
                     updates_per_iteration=30)
    bc = BC(config=cfg)
    first = bc.train()["bc_loss"]
    last = bc.train()["bc_loss"]
    assert last < first
    assert bc.evaluate(num_episodes=1) > 0
    pend = str(tmp_path / "pendulum")
    record_transitions(lambda: gym.make("Pendulum-v1"),
                       pendulum_expert_policy, 300, pend)
    cfg = CQLConfig().learners(num_gpus_per_learner=0)
    cfg.environment(env="Pendulum-v1")
    cfg.offline_data(input_path=pend, batch_size=32, updates_per_iteration=4)
    cfg.bc_iters = 2
    cql = CQL(config=cfg)
    assert np.abs(cql.offline_data.actions).max() <= 1.0
    r = cql.train()
    assert np.isfinite(r["critic_loss"]) and r["dataset_size"] == 300
    assert cql.learner_group.steps == 4
    assert np.isfinite(cql.evaluate(num_episodes=1))


@pytest.mark.slow  # a learning curve: the JAX suite marks it slow
def test_bc_learns_cartpole_from_offline_data(port_runtime, tmp_path):
    path = str(tmp_path / "cartpole")
    stats = record_transitions(CartPoleEnv, cartpole_expert_policy, 10_000,
                               path, seed=0)
    assert stats["mean_return"] >= 450
    cfg = BCConfig().learners(num_gpus_per_learner=0)
    cfg.environment(env_creator=CartPoleEnv)
    cfg.offline_data(input_path=path, batch_size=256,
                     updates_per_iteration=600)
    algo = BC(config=cfg)
    for _ in range(3):
        result = algo.train()
    assert result["bc_loss"] < 0.5
    ret = algo.evaluate(num_episodes=5)
    assert ret >= 400, f"BC policy return {ret} < 400"


@pytest.mark.slow  # a learning curve: the JAX suite marks it slow
def test_cql_learns_pendulum_from_offline_data(port_runtime, tmp_path):
    import gymnasium as gym

    path = str(tmp_path / "pendulum")
    rng = np.random.default_rng(0)

    def noisy_expert(obs):
        a = pendulum_expert_policy(obs)
        return np.clip(a + rng.normal(0, 0.4, a.shape).astype(np.float32),
                       -2.0, 2.0)

    stats = record_transitions(lambda: gym.make("Pendulum-v1"),
                               noisy_expert, 20_000, path, seed=0)
    assert stats["mean_return"] >= -600
    cfg = CQLConfig().learners(num_gpus_per_learner=0)
    cfg.environment(env="Pendulum-v1")
    cfg.offline_data(input_path=path, batch_size=256,
                     updates_per_iteration=500)
    cfg.bc_iters = 1500
    algo = CQL(config=cfg)
    best = -np.inf
    for i in range(5):
        result = algo.train()
        if i >= 2:
            best = max(best, algo.evaluate(num_episodes=10))
    assert np.isfinite(result["critic_loss"])
    assert best >= -500, f"CQL best policy return {best} < -500"


# --------------------------------------------------------------------------- #
# multi-agent
# --------------------------------------------------------------------------- #


def _env_creator():
    return SimpleSpread(n_agents=2, max_steps=25)


def _two_policy_mapping(aid):
    return {"agent_0": "p0", "agent_1": "p1"}[aid]


def test_simple_spread_matches_jax_and_api():
    from ray_tpu.rllib.multi_agent_env import SimpleSpread as JSpread

    env, ref = _env_creator(), JSpread(n_agents=2, max_steps=25)
    obs, _ = env.reset(seed=3)
    want, _ = ref.reset(seed=3)
    rng = np.random.default_rng(0)
    for _ in range(30):
        for a in want:
            np.testing.assert_array_equal(obs[a], want[a])
        if not env.agents:
            obs, _ = env.reset()
            want, _ = ref.reset()
            continue
        act = {a: int(rng.integers(0, 5)) for a in env.possible_agents}
        obs, rew, term, trunc, _ = env.step(act)
        want, wrew, wterm, wtrunc, _ = ref.step(act)
        assert (rew, term, trunc) == (wrew, wterm, wtrunc)
    space = env.observation_space("agent_0")
    assert space.shape == (8,) and env.action_space("agent_0").n == 5
    # teleport agents onto the landmarks: reward must be ~0
    env.reset(seed=0)
    env._pos = env._landmarks.copy()
    _, rew, _, _, _ = env.step({"agent_0": 0, "agent_1": 0})
    assert rew["agent_0"] > -1e-3


def test_multi_agent_episode_clock_and_cut():
    ep = MultiAgentEpisode()
    ep.add_reset({"a": np.zeros(2, np.float32), "b": np.ones(2, np.float32)})
    ep.add_step({"a": 1, "b": 0}, {"a": -0.1, "b": -0.2},
                {"a": 0.5, "b": 0.6},
                {"a": np.full(2, 2.0, np.float32),
                 "b": np.full(2, 3.0, np.float32)},
                {"a": 1.0, "b": 2.0}, {"__all__": False},
                {"__all__": False})
    nxt = ep.cut()
    assert nxt.env_t == 1 and set(nxt.pending_obs()) == {"a", "b"}
    assert ep.agent_trajectories()["a"]["last_obs"] is not None
    ep.add_step({"a": 2}, {"a": -0.3}, {"a": 0.7},
                {"a": np.full(2, 4.0, np.float32)},
                {"a": 0.5}, {"__all__": True}, {"__all__": False})
    assert ep.is_done
    trajs = ep.agent_trajectories()
    assert len(trajs["a"]["actions"]) == 2 and len(trajs["b"]["actions"]) == 1
    assert ep.agent_episodes["a"].env_ts == [0, 1]
    assert ep.total_reward == pytest.approx(3.5)


def _same_draws(seed):
    """A numpy stream of Gumbel draws for one runner's categorical
    actions; the two packages' runners each take one stream with the
    same seed."""
    rng = np.random.default_rng(seed)

    def gumbel(shape):
        return -np.log(-np.log(rng.uniform(1e-12, 1.0, shape)))

    return gumbel


@pytest.mark.parametrize("shared", [True, False])
def test_multi_agent_runner_matches_jax_with_the_same_draws(monkeypatch,
                                                            shared):
    """Both runners over SimpleSpread (2 envs x 2 agents, 40 steps: an
    episode ends and a live one is cut), the JAX one's and the port's
    categorical draws replaced by the same numpy Gumbel draws: obs,
    actions, rewards and termination bitwise per trajectory; logp,
    value predictions and bootstrap values within 1e-6 of the largest."""
    import jax

    from ray_tpu.rllib import multi_agent as jax_ma
    from ray_tpu.rllib.multi_agent_env import SimpleSpread as JSpread
    from ray_tpu.rllib.rl_module import RLModuleSpec as JSpec

    if shared:
        mapping = functools.partial(map_all_to, "shared")
        mids = ("shared",)
    else:
        mapping, mids = _two_policy_mapping, ("p0", "p1")
    jspec = jax_ma.MultiRLModuleSpec(
        module_specs={m: JSpec(hiddens=(16,)) for m in mids},
        policy_mapping_fn=mapping)
    pspec = MultiRLModuleSpec(
        module_specs={m: RLModuleSpec(hiddens=(16,)) for m in mids},
        policy_mapping_fn=mapping)
    ref = jax_ma.MultiAgentEnvRunner(
        lambda: JSpread(n_agents=2, max_steps=25), jspec, num_envs=2,
        rollout_len=40, seed=0)
    port = MultiAgentEnvRunner(_env_creator, pspec, num_envs=2,
                               rollout_len=40, seed=0)
    weights = {m: {k: np.asarray(v) for k, v in
                   ref.modules[m].init(jax.random.PRNGKey(i)).items()}
               for i, m in enumerate(mids)}
    jdraw, pdraw = _same_draws(5), _same_draws(5)

    def jax_forward(self, mid, obs):
        logits, value = self.modules[mid].forward(self._params[mid], obs)
        logits = np.asarray(logits, np.float64)
        action = np.argmax(logits + jdraw(logits.shape), -1)
        logp_all = np.asarray(jax.nn.log_softmax(
            self.modules[mid].forward(self._params[mid], obs)[0]))
        return (action, logp_all[np.arange(len(action)), action]
                .astype(np.float32), np.asarray(value, np.float32))

    def port_draw(self, logits):
        return torch.from_numpy(np.argmax(
            logits.numpy().astype(np.float64) + pdraw(tuple(logits.shape)),
            -1))

    monkeypatch.setattr(jax_ma.MultiAgentEnvRunner, "_forward_module",
                        jax_forward)
    monkeypatch.setattr(MultiAgentEnvRunner, "_draw_actions", port_draw)
    want, wstats = ref.sample(weights)
    got, gstats = port.sample(weights)
    assert sorted(got) == sorted(want) == sorted(mids)
    assert gstats["env_steps"] == wstats["env_steps"] == 80
    assert gstats["agent_steps"] == wstats["agent_steps"]
    assert gstats["episode_returns"] == wstats["episode_returns"]
    for m in mids:
        assert len(got[m]) == len(want[m])
        for g, w in zip(got[m], want[m]):
            for k in ("obs", "actions", "rewards", "terminated"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            for k in ("logp", "vf_preds", "vf_last"):
                scale = max(float(np.abs(w[k]).max()), 1e-6)
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=FORWARD_RTOL * scale,
                                           err_msg=k)


_HASH_ORDER = """
import json, sys, zlib
import numpy as np
mids = ("p0", "p1", "shared")
print(json.dumps({
    "jax": [np.random.default_rng(3 * 997 + hash(m) % 1000)
            .permutation(64).tolist() for m in mids],
    "port": [np.random.default_rng(3 * 997 + zlib.crc32(m.encode()) % 1000)
             .permutation(64).tolist() for m in mids]}))
"""


def test_multi_agent_minibatch_order_is_stable_across_processes():
    """The JAX group seeds each policy's minibatch order from
    ``hash(mid) % 1000``: Python salts ``str`` hashes per process, so two
    processes under different ``PYTHONHASHSEED`` take different orders.
    The port's ``zlib.crc32`` gives the same order in both."""
    orders = []
    for hash_seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": hash_seed}
        out = subprocess.run([sys.executable, "-c", _HASH_ORDER], env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True)
        orders.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert orders[0]["jax"] != orders[1]["jax"]
    assert orders[0]["port"] == orders[1]["port"]


def test_multi_agent_learner_group_update_matches_jax():
    """One policy's update in the port's group against a JAX learner fed
    the same minibatch order (the port's stable seed) and weights."""
    from ray_tpu.rllib.learner import Learner as JLearner
    from ray_tpu.rllib.ppo import PPOConfig as JPPOConfig
    from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss
    from ray_tpu.rllib.rl_module import JaxRLModule
    from ray_tpu_torch.rllib import MultiAgentLearnerGroup
    from ray_tpu_torch.rllib import ppo as port_ppo

    env = _env_creator()
    pspec = MultiRLModuleSpec(module_specs={"p0": RLModuleSpec(),
                                            "p1": RLModuleSpec()},
                              policy_mapping_fn=_two_policy_mapping)
    pcfg = PPOConfig().training(lr=1e-3).learners(num_gpus_per_learner=0)
    group = MultiAgentLearnerGroup(pcfg, pspec, pspec.module_spaces(env),
                                   port_ppo.ppo_loss(pcfg))
    jcfg = JPPOConfig().training(lr=1e-3)
    rng = np.random.default_rng(0)
    batches, want = {}, {}
    for mid in ("p0", "p1"):
        jl = JLearner(JaxRLModule(8, 5), jcfg, jax_ppo_loss(jcfg))
        group.set_weights({mid: jl.get_weights()})
        batches[mid] = {
            "obs": rng.normal(size=(96, 8)).astype(np.float32),
            "actions": rng.integers(0, 5, 96).astype(np.int64),
            "logp": np.log(rng.uniform(0.1, 0.4, 96)).astype(np.float32),
            "advantages": rng.normal(size=96).astype(np.float32),
            "value_targets": rng.normal(size=96).astype(np.float32),
            "vf_preds": rng.normal(size=96).astype(np.float32)}
        stats = jl.update(batches[mid], num_epochs=2, minibatch_size=32,
                          rng=np.random.default_rng(
                              3 * 997 + zlib.crc32(mid.encode()) % 1000))
        want[mid] = (stats, jl.get_weights())
    got = group.update(batches, num_epochs=2, minibatch_size=32, seed=3)
    weights = group.get_weights()
    for mid in ("p0", "p1"):
        for k in want[mid][0]:
            np.testing.assert_allclose(got[mid][k], want[mid][0][k],
                                       rtol=LOSS_RTOL, atol=1e-7)
        assert_leaves_close(weights[mid], want[mid][1], what=mid)


def test_multi_agent_ppo_trains_and_checkpoints(tmp_path):
    config = (PPOConfig()
              .environment(env_creator=_env_creator)
              .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                           rollout_fragment_length=25)
              .training(train_batch_size=100, minibatch_size=32,
                        num_epochs=1)
              .multi_agent(policies={"p0": RLModuleSpec(hiddens=(16,)),
                                     "p1": RLModuleSpec(hiddens=(16,))},
                           policy_mapping_fn=_two_policy_mapping)
              .learners(num_gpus_per_learner=0)
              .debugging(seed=0))
    algo = config.build()
    r = algo.train()
    assert set(r["learner"]) == {"p0", "p1"}
    algo.save_checkpoint(str(tmp_path))
    algo2 = config.build()
    algo2.load_checkpoint(str(tmp_path))
    for mid, w in algo.get_weights().items():
        for k, v in w.items():
            np.testing.assert_array_equal(algo2.get_weights()[mid][k], v)


def _random_baseline(n_episodes=40):
    env = _env_creator()
    rng = np.random.default_rng(0)
    returns = []
    for i in range(n_episodes):
        env.reset(seed=100 + i)
        total, done = 0.0, False
        while not done:
            _, rew, term, trunc, _ = env.step(
                {a: int(rng.integers(0, 5)) for a in env.possible_agents})
            total += sum(rew.values())
            done = term["__all__"] or trunc["__all__"]
        returns.append(total)
    return float(np.mean(returns))


@pytest.mark.slow  # a learning curve: the JAX suite marks it slow
def test_two_policies_learn_simple_spread():
    baseline = _random_baseline()
    config = (PPOConfig()
              .environment(env_creator=_env_creator)
              .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                           rollout_fragment_length=50)
              .training(lr=1e-3, gamma=0.95, train_batch_size=800,
                        minibatch_size=256, num_epochs=6,
                        entropy_coeff=0.01)
              .multi_agent(policies={"p0": RLModuleSpec(hiddens=(64, 64)),
                                     "p1": RLModuleSpec(hiddens=(64, 64))},
                           policy_mapping_fn=_two_policy_mapping)
              .learners(num_gpus_per_learner=0)
              .debugging(seed=0))
    best = _learning_gate(config, 250, baseline * 0.55)
    assert best >= baseline * 0.55, (best, baseline)

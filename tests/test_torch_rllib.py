"""The port's RLlib core (``ray_tpu_torch/rllib``) held to the JAX
package's (``ray_tpu/rllib``) on the CPU: the module, the PPO loss, the
clip and Adam of the learner, the learner's update, the greedy runner's
batch, GAE, the envs against gymnasium, the multi-learner update over
gloo against JAX's ``store`` group, and the cases of
``tests/test_rllib.py`` on the port's runtime (checkpoints, remote
runners, a runner's death and restore, PPO under the port's Tune, the
CartPole learning gate).

Parity inputs are made from a seed with numpy; the JAX params are
carried into the port with ``from_jax_params`` / ``set_weights``. The
learners here run on the CPU (``num_gpus_per_learner=0``); the card's
run is ``chip_smoke.py``'s ``rllib`` phase. Functions defined here run
in the port's workers, which import this module: nothing at its top
imports JAX or the JAX package.
"""

import inspect
import pickle
import types

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import (PPO, PPOConfig, RLModuleSpec,
                                 TorchRLModule, compute_gae)
from ray_tpu_torch.rllib import ppo as port_ppo
from ray_tpu_torch.rllib.envs import CartPoleEnv, SyncVectorEnv
from ray_tpu_torch.rllib.learner import (Learner, clip_by_global_norm,
                                         learner_device)
from ray_tpu_torch.rllib.rl_module import from_jax_params, to_numpy

# parity tolerances: loss and stats rtol 1e-5; a grad or param leaf
# within 1e-5 of the leaf's largest |value|; the module's outputs within
# 1e-6 of the largest |output| (float32 ulps of the largest value)
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


def leaves_close(got, want, rel=LEAF_RTOL) -> bool:
    try:
        assert_leaves_close(got, want, rel)
        return True
    except AssertionError:
        return False


def _cpu(**training):
    base = dict(train_batch_size=256, minibatch_size=64, num_epochs=3,
                lr=3e-4)
    base.update(training)
    return (PPOConfig()
            .environment(env_creator=CartPoleEnv)
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(**base)
            .learners(num_gpus_per_learner=0)
            .debugging(seed=0))


def _jax_params(obs_dim=4, num_actions=2, hiddens=(64, 64),
                activation="tanh", seed=0):
    import jax

    from ray_tpu.rllib.rl_module import JaxRLModule

    module = JaxRLModule(obs_dim, num_actions, hiddens, activation)
    params = module.init(jax.random.PRNGKey(seed))
    return module, {k: np.asarray(v) for k, v in params.items()}


def _port_module(jax_params, obs_dim=4, num_actions=2, hiddens=(64, 64),
                 activation="tanh"):
    module = TorchRLModule(obs_dim, num_actions, hiddens, activation)
    module.load_state_dict(from_jax_params(jax_params))
    return module


def _ppo_minibatch(rng, n, obs_dim=4, num_actions=2):
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, n).astype(np.int64),
        "logp": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32) * 3.0,
        "value_targets": rng.normal(size=n).astype(np.float32) * 5.0,
        "vf_preds": rng.normal(size=n).astype(np.float32) * 5.0,
    }


def _torch_batch(mb):
    return {k: torch.as_tensor(v) for k, v in mb.items()}


def _port_loss_and_grads(loss_fn, module, mb):
    params = module.params()
    loss, stats = loss_fn(module, params, _torch_batch(mb))
    grads = torch.autograd.grad(loss, list(params.values()))
    return (float(loss), {k: float(v) for k, v in stats.items()},
            {k: g.numpy() for k, g in zip(params, grads)})


def _jax_loss_and_grads(loss_fn, module, params, mb):
    import jax

    (loss, stats), grads = jax.value_and_grad(
        lambda p: loss_fn(module, p, mb), has_aux=True)(params)
    return (float(loss), {k: float(v) for k, v in stats.items()},
            {k: np.asarray(v) for k, v in grads.items()})


# --------------------------------------------------------------------------- #
# envs against gymnasium
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["random", "balancing"])
def test_cartpole_and_vectorizer_match_gymnasium_bitwise(policy):
    """1,000 steps of 4 CartPole envs through each vectorizer: the port's
    ``SyncVectorEnv`` over ``CartPoleEnv`` against gymnasium's over
    ``gym.make("CartPole-v1")``, bitwise. The random policy ends many
    episodes (terminations, autoreset rows); the balancing one reaches
    the 500-step truncation."""
    import gymnasium as gym

    ref = gym.vector.SyncVectorEnv(
        [lambda: gym.make("CartPole-v1") for _ in range(4)])
    port = SyncVectorEnv([CartPoleEnv for _ in range(4)])
    o_ref, _ = ref.reset(seed=7)
    o_port, _ = port.reset(seed=7)
    np.testing.assert_array_equal(o_port, o_ref)
    rng = np.random.default_rng(0)
    truncations = terminations = 0
    for _ in range(1000):
        if policy == "random":
            act = rng.integers(0, 2, 4)
        else:
            act = (o_ref[:, 2] + 0.5 * o_ref[:, 3] > 0).astype(np.int64)
        o_ref, r_ref, te_ref, tr_ref, _ = ref.step(act)
        o_port, r_port, te_port, tr_port, _ = port.step(act)
        for got, want in ((o_port, o_ref), (r_port, r_ref),
                          (te_port, te_ref), (tr_port, tr_ref)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        truncations += int(tr_ref.sum())
        terminations += int(te_ref.sum())
    if policy == "random":
        assert terminations > 100
    else:
        assert truncations >= 4
    # spaces read by duck typing: the same shape, bounds and n
    env = CartPoleEnv()
    genv = gym.make("CartPole-v1")
    assert env.observation_space.shape == genv.observation_space.shape
    np.testing.assert_array_equal(env.observation_space.high,
                                  genv.observation_space.high)
    assert env.action_space.n == genv.action_space.n


# --------------------------------------------------------------------------- #
# module
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("hiddens,activation", [((64, 64), "tanh"),
                                                ((32,), "relu")])
def test_module_forward_from_carried_params(hiddens, activation):
    jmod, params = _jax_params(6, 3, hiddens, activation)
    module = _port_module(params, 6, 3, hiddens, activation)
    obs = np.random.default_rng(1).normal(size=(17, 6)).astype(np.float32)
    want_logits, want_value = jmod.forward(params, obs)
    logits, value = module(torch.from_numpy(obs))
    assert logits.shape == (17, 3) and value.shape == (17,)
    for got, want in ((logits, want_logits), (value, want_value)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.detach().numpy(), want, rtol=0,
            atol=FORWARD_RTOL * float(np.abs(want).max()))
    # names and layout are the JAX keys', both ways
    back = to_numpy(module)
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])


def test_module_init_is_seeded():
    spec, env = RLModuleSpec(), CartPoleEnv()
    a, b = (spec.build(env.observation_space, env.action_space).init_params(
        torch.Generator().manual_seed(3)) for _ in range(2))
    for k, v in to_numpy(a).items():
        np.testing.assert_array_equal(v, to_numpy(b)[k])
    w = to_numpy(a)
    assert abs(w["pi_w0"].std() - np.sqrt(2.0 / 4)) < 0.25
    assert abs(w["pi_out_w"].std() - 0.01) < 0.005
    assert not w["pi_b0"].any() and not w["vf_out_b"].any()


# --------------------------------------------------------------------------- #
# the PPO loss, the clip and Adam
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rows", [8, 128])
@pytest.mark.parametrize("entropy_coeff", [0.0, 0.01])
def test_ppo_loss_matches_jax(rows, entropy_coeff):
    from ray_tpu.rllib.ppo import PPOConfig as JPPOConfig
    from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss

    jmod, params = _jax_params()
    module = _port_module(params)
    mb = _ppo_minibatch(np.random.default_rng(rows), rows)
    jcfg = JPPOConfig().training(entropy_coeff=entropy_coeff)
    pcfg = PPOConfig().training(entropy_coeff=entropy_coeff)
    want = _jax_loss_and_grads(jax_ppo_loss(jcfg), jmod, params, mb)
    got = _port_loss_and_grads(port_ppo.ppo_loss(pcfg), module, mb)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert_leaves_close(got[2], want[2], what="grad")


def test_ppo_loss_with_torch_std_default_fails_parity():
    """``jnp.std`` is the population std; ``torch.std`` defaults to the
    unbiased one. A copy of ``ppo.py`` using the default misses the JAX
    loss on a minibatch of 8 rows by far more than the tolerance."""
    from ray_tpu.rllib.ppo import PPOConfig as JPPOConfig
    from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss

    src = inspect.getsource(port_ppo)
    assert src.count("adv.std(correction=0)") == 1
    mutant = types.ModuleType("ray_tpu_torch.rllib._ppo_std_default")
    mutant.__package__ = "ray_tpu_torch.rllib"
    exec(compile(src.replace("adv.std(correction=0)", "adv.std()"),
                 "ppo_std_default", "exec"), mutant.__dict__)
    jmod, params = _jax_params()
    module = _port_module(params)
    mb = _ppo_minibatch(np.random.default_rng(8), 8)
    want = _jax_loss_and_grads(jax_ppo_loss(JPPOConfig()), jmod, params, mb)
    got = _port_loss_and_grads(mutant.ppo_loss(PPOConfig()), module, mb)
    assert abs(got[1]["policy_loss"] - want[1]["policy_loss"]) > \
        100 * LOSS_RTOL * abs(want[1]["policy_loss"])
    assert not leaves_close(got[2], want[2])


@pytest.mark.parametrize("over", [1.0005, 0.9996])
def test_clip_is_optax_rule_not_clip_grad_norm(over):
    """At a global norm just over the clip (and just under it), the
    port's clip equals ``optax.clip_by_global_norm``; torch's
    ``clip_grad_norm_`` (which divides by ``norm + 1e-6``) misses it by
    far more than the tolerance at a clip of 1e-3."""
    import optax

    max_norm = 1e-3
    rng = np.random.default_rng(0)
    leaves = {"a": rng.normal(size=(5, 7)), "b": rng.normal(size=(7,))}
    norm = np.sqrt(sum((v ** 2).sum() for v in leaves.values()))
    leaves = {k: (v / norm * max_norm * over).astype(np.float32)
              for k, v in leaves.items()}
    want, _ = optax.clip_by_global_norm(max_norm).update(leaves, None)
    got = clip_by_global_norm([torch.from_numpy(v) for v in leaves.values()],
                              max_norm)
    assert_leaves_close(dict(zip(leaves, [g.numpy() for g in got])),
                        {k: np.asarray(v) for k, v in want.items()})
    plain = [torch.from_numpy(v.copy()) for v in leaves.values()]
    for p, g in zip(plain, [torch.from_numpy(v) for v in leaves.values()]):
        p.grad = g.clone()
    torch.nn.utils.clip_grad_norm_(plain, max_norm)
    assert not leaves_close(
        dict(zip(leaves, [p.grad.numpy() for p in plain])),
        {k: np.asarray(v) for k, v in want.items()})


def test_learner_update_matches_jax_with_clip_engaged():
    """Three minibatch updates of the PPO learner (clip 0.05, engaged on
    every one), from the same params and batch: params within 1e-5 of
    each leaf's largest |value| of the JAX learner's, stats rtol 1e-5,
    and the Adam state in step."""
    import optax

    from ray_tpu.rllib.learner import Learner as JLearner
    from ray_tpu.rllib.ppo import PPOConfig as JPPOConfig
    from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss
    from ray_tpu.rllib.rl_module import JaxRLModule

    jcfg = JPPOConfig().training(grad_clip=0.05, lr=1e-3)
    pcfg = PPOConfig().training(grad_clip=0.05, lr=1e-3).learners(
        num_gpus_per_learner=0)
    jl = JLearner(JaxRLModule(4, 2), jcfg, jax_ppo_loss(jcfg))
    pl = Learner(TorchRLModule(4, 2), pcfg, port_ppo.ppo_loss(pcfg))
    pl.set_weights(jl.get_weights())
    batch = _ppo_minibatch(np.random.default_rng(5), 48)
    # the clip engages: the first minibatch's grad norm is over 0.05
    _, _, grads = pl.compute_gradients(
        {k: torch.as_tensor(v[:16]) for k, v in batch.items()})
    assert float(torch.linalg.vector_norm(
        torch.cat([g.reshape(-1) for g in grads]))) > 0.05
    want = jl.update(batch, num_epochs=1, minibatch_size=16,
                     rng=np.random.default_rng(11))
    got = pl.update(batch, num_epochs=1, minibatch_size=16,
                    rng=np.random.default_rng(11))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert_leaves_close(pl.get_weights(), jl.get_weights(), what="param")
    adam = jl.state["opt_state"][1][0]
    assert isinstance(adam, optax.ScaleByAdamState)
    assert pl.optimizer.count == int(adam.count) == 3
    state = pl.optimizer.state_dict()
    assert_leaves_close(state["mu"], {k: np.asarray(v)
                                      for k, v in adam.mu.items()})


def test_learner_state_is_numpy_and_restores():
    cfg = _cpu()
    a = Learner(TorchRLModule(4, 2), cfg, port_ppo.ppo_loss(cfg))
    a.update(_ppo_minibatch(np.random.default_rng(0), 64), num_epochs=2,
             minibatch_size=32)
    blob = a.get_state()

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        else:
            yield x

    state = pickle.loads(blob)
    assert not [x for x in leaves(state) if isinstance(x, torch.Tensor)]
    b = Learner(TorchRLModule(4, 2), cfg.copy().debugging(seed=9),
                port_ppo.ppo_loss(cfg))
    b.set_state(blob)
    assert_leaves_close(b.get_weights(), a.get_weights(), rel=0)
    assert b.optimizer.count == a.optimizer.count == 4
    mb = _ppo_minibatch(np.random.default_rng(1), 32)
    a.update(mb, num_epochs=1, minibatch_size=32)
    b.update(mb, num_epochs=1, minibatch_size=32)
    assert_leaves_close(b.get_weights(), a.get_weights(), rel=0)


def test_learner_device_policy():
    """The learner runs on the card unless the config asks for the CPU;
    with no card it raises, naming the option. A mesh is refused,
    naming ``num_learners``."""
    cfg = PPOConfig()
    assert cfg.num_gpus_per_learner == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
            learner_device(cfg)
        with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
            Learner(TorchRLModule(4, 2), cfg, port_ppo.ppo_loss(cfg))
    assert learner_device(_cpu()) == torch.device("cpu")
    meshed = _cpu().learners(mesh=object())
    with pytest.raises(ValueError, match="num_learners"):
        Learner(TorchRLModule(4, 2), meshed, port_ppo.ppo_loss(meshed))


# --------------------------------------------------------------------------- #
# GAE and the runner
# --------------------------------------------------------------------------- #


def test_gae_matches_manual():
    T, N = 3, 1
    gamma, lam = 0.9, 0.8
    batch = {
        "rewards": np.array([[1.0], [1.0], [1.0]], np.float32),
        "vf_preds": np.array([[0.5], [0.6], [0.7]], np.float32),
        "terminateds": np.array([[False], [False], [False]]),
        "dones": np.array([[False], [False], [False]]),
        "valid": np.ones((T, N), bool),
        "vf_last": np.array([0.8], np.float32),
        "obs": np.zeros((T, N, 4), np.float32),
        "actions": np.zeros((T, N), np.int64),
        "logp": np.zeros((T, N), np.float32),
    }
    flat = compute_gae(batch, gamma, lam)
    d2 = 1.0 + gamma * 0.8 - 0.7
    d1 = 1.0 + gamma * 0.7 - 0.6
    d0 = 1.0 + gamma * 0.6 - 0.5
    a2 = d2
    a1 = d1 + gamma * lam * a2
    a0 = d0 + gamma * lam * a1
    np.testing.assert_allclose(flat["advantages"], [a0, a1, a2], rtol=1e-5)
    np.testing.assert_allclose(
        flat["value_targets"],
        np.array([a0, a1, a2]) + np.array([0.5, 0.6, 0.7]), rtol=1e-5)


def test_gae_masks_autoreset_rows():
    T, N = 3, 1
    batch = {
        "rewards": np.ones((T, N), np.float32),
        "vf_preds": np.zeros((T, N), np.float32),
        "terminateds": np.array([[True], [False], [False]]),
        "dones": np.array([[True], [False], [False]]),
        "valid": np.array([[True], [False], [True]]),
        "vf_last": np.zeros((1,), np.float32),
        "obs": np.zeros((T, N, 4), np.float32),
        "actions": np.zeros((T, N), np.int64),
        "logp": np.zeros((T, N), np.float32),
    }
    flat = compute_gae(batch, 0.99, 0.95)
    assert len(flat["actions"]) == 2
    np.testing.assert_allclose(flat["advantages"][0], 1.0, rtol=1e-5)


def test_greedy_runner_batch_matches_jax():
    """Two 64-step rollouts of 4 envs on the greedy path
    (``epsilon=0.0``): the port's runner over ``CartPoleEnv`` against the
    JAX runner over gymnasium, from the same weights. Obs, actions,
    rewards and masks bitwise; value predictions within 1e-6 of the
    batch's largest |value|; GAE of the two batches alike."""
    import gymnasium as gym

    from ray_tpu.rllib.env_runner import SingleAgentEnvRunner as JRunner
    from ray_tpu.rllib.rl_module import RLModuleSpec as JSpec
    from ray_tpu_torch.rllib import SingleAgentEnvRunner

    _, weights = _jax_params(seed=4)
    ref = JRunner(lambda: gym.make("CartPole-v1"), JSpec(), 4, 64, seed=3)
    port = SingleAgentEnvRunner(CartPoleEnv, RLModuleSpec(), 4, 64, seed=3)
    for _ in range(2):
        want, wstats = ref.sample(weights, epsilon=0.0)
        got, gstats = port.sample(weights, epsilon=0.0)
        for k in ("obs", "actions", "rewards", "terminateds", "dones",
                  "valid", "last_obs"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["logp"], np.zeros((64, 4)))
        for k in ("vf_preds", "vf_last"):
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=FORWARD_RTOL * scale,
                                       err_msg=k)
        assert gstats["episode_returns"] == wstats["episode_returns"]
        assert gstats["env_steps"] == wstats["env_steps"]
    assert not got["valid"].all()  # autoreset rows were seen
    g, w = compute_gae(got, 0.99, 0.95), compute_gae(want, 0.99, 0.95)
    np.testing.assert_allclose(g["advantages"], w["advantages"], rtol=0,
                               atol=1e-4 * float(np.abs(w["advantages"])
                                                 .max()))


def test_runner_sampling_draws_from_its_generator():
    from ray_tpu_torch.rllib import SingleAgentEnvRunner

    _, weights = _jax_params()
    a = SingleAgentEnvRunner(CartPoleEnv, RLModuleSpec(), 4, 32, seed=1)
    b = SingleAgentEnvRunner(CartPoleEnv, RLModuleSpec(), 4, 32, seed=1)
    ba, _ = a.sample(weights)
    bb, _ = b.sample(weights)
    np.testing.assert_array_equal(ba["actions"], bb["actions"])
    assert (ba["logp"] < 0).all()
    # both actions drawn: the policy at init is near uniform
    assert 0.2 < ba["actions"].mean() < 0.8
    probe = a.probe()
    assert probe["module_device"] == "cpu"


# --------------------------------------------------------------------------- #
# PPO end to end (tests/test_rllib.py on the port)
# --------------------------------------------------------------------------- #


def test_ppo_local_smoke_and_checkpoint(tmp_path):
    algo = _cpu().build()
    r1 = algo.train()
    assert r1["training_iteration"] == 1
    assert r1["num_env_steps_sampled"] > 0
    assert "policy_loss" in r1["learner"]
    algo.save_checkpoint(str(tmp_path))
    algo2 = _cpu().debugging(seed=5).build()
    algo2.load_checkpoint(str(tmp_path))
    w1 = algo.get_weights()
    w2 = algo2.get_weights()
    for k in w1:
        np.testing.assert_array_equal(w1[k], w2[k])
    assert algo2._iteration == 1
    lr1 = algo.learner_group._local
    lr2 = algo2.learner_group._local
    assert lr2.optimizer.count == lr1.optimizer.count > 0
    for m1, m2 in zip(lr1.optimizer.mu, lr2.optimizer.mu):
        assert torch.equal(m1, m2)
    # the restored run continues as the original would
    r1, r2 = algo.train(), algo2.train()
    assert r2["training_iteration"] == 2
    algo.cleanup()
    algo2.cleanup()


def test_ppo_learns_cartpole():
    """North-star gate: >=450 mean return on CartPole-v1 (local runner),
    the JAX test's config, the learner on the CPU."""
    config = (PPOConfig()
              .environment(env_creator=CartPoleEnv)
              .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                           rollout_fragment_length=128)
              .training(train_batch_size=1024, minibatch_size=256,
                        num_epochs=12, lr=3e-4, entropy_coeff=0.01)
              .learners(num_gpus_per_learner=0)
              .debugging(seed=0))
    algo = config.build()
    best = 0.0
    for _ in range(120):
        r = algo.train()
        best = max(best, r.get("episode_return_mean", 0.0))
        if best >= 450:
            break
    assert best >= 450, f"PPO failed to solve CartPole: best={best}"


def test_ppo_resolves_gymnasium_env_ids():
    """``environment("CartPole-v1")`` still builds through
    ``gymnasium.make``, as in the JAX package."""
    cfg = _cpu()
    cfg.env_creator = None
    cfg.environment("CartPole-v1")
    algo = cfg.build()
    r = algo.train()
    assert r["num_env_steps_sampled"] >= 256
    algo.cleanup()


@pytest.fixture
def port_runtime():
    rt.init(num_cpus=6, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()


def _remote_config(cpus_per_runner=1):
    return (PPOConfig()
            .environment(env_creator=CartPoleEnv)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32,
                         num_cpus_per_env_runner=cpus_per_runner)
            .training(train_batch_size=128, minibatch_size=64,
                      num_epochs=2)
            .learners(num_gpus_per_learner=0))


def test_ppo_remote_env_runners_stay_on_the_cpu(port_runtime):
    algo = _remote_config().build()
    r = algo.train()
    assert r["num_env_steps_sampled"] >= 128
    assert r["num_healthy_workers"] == 2
    probes = rt.get([a.probe.remote()
                     for a in algo.env_runner_group._runners])
    assert len({p["pid"] for p in probes}) == 2
    for p in probes:
        assert p["module_device"] == "cpu"
        assert not p["cuda_initialized"] and not p["jax_loaded"]
        # torch's threads fit to the actor's one CPU (a thread a core in
        # each of two runners made sampling many times slower)
        assert p["torch_threads"] == 1
    algo.cleanup()


def test_ppo_env_runner_death_tolerated(port_runtime):
    """Kill an env-runner actor mid-training: iteration completes on the
    survivor and the dead runner is restored for the next one (reference:
    FaultTolerantActorManager + restore_workers)."""
    algo = _remote_config(cpus_per_runner=0.5).build()
    algo.train()
    rt.kill(algo.env_runner_group._runners[0])
    r2 = algo.train()  # must not raise; sampling skips the dead runner
    assert r2["training_iteration"] == 2
    r3 = algo.train()
    assert r3["num_healthy_workers"] == 2  # restored
    assert algo.env_runner_group.num_restarts == 1
    algo.cleanup()


def _multi_learner_batch(seed: int = 0, n: int = 256):
    return _ppo_minibatch(np.random.default_rng(seed), n)


def test_multi_learner_update_matches_jax_store_group(port_runtime):
    """``num_learners=2``: the batch sharded over two learner actors
    whose grads sync by the mean over a gloo group (the JAX package's: a
    ``store`` group), from the same weights, on the same batch and seed.
    The two port learners end equal, and within 1e-5 of each leaf's
    largest |value| of the JAX learners'."""
    import ray_tpu

    from ray_tpu.rllib.learner import LearnerGroup as JGroup
    from ray_tpu.rllib.ppo import PPOConfig as JPPOConfig
    from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss
    from ray_tpu.rllib.rl_module import RLModuleSpec as JSpec
    from ray_tpu_torch.rllib.learner import LearnerGroup

    space = CartPoleEnv()
    _, w0 = _jax_params(seed=2)
    batch = _multi_learner_batch()
    jcfg = (JPPOConfig().training(num_epochs=1, minibatch_size=64,
                                  lr=1e-3)
            .learners(num_learners=2, num_cpus_per_learner=1))
    ray_tpu.init(num_cpus=4, num_tpus=0)
    try:
        jg = JGroup(jcfg, JSpec(), space.observation_space,
                    space.action_space, jax_ppo_loss(jcfg))
        jg.set_weights(w0)
        jstats = jg.update(batch, num_epochs=1, minibatch_size=64, seed=3)
        want = jg.get_weights()
    finally:
        ray_tpu.shutdown()
    pcfg = (PPOConfig().training(num_epochs=1, minibatch_size=64, lr=1e-3)
            .learners(num_learners=2, num_cpus_per_learner=1,
                      num_gpus_per_learner=0))
    pg = LearnerGroup(pcfg, RLModuleSpec(), space.observation_space,
                      space.action_space, port_ppo.ppo_loss(pcfg))
    try:
        assert [d["device"] for d in rt.get(
            [a.device.remote() for a in pg._actors])] == ["cpu", "cpu"]
        pg.set_weights(w0)
        pstats = pg.update(batch, num_epochs=1, minibatch_size=64, seed=3)
        w_a, w_b = rt.get([a.get_weights.remote() for a in pg._actors])
    finally:
        pg.stop()
    assert_leaves_close(w_b, w_a, rel=0, what="replica")
    assert_leaves_close(w_a, want, what="param")
    for k in jstats:
        np.testing.assert_allclose(pstats[k], jstats[k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


def test_ppo_multi_learner_algorithm(port_runtime):
    config = (PPOConfig()
              .environment(env_creator=CartPoleEnv)
              .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .training(train_batch_size=256, minibatch_size=128,
                        num_epochs=2)
              .learners(num_learners=2, num_cpus_per_learner=1,
                        num_gpus_per_learner=0)
              .debugging(seed=0))
    algo = config.build()
    r = algo.train()
    assert "policy_loss" in r["learner"]
    w0, w1 = rt.get([a.get_weights.remote()
                     for a in algo.learner_group._actors])
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])
    algo.cleanup()


def _tune_trainable(config):
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import PPOConfig as _Cfg
    from ray_tpu_torch.rllib.envs import CartPoleEnv as _Env

    algo = (_Cfg()
            .environment(env_creator=_Env)
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(train_batch_size=256, minibatch_size=64,
                      num_epochs=3, lr=config["lr"])
            .learners(num_gpus_per_learner=0)
            .debugging(seed=0)).build()
    for _ in range(2):
        r = algo.train()
    tune.report({"episode_return_mean": r.get("episode_return_mean", 0.0)})


def test_ppo_under_tune(port_runtime, tmp_path):
    """An Algorithm trains in a trial of the port's Tune (reference:
    Algorithm(Trainable))."""
    from ray_tpu_torch import tune

    results = tune.run(_tune_trainable,
                       config={"lr": tune.grid_search([1e-4, 3e-4])},
                       metric="episode_return_mean", mode="max",
                       storage_path=str(tmp_path))
    assert len(results) == 2
    assert not results.errors
    assert results.get_best_result().metrics["episode_return_mean"] >= 0


def test_ppo_algorithm_as_class_trainable(port_runtime, tmp_path):
    """PPO itself as a Tune class trainable, its config a dict."""
    from ray_tpu_torch import tune

    space = {"env_creator": CartPoleEnv, "num_env_runners": 0,
             "num_envs_per_env_runner": 2, "rollout_fragment_length": 32,
             "train_batch_size": 64, "minibatch_size": 32, "num_epochs": 1,
             "num_gpus_per_learner": 0,
             "lr": tune.grid_search([1e-4, 3e-4])}
    results = tune.run(PPO, config=space, metric="timesteps_total",
                       mode="max", stop={"training_iteration": 2},
                       storage_path=str(tmp_path))
    assert len(results) == 2 and not results.errors
    assert results.get_best_result().metrics["training_iteration"] == 2

"""The port's MPMD pipeline trainer (``ray_tpu_torch/train/pipeline.py``)
held to the JAX package's (``ray_tpu/train/pipeline.py``) on the CPU,
stage actors on ``device="cpu"``. The cases of
``tests/test_pipeline_parallel.py`` (``:32`` the split, ``:45`` and
``:79`` the trainer against the reference, ``:96`` the refusals,
``:110`` the 1F1B stash bound, ``:129`` both schedules, ``:154`` llama
stages, ``:187`` the llama split), plus:

- MLP: the port's trainer against JAX's ``reference_train_losses`` at
  rtol = atol = 1e-4 (float32 across frameworks, as in
  ``tests/test_torch_train.py``), and against the port's own replay
  (``reference_train_losses``, the same stage math in one process) at
  the reference's 1e-5, losses and final params;
- llama (``LlamaConfig.debug()`` at 4 layers, JAX's ``init_params``
  carried over as numpy): the port's trainer under 1F1B, GPipe and
  interleaved ``virtual_stages=2`` against JAX's
  ``reference_llama_losses`` at rtol 1e-4 in float32 and 3e-3 in
  bfloat16 (the bf16 train-step bound of ``tests/test_spmd_train.py:211``);
  final params per leaf at the reference's rtol 1e-3 / atol 1e-5 in
  float32, and in bfloat16 each leaf's update (final minus initial)
  within 3e-2 of JAX's by norm, the per-leaf grad bound of
  ``chip_smoke.py`` (an SGD update is ``lr`` times the mean grad); the
  port's own replay at 1e-5;
- every stage's ``serialized_bytes`` stays 0 (the device-edge path);
- the bubble attribution: a run's pipeline busy time and bubble column
  in the goodput ledger (``tests/test_goodput.py:570``) and the trace's
  bubble against ``pipeline_stats()`` within 0.05
  (``tests/test_flight_recorder.py:533``);
- the device policy: no card and no ``device="cpu"`` raises.

Each test starts its own runtime (about 0.1 s). JAX is imported inside
the tests.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core.config import global_config
from ray_tpu_torch.train.pipeline import (
    MPMDPipelineTrainer,
    init_mlp_params,
    reference_llama_losses,
    reference_train_losses,
    split_llama_stages,
    split_stages,
)
from ray_tpu_torch.util import flight_recorder as fr
from ray_tpu_torch.util import goodput as gp

LAYERS = [8, 16, 16, 4]
CROSS_TOL = 1e-4       # float32, the port against JAX
OWN_RTOL = 1e-5        # the port's trainer against its own replay
LLAMA_BF16_RTOL = 3e-3
LEAF_UPDATE_RTOL = 3e-2
LLAMA_LAYERS = 4       # room for 2 stages x 2 virtual stages


@pytest.fixture
def runtime():
    rt.init(num_cpus=4, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()


def _data(n=32, seed=7, layers=LAYERS):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, layers[0]).astype(np.float32),
            rng.randn(n, layers[-1]).astype(np.float32))


def _no_serialized_bytes(trainer):
    for cs in trainer.channel_stats():
        assert cs["serialized_bytes"] == 0, cs
        assert cs["tensor_bytes"] > 0, cs


def wait_for(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


# --------------------------------------------------------------------------- #
# tests/test_pipeline_parallel.py
# --------------------------------------------------------------------------- #


def test_split_stages_partitioning():
    from ray_tpu.train import pipeline as jp

    params = init_mlp_params([4, 8, 8, 8, 2], seed=0)  # 4 layers
    assert [len(s) for s in split_stages(params, 2)] == [2, 2]
    assert [len(s) for s in split_stages(params, 3)] == [2, 1, 1]
    assert [len(s) for s in split_stages(params, 4)] == [1, 1, 1, 1]
    with pytest.raises(ValueError):
        split_stages(params, 5)
    flat = [w for s in split_stages(params, 3) for (w, _b) in s]
    for got, (want, _b) in zip(flat, params):
        np.testing.assert_array_equal(got, want)
    # the numpy init is the JAX package's, array for array
    for (pw, pb), (jw, jb) in zip(params,
                                  jp.init_mlp_params([4, 8, 8, 8, 2], 0)):
        np.testing.assert_array_equal(pw, jw)
        np.testing.assert_array_equal(pb, jb)


MLP_CASES = {
    # name: (layers, stages, seed, steps, microbatches, schedule, n)
    "2stage_1f1b": (LAYERS, 2, 3, 6, 4, "1f1b", 32),
    "2stage_gpipe": (LAYERS, 2, 9, 4, 4, "gpipe", 32),
    "3stage": ([6, 12, 12, 3], 3, 11, 3, 3, "1f1b", 24),
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_matches_jax_and_own_replay(runtime, case):
    """Loss-equivalence with JAX's single-process reference and the
    port's own replay, final params layer for layer, and the typed
    tensor path (serialized bytes flat at 0)."""
    from ray_tpu.train import pipeline as jp

    layers, stages, seed, steps, mb, schedule, n = MLP_CASES[case]
    x, y = _data(n=n, layers=layers)
    trainer = MPMDPipelineTrainer(layers, num_stages=stages, lr=0.05,
                                  seed=seed, schedule=schedule,
                                  device="cpu")
    try:
        losses = trainer.fit(x, y, steps=steps, num_microbatches=mb)
        got_params = trainer.get_params()
        _no_serialized_bytes(trainer)
        stats = trainer.pipeline_stats()
    finally:
        trainer.shutdown()
    jax_losses, jax_params = jp.reference_train_losses(
        layers, seed, x, y, steps=steps, num_microbatches=mb,
        num_stages=stages, lr=0.05, return_params=True)
    own_losses, own_params = reference_train_losses(
        layers, seed, x, y, steps=steps, num_microbatches=mb,
        num_stages=stages, lr=0.05, return_params=True, device="cpu")
    np.testing.assert_allclose(losses, jax_losses, rtol=CROSS_TOL,
                               atol=CROSS_TOL)
    np.testing.assert_allclose(losses, own_losses, rtol=OWN_RTOL)
    assert losses[-1] < losses[0]
    assert len(got_params) == len(jax_params) == len(own_params)
    for (gw, gb), (jw, jb), (ow, ob) in zip(got_params, jax_params,
                                            own_params):
        np.testing.assert_allclose(gw, jw, rtol=CROSS_TOL, atol=CROSS_TOL)
        np.testing.assert_allclose(gb, jb, rtol=CROSS_TOL, atol=CROSS_TOL)
        np.testing.assert_allclose(gw, ow, rtol=OWN_RTOL, atol=1e-6)
        np.testing.assert_allclose(gb, ob, rtol=OWN_RTOL, atol=1e-6)
    assert stats["microbatches_run"] == steps * mb
    assert stats["schedule"] == schedule
    assert 0.0 < stats["pipeline_efficiency"] <= 1.0
    assert stats["bubble_fraction"] == pytest.approx(
        1.0 - stats["pipeline_efficiency"], abs=1e-6)


def _refusal(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


REFUSALS = {
    "one_stage": lambda T: T(LAYERS, num_stages=1),
    "schedule": lambda T: T(LAYERS, num_stages=2, schedule="bogus"),
    "virtual_zero": lambda T: T(LAYERS, num_stages=2, virtual_stages=0),
    "virtual_gpipe": lambda T: T(LAYERS, num_stages=2, virtual_stages=2,
                                 schedule="gpipe"),
    "no_layers": lambda T: T(num_stages=2),
    "no_llama_cfg": lambda T: T(num_stages=2, model="llama"),
    "model": lambda T: T(LAYERS, num_stages=2, model="resnet"),
    "too_many_stages": lambda T: T(LAYERS, num_stages=4),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_the_reference(case):
    """The constructor refuses what the JAX package's refuses, with the
    same message, before it reserves anything."""
    from ray_tpu.train.pipeline import MPMDPipelineTrainer as JaxTrainer

    def port(*a, **kw):
        return MPMDPipelineTrainer(*a, device="cpu", **kw)

    assert _refusal(lambda: REFUSALS[case](port)) == \
        _refusal(lambda: REFUSALS[case](JaxTrainer))


def test_uneven_microbatches_refused(runtime):
    x, y = _data()
    trainer = MPMDPipelineTrainer(LAYERS, num_stages=2, seed=0,
                                  device="cpu")
    try:
        with pytest.raises(ValueError, match="does not split"):
            trainer.train_step(x, y, num_microbatches=5)  # 32 % 5 != 0
    finally:
        trainer.shutdown()


def test_1f1b_bounds_activation_stash_at_k(runtime):
    """With M >> K microbatches a step, no stage stashes more than K
    activations: the in-flight window is K and backward microbatches
    (which pop the stash) preempt forwards."""
    x, y = _data(n=48)
    trainer = MPMDPipelineTrainer(LAYERS, num_stages=2, lr=0.05, seed=5,
                                  device="cpu")
    try:
        assert trainer.schedule == "1f1b"
        assert trainer.window == 2
        trainer.fit(x, y, steps=2, num_microbatches=12)
        stats = trainer.pipeline_stats()
        assert stats["stash_max"] <= trainer.num_stages, stats
        assert stats["microbatches_run"] == 24
        _no_serialized_bytes(trainer)
        # each stage's probe: on the CPU no card, no kernel launch (the
        # plain attention runs), and no JAX or JAX package loaded
        for i, p in enumerate(rt.get([s.probe.remote(reset=True)
                                      for s in trainer.stages])):
            assert p["stage"] == i and p["device_count"] == 0, p
            assert p["launches"] == {"fwd": 0, "dq": 0, "dkv": 0}, p
            assert "torch" in p["modules"]
            assert not {"jax", "jaxlib", "ray_tpu"} & set(p["modules"]), p
    finally:
        trainer.shutdown()


# ---- llama stages ----


def _configs(dtype: str):
    import jax.numpy as jnp

    from ray_tpu.models.llama import LlamaConfig as JaxConfig
    from ray_tpu_torch.models.llama import LlamaConfig

    port = dataclasses.replace(
        LlamaConfig.debug(), n_layers=LLAMA_LAYERS,
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    ref = dataclasses.replace(
        JaxConfig.debug(), n_layers=LLAMA_LAYERS,
        dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    return port, ref


def _llama_tokens(cfg):
    rng = np.random.RandomState(2)
    return rng.randint(0, cfg.vocab_size, (8, 17)).astype(np.int32)


_JAX_LLAMA = {}


def _jax_llama(dtype: str, chunks: int):
    """JAX's init (seed 4, as numpy) and its reference run over
    ``chunks`` stages, once per module."""
    key = (dtype, chunks)
    if key not in _JAX_LLAMA:
        import jax

        from ray_tpu.models.llama import init_params
        from ray_tpu.train import pipeline as jp

        _, cfg = _configs(dtype)
        params = jax.tree_util.tree_map(
            np.asarray, init_params(cfg, jax.random.PRNGKey(4)))
        losses, final = jp.reference_llama_losses(
            cfg, 4, _llama_tokens(cfg), steps=3, num_microbatches=4,
            num_stages=chunks, lr=0.1, params=params, return_params=True)
        _JAX_LLAMA[key] = (params, losses, jax.tree_util.tree_map(
            np.asarray, final))
    return _JAX_LLAMA[key]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


LLAMA_CASES = [(dt, sched, v) for dt in ("f32", "bf16")
               for sched, v in (("1f1b", 1), ("gpipe", 1), ("1f1b", 2))]


@pytest.mark.parametrize("dtype,schedule,virtual", LLAMA_CASES,
                         ids=[f"{d}-{s}-v{v}" for d, s, v in LLAMA_CASES])
def test_llama_stages_match_jax(runtime, dtype, schedule, virtual):
    """Decoder-block stages: stage 0 owns the embedding and its blocks,
    the last stage its blocks, final_norm, lm_head and the loss. From
    JAX's init, the port's trainer matches JAX's in-process replay loss
    for loss and param for param, and the port's own replay, with zero
    serialized bytes on the stages."""
    cfg, _ = _configs(dtype)
    chunks = 2 * virtual
    init, jax_losses, jax_final = _jax_llama(dtype, chunks)
    tokens = _llama_tokens(cfg)
    trainer = MPMDPipelineTrainer(num_stages=2, lr=0.1, model="llama",
                                  llama_cfg=cfg, params=init,
                                  schedule=schedule, virtual_stages=virtual,
                                  device="cpu")
    try:
        losses = trainer.fit(tokens, steps=3, num_microbatches=4)
        got = trainer.get_params()
        _no_serialized_bytes(trainer)
        stats = trainer.pipeline_stats()
    finally:
        trainer.shutdown()
    own_losses, own_final = reference_llama_losses(
        cfg, 4, tokens, steps=3, num_microbatches=4, num_stages=chunks,
        lr=0.1, params=init, return_params=True, device="cpu")
    rtol = CROSS_TOL if dtype == "f32" else LLAMA_BF16_RTOL
    np.testing.assert_allclose(losses, jax_losses, rtol=rtol)
    np.testing.assert_allclose(losses, own_losses, rtol=OWN_RTOL)
    assert losses[-1] < losses[0]  # it actually trains
    if schedule == "1f1b":
        assert stats["stash_max"] <= 2 * virtual, stats
    starts = split_llama_stages(cfg, init, chunks)
    assert len(got) == len(jax_final) == chunks
    for g_tree, j_tree, o_tree, s_tree in zip(got, jax_final, own_final,
                                              starts):
        j_leaves, o_leaves = dict(_paths(j_tree)), dict(_paths(o_tree))
        s_leaves = dict(_paths(s_tree))
        assert set(dict(_paths(g_tree))) == set(j_leaves)
        for path, g in _paths(g_tree):
            np.testing.assert_allclose(g, o_leaves[path], rtol=OWN_RTOL,
                                       atol=1e-6, err_msg=path)
            if dtype == "f32":
                np.testing.assert_allclose(g, j_leaves[path], rtol=1e-3,
                                           atol=1e-5, err_msg=path)
            else:
                want = j_leaves[path] - s_leaves[path]
                err = np.linalg.norm((g - s_leaves[path]) - want)
                assert err <= LEAF_UPDATE_RTOL * np.linalg.norm(want), \
                    (path, err, np.linalg.norm(want))


def test_seeded_init_is_the_replays(runtime):
    """``params=None``: each stage makes its slices of the port's seeded
    init on its own device; the in-process replay from the same seed
    gives the same losses and params."""
    cfg, _ = _configs("f32")
    tokens = _llama_tokens(cfg)
    trainer = MPMDPipelineTrainer(num_stages=2, lr=0.1, seed=5,
                                  model="llama", llama_cfg=cfg,
                                  device="cpu")
    try:
        losses = trainer.fit(tokens, steps=2, num_microbatches=2)
        got = trainer.get_params()
    finally:
        trainer.shutdown()
    want, final = reference_llama_losses(
        cfg, 5, tokens, steps=2, num_microbatches=2, num_stages=2,
        lr=0.1, return_params=True, device="cpu")
    np.testing.assert_allclose(losses, want, rtol=OWN_RTOL)
    for g_tree, w_tree in zip(got, final):
        w_leaves = dict(_paths(w_tree))
        for path, g in _paths(g_tree):
            np.testing.assert_allclose(g, w_leaves[path], rtol=OWN_RTOL,
                                       atol=1e-6, err_msg=path)


def test_llama_stage_split_validation():
    import jax

    from ray_tpu.models.llama import LlamaConfig as JaxConfig
    from ray_tpu.models.llama import init_params
    from ray_tpu.train import pipeline as jp
    from ray_tpu_torch.models.llama import Llama, LlamaConfig

    cfg, jcfg = LlamaConfig.debug(), JaxConfig.debug()
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    stages = split_llama_stages(cfg, params, 2)
    assert "embedding" in stages[0] and "embedding" not in stages[1]
    assert "lm_head" in stages[-1] and "final_norm" in stages[-1]
    assert sum(s["layers"]["wq"].shape[0] for s in stages) == cfg.n_layers
    # the same slices as the JAX package's split
    for got, want in zip(stages, jp.split_llama_stages(jcfg, params, 2)):
        got, want = dict(_paths(got)), dict(_paths(want))
        assert set(got) == set(want)
        for path in got:
            np.testing.assert_array_equal(got[path], want[path])
    # the port's model splits into the same leaves as tensors
    from ray_tpu_torch.models.llama import params_from_numpy

    model = params_from_numpy(cfg, params, device="cpu")
    for got, want in zip(split_llama_stages(cfg, model, 2), stages):
        want = dict(_paths(want))
        for path, t in _paths(got):
            assert isinstance(t, torch.Tensor)
            np.testing.assert_array_equal(t.numpy(), want[path])
    assert isinstance(model, Llama)
    tied = dataclasses.replace(cfg, vocab_size=64, dim=16, n_heads=2,
                               n_kv_heads=1, mlp_dim=32,
                               tie_embeddings=True)
    jtied = dataclasses.replace(jcfg, vocab_size=64, dim=16, n_heads=2,
                                n_kv_heads=1, mlp_dim=32,
                                tie_embeddings=True)
    tied_params = jax.tree_util.tree_map(
        np.asarray, init_params(jtied, jax.random.PRNGKey(0)))
    assert _refusal(lambda: split_llama_stages(tied, tied_params, 2)) == \
        _refusal(lambda: jp.split_llama_stages(jtied, tied_params, 2))
    assert _refusal(lambda: split_llama_stages(cfg, params, 3)) == \
        _refusal(lambda: jp.split_llama_stages(jcfg, params, 3))


# --------------------------------------------------------------------------- #
# Observability: the bubble attribution
# --------------------------------------------------------------------------- #


@pytest.fixture
def fast_recorder():
    """Spans of every length, reported every 300 ms (set before the
    runtime starts, so its workers adopt them)."""
    cfg = global_config()
    saved = (cfg.flight_recorder_min_span_us,
             cfg.flight_recorder_report_interval_ms)
    cfg.flight_recorder_min_span_us = 0.0
    cfg.flight_recorder_report_interval_ms = 300
    saved_min = fr._min_dur[0]
    fr.configure(min_span_us=0.0)
    rt.init(num_cpus=4, num_gpus=0)
    try:
        fr.reset_for_tests()  # driver ring: this run only
        yield
    finally:
        rt.shutdown()
        (cfg.flight_recorder_min_span_us,
         cfg.flight_recorder_report_interval_ms) = saved
        fr.configure(min_span_us=saved_min)


def _pipe_spans(head) -> int:
    n = 0
    for chunks in head.flight_spans.values():
        for p in chunks:
            tbl = {int(k): v["name"] for k, v in p["names"].items()}
            n += sum(1 for r in p["events"]
                     if tbl.get(r[1], "").startswith("pipe."))
    return n


def test_mpmd_run_attributes_bubble(fast_recorder):
    """A 2-stage run lands pipeline productive time AND a bubble column
    in the goodput ledger with a non-null fraction."""
    from ray_tpu_torch.core.runtime import get_current_runtime

    rng = np.random.RandomState(11)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 8).astype(np.float32)
    steps, mb = 3, 2
    trainer = MPMDPipelineTrainer([8, 16, 8], num_stages=2, lr=0.05,
                                  seed=5, device="cpu")
    try:
        trainer.fit(x, y, steps=steps, num_microbatches=mb)
        head = get_current_runtime().head
        wait_for(lambda: _pipe_spans(head) >= 3 * steps * mb,
                 msg="pipeline spans reported to head")
        rep = gp.goodput_report(head)
        assert rep["steps"] == steps
        assert rep["goodput_s"] > 0
        assert rep["goodput_fraction"] is not None
        assert rep["badput_s"]["bubble"] >= 0.0
        assert f"{steps} steps" in gp.format_goodput(rep)
    finally:
        trainer.shutdown()


def test_trace_attribution_matches_pipeline_stats(fast_recorder):
    """The merged trace of a 2-stage run, folded into the per-step
    budget, gives a bubble fraction within 0.05 of the trainer's own
    ``pipeline_stats()``."""
    from ray_tpu_torch.core.runtime import get_current_runtime

    layers = [16, 64, 64, 8]
    rng = np.random.RandomState(7)
    x = rng.randn(32, layers[0]).astype(np.float32)
    y = rng.randn(32, layers[-1]).astype(np.float32)
    steps, mb = 5, 4
    trainer = MPMDPipelineTrainer(layers, num_stages=2, lr=0.05, seed=3,
                                  device="cpu")
    try:
        trainer.fit(x, y, steps=steps, num_microbatches=mb)
        stats = trainer.pipeline_stats()
        head = get_current_runtime().head
        # each microbatch yields 3 stage-side spans (stage-0 fwd + bwd,
        # the last stage's fused loss_bwd)
        want = 3 * steps * mb
        wait_for(lambda: _pipe_spans(head) >= want,
                 msg=f"{want} pipeline spans reported")
        report = fr.attribute_trace(
            fr.cluster_trace(head, include_tasks=False))
        assert report["steps"] == steps
        assert report["num_stages"] == 2
        assert report["bubble_fraction"] is not None
        assert abs(report["bubble_fraction"]
                   - stats["bubble_fraction"]) <= 0.05, (report, stats)
        assert report["pipeline_busy_s"] > 0
    finally:
        trainer.shutdown()


# --------------------------------------------------------------------------- #
# Device policy
# --------------------------------------------------------------------------- #


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    x, y = _data()
    cfg, _ = _configs("f32")
    for make in (lambda: MPMDPipelineTrainer(LAYERS),
                 lambda: MPMDPipelineTrainer(num_stages=2, model="llama",
                                             llama_cfg=cfg),
                 lambda: reference_train_losses(LAYERS, 0, x, y, 1, 2, 2),
                 lambda: reference_llama_losses(
                     cfg, 0, _llama_tokens(cfg), 1, 2, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()

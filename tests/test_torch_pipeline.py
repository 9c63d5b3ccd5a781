"""Port parity: pipeline parallelism of ray_tpu_torch against ray_tpu, on
the CPU — the GPipe schedule (``parallel/pipeline.py``) and the pipeline
train step (``models/llama.py:make_pipeline_train_step``).

The port runs in 4 gloo ranks through ``train/launch.py``, every job of
this file in one launch, while JAX runs here on its virtual 8-device CPU
mesh (the same layouts, on 4 of its devices). Inputs are made with numpy
or JAX from a seed; the JAX params are exported as numpy and carried into
the port.

Tolerances (tests/test_pipeline_moe.py's own):
- the schedule's outputs against JAX's ``pipelined_apply`` on the same
  affine and tanh stages: rtol = atol = 1e-5; their grads: rtol 1e-4,
  atol 1e-5;
- the pipeline step's losses against JAX's ``make_pipeline_train_step``
  on exported params: rtol = atol = 2e-3 (its bound against the serial
  loss), float32; the first step's grads, leaf by leaf, against JAX's
  grads of the serial loss (the function the pipelined one computes):
  rtol = atol = 1e-4 (tests/test_torch_spmd.py's float32 grad bound).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import make_mesh
from ray_tpu.parallel.pipeline import (merge_microbatches, pipelined_apply,
                                       split_microbatches)
from ray_tpu.util.jax_compat import shard_map
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import pipeline as tp
from ray_tpu_torch.train.launch import launch
from ray_tpu_torch.train.spmd_runs import (pipeline_schedule, rank_programs,
                                           train_jobs)

WORLD = 4
TIMEOUT = 240
STEPS = 4
# tests/test_pipeline_moe.py's llama (float32, unchunked loss)
JCFG = jl.LlamaConfig(vocab_size=128, dim=32, n_layers=4, n_heads=4,
                      n_kv_heads=2, mlp_dim=64, max_seq_len=64, remat=False,
                      dtype=jnp.float32, loss_chunk=0)
# (mesh, microbatches, remat, tied embeddings)
LAYOUTS = (("pipe=4", 4, False, False), ("pipe=2,tensor=2", 2, True, False),
           ("pipe=4", 4, False, True), ("pipe=2,tensor=2", 2, True, True))
LAYOUT_IDS = [f"{m}-M{n}" + ("-remat" if r else "") + ("-tied" if t else "")
              for m, n, r, t in LAYOUTS]
# (mesh, layers): JAX's two refusals
REFUSED = (("data=4", 4), ("pipe=4", 6))


def _cfgs(remat=False, tie=False, **kw):
    jcfg = dataclasses.replace(JCFG, remat=remat, tie_embeddings=tie, **kw)
    tcfg = tl.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)
                             if f.name != "dtype"}, dtype=torch.float32)
    return jcfg, tcfg


def _mesh_sizes(spec):
    return {a: int(n) for a, n in (p.split("=") for p in spec.split(","))}


def _jax_mesh(spec):
    return make_mesh(axis_sizes=_mesh_sizes(spec))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _schedule_cases():
    """tests/test_pipeline_moe.py's two schedules: P 4, M 8 affine-tanh
    stages; P 2, M 4 tanh stages (the second on a data=2 x pipe=2 mesh,
    so every rank is in it)."""
    ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 16, 16))
                    * 0.3)
    bs = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 16)) * 0.1)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16, 16)))
    w2 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 8, 8)) * 0.3)
    x2 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 8)))
    return [dict(mesh="pipe=4", w=ws, b=bs, x=x, M=8),
            dict(mesh="data=2,pipe=2", w=w2, x=x2, M=4)]


def _jax_schedule(case):
    """JAX's pipelined_apply on the case's stages, and the grads of
    sum(out ** 2) in w, b and x."""
    P = case["w"].shape[0]
    mesh = make_mesh(axis_sizes={"pipe": P})
    has_b = case.get("b") is not None

    def stage_fn(p, act):
        return jnp.tanh(act @ p[0] + p[1]) if has_b else jnp.tanh(act @ p[0])

    def region(stacked, batch):
        local = jax.tree.map(lambda a: a[0], stacked)
        return merge_microbatches(pipelined_apply(
            stage_fn, local, split_microbatches(batch, case["M"])))

    specs = (JP("pipe"), JP("pipe")) if has_b else (JP("pipe"),)
    fn = shard_map(region, mesh=mesh, in_specs=(specs, JP(None)),
                   out_specs=JP(None), check=False)
    params = (case["w"], case["b"]) if has_b else (case["w"],)
    out = fn(params, case["x"])
    grads = jax.grad(lambda p, x: jnp.sum(fn(p, x) ** 2),
                     argnums=(0, 1))(params, case["x"])
    return {"out": np.asarray(out), "w": np.asarray(grads[0][0]),
            "b": np.asarray(grads[0][1]) if has_b else None,
            "x": np.asarray(grads[1])}


def _jax_step(jcfg, mesh, microbatches, tokens):
    """The exported [L, ...] params of JAX's pipeline step and its losses
    over STEPS steps."""
    init, step, ds, _ = jl.make_pipeline_train_step(
        jcfg, _jax_mesh(mesh), num_microbatches=microbatches)
    state = init(jax.random.PRNGKey(0))
    tree = {k: (jax.tree.map(lambda a: np.asarray(a).reshape(
        (jcfg.n_layers,) + a.shape[2:]), v) if k == "layers"
        else np.asarray(v)) for k, v in jax.device_get(
            state["params"]).items()}
    toks = jax.device_put(tokens, ds)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, toks)
        losses.append(float(loss))
    return tree, losses


@pytest.fixture(scope="module")
def runs():
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (8, 33),
                                           0, 128)).astype(np.int32)
    trees, want, jgrads, jobs = {}, {}, {}, []
    for layout in LAYOUTS:
        mesh, m, remat, tie = layout
        jcfg, tcfg = _cfgs(remat, tie)
        trees[layout], want[layout] = _jax_step(jcfg, mesh, m, tokens)
        jobs.append(dict(cfg=tcfg, mesh=mesh, step="pipeline",
                         microbatches=m, init=trees[layout], tokens=tokens,
                         steps=STEPS, grads=list(tl.param_shapes(tcfg))))
    for mesh, layers in REFUSED:
        jobs.append(dict(cfg=_cfgs(n_layers=layers)[1], mesh=mesh,
                         step="pipeline", microbatches=4, tokens=tokens))
    cases = _schedule_cases()
    calls = [(pipeline_schedule, cases), (train_jobs, jobs)]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch, rank_programs, WORLD, (calls, "cpu"),
                           device="cpu", timeout=TIMEOUT)
        want_schedule = [_jax_schedule(c) for c in cases]
        for layout in LAYOUTS:
            jcfg, _ = _cfgs(layout[2], layout[3])
            jgrads[layout] = _flat(jax.tree.map(np.asarray, jax.jit(
                jax.grad(lambda p: jl.loss_fn(jcfg, p, jnp.asarray(
                    tokens))))(trees[layout])))
        refusals = []
        for mesh, layers in REFUSED:
            with pytest.raises(ValueError) as e:
                jl.make_pipeline_train_step(_cfgs(n_layers=layers)[0],
                                            _jax_mesh(mesh), 4)
            refusals.append(str(e.value))
        reports = port.result()
    return {"cases": cases, "want_schedule": want_schedule,
            "schedule": [[rank[0][i] for rank in reports]
                         for i in range(len(cases))],
            "steps": {layout: [rank[1][i] for rank in reports]
                      for i, layout in enumerate(LAYOUTS)},
            "want": want, "jgrads": jgrads, "refusals": refusals,
            "refused": [r.get("rejected") for r in reports[0][1][-2:]]}


@pytest.mark.parametrize("case", [0, 1], ids=["P4-affine", "P2-tanh"])
def test_schedule_matches_jax_pipelined_apply(runs, case):
    want = runs["want_schedule"][case]
    P = runs["cases"][case]["w"].shape[0]
    stages = {}
    for rep in runs["schedule"][case]:
        np.testing.assert_allclose(rep["out"], want["out"], rtol=1e-5,
                                   atol=1e-5)
        stages.setdefault(rep["stage"], rep)
        if rep["stage"] == 0:
            np.testing.assert_allclose(rep["x"], want["x"], rtol=1e-4,
                                       atol=1e-5)
        else:
            assert rep["x"] is None
    assert sorted(stages) == list(range(P))
    for s, rep in stages.items():
        np.testing.assert_allclose(rep["w"], want["w"][s], rtol=1e-4,
                                   atol=1e-5)
        if want["b"] is not None:
            np.testing.assert_allclose(rep["b"], want["b"][s], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_pipeline_step_losses_match_jax_and_fall(runs, layout):
    reps = runs["steps"][layout]
    rep = reps[0]
    assert rep["mesh"] == _mesh_sizes(layout[0])
    np.testing.assert_allclose(rep["losses"], runs["want"][layout],
                               rtol=2e-3, atol=2e-3)
    assert np.isfinite(rep["losses"]).all()
    assert rep["losses"][-1] < rep["losses"][0], rep["losses"]
    for other in reps[1:]:
        assert other["losses"] == rep["losses"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_pipeline_step_first_grads_match_jax(runs, layout):
    """Leaf by leaf, the tied embedding included: its head part, which
    every stage computes alike, and its lookup part, which only stage 0
    has, each counted once."""
    rep = runs["steps"][layout][0]
    got, want = rep["grads"], runs["jgrads"][layout]
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=1e-4, atol=1e-4,
                                   err_msg=path)
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in want.values()))
    np.testing.assert_allclose(rep["grad_norm"], norm, rtol=1e-4)


def test_pipeline_step_refuses_what_jax_refuses(runs):
    assert runs["refused"] == runs["refusals"]
    assert runs["refusals"][0] == "mesh has no 'pipe' axis"


def test_microbatch_split_and_merge_match_jax():
    x = np.arange(48, dtype=np.float32).reshape(8, 3, 2)
    tree = {"x": x, "pos": x[..., 0].astype(np.int32)}
    want = split_microbatches(tree, 4)
    got = tp.split_microbatches({k: torch.from_numpy(v)
                                 for k, v in tree.items()}, 4)
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        assert np.array_equal(tp.merge_microbatches(got)[k].numpy(), tree[k])
    msgs = []
    for split, arr in ((split_microbatches, x),
                       (tp.split_microbatches, torch.from_numpy(x))):
        with pytest.raises(ValueError) as e:
            split(arr, 3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert tp.num_ticks(16, 4) == 19
    assert tp.stage_slice_len(16, 4) == 4
    with pytest.raises(ValueError, match="not divisible into 4 stages"):
        tp.stage_slice_len(6, 4)

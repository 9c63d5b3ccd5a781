"""Port parity: sequence parallelism of ray_tpu_torch against ray_tpu, on
the CPU — ring attention (``parallel/ring_attention.py``) and the
seq-sharded mesh step (``train/spmd.py:make_mesh_train_step``).

The port runs in 4 gloo ranks through ``train/launch.py``, every job of
this file in one launch, while JAX runs here on its virtual 8-device CPU
mesh. Inputs are made with numpy from a seed; the JAX params are
exported as numpy and carried into the port.

Tolerances:
- ring attention, output and q/k/v grads, against JAX's ring_attention
  on ``MeshConfig(seq=4, tensor=2)`` and its ``jax.grad``, float32: rtol
  = atol = 2e-4 (tests/test_parallel.py's ring bound); the no-``seq``
  fallback against JAX's (its plain attention) at the same bound;
- the port's ring in one process (``ring_attention_simulated``, the same
  per-rank loops with a list for the transport) against its ring over
  gloo: bitwise (the same float32 ops in the same order);
- the mesh step's two losses against JAX's GSPMD make_train_step on the
  same layout: rtol 1e-4 in float32, 3e-3 in bfloat16
  (tests/test_spmd_train.py's train-step bound); the layouts against
  each other: rtol 2e-3 (tests/test_llama.py's layout bound); the first
  step's grads, leaf by leaf, against JAX's grads of the same global
  batch, float32: rtol = atol = 1e-4.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.parallel.ring_attention import ring_attention as jax_ring
from ray_tpu.train import spmd as js
from ray_tpu.util.jax_compat import ensure_sharding_invariant_rng
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops.flash_attention import flash_attention_reference
from ray_tpu_torch.parallel.ring_attention import ring_attention_simulated
from ray_tpu_torch.train.launch import launch
from ray_tpu_torch.train.spmd_runs import (rank_programs, ring_jobs,
                                           train_jobs)

WORLD = 4
TIMEOUT = 240
RING_MESHES = ("seq=4", "seq=2,tensor=2")
# (name, B, T, Hq, Hkv, D): JAX's ring test shape, and GQA K/V (the model
# path carries them unrepeated; JAX repeats them first)
RING_SHAPES = (("mha", 2, 32, 4, 4, 16), ("gqa", 2, 32, 4, 2, 16))
SEQ_LAYOUTS = ("seq=4", "fsdp=2,seq=2", "seq=2,tensor=2")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-3)}


def _cfgs(name):
    jdt, tdt, _ = DTYPES[name]
    return (dataclasses.replace(jl.LlamaConfig.debug(), dtype=jdt),
            dataclasses.replace(tl.LlamaConfig.debug(), dtype=tdt))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _ring_inputs(B, T, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(B, T, h, D).astype(np.float32)
            for n, h in (("q", Hq), ("k", Hkv), ("v", Hkv), ("r", Hq))}


def _ring_cases():
    """(key, job) pairs: every ring mesh, shape and causal setting, then
    the fallback on a mesh without ``seq``."""
    cases = []
    for shape in RING_SHAPES:
        inputs = _ring_inputs(*shape[1:], seed=0)
        for mesh in RING_MESHES:
            for causal in (True, False):
                cases.append(((shape[0], mesh, causal),
                              dict(mesh=mesh, causal=causal, **inputs)))
    cases.append((("fallback", "data=2,tensor=2", True),
                  dict(mesh="data=2,tensor=2", causal=True,
                       **_ring_inputs(2, 16, 4, 4, 8, seed=1))))
    return cases


def _jax_ring(job):
    """JAX's ring attention and its q/k/v grads of sum(o * r), GQA K/V
    repeated as JAX's model does; the fallback on JAX's data=4,tensor=2
    mesh, as tests/test_parallel.py runs it."""
    if "seq" in job["mesh"]:
        mesh = make_mesh(MeshConfig(data=1, fsdp=1, seq=4, tensor=2))
    else:
        mesh = make_mesh(MeshConfig(data=4, tensor=2))
    rep = job["q"].shape[2] // job["k"].shape[2]

    def out(q, k, v):
        k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        return jax_ring(q, k, v, mesh, causal=job["causal"])

    def loss(q, k, v):
        return jnp.sum(out(q, k, v) * job["r"])

    args = (job["q"], job["k"], job["v"])
    o = jax.jit(out)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return [np.asarray(x) for x in (o, *grads)]


@pytest.fixture(scope="module")
def runs():
    ensure_sharding_invariant_rng()
    ring = _ring_cases()
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jl.init_params(_cfgs("f32")[0], k))(jax.random.PRNGKey(0)))
    tokens = np.random.RandomState(0).randint(
        0, 256, (8, 33)).astype(np.int32)
    steps = []
    for name in DTYPES:
        _, tcfg = _cfgs(name)
        for mesh in SEQ_LAYOUTS:
            steps.append(dict(cfg=tcfg, mesh=mesh, step="mesh", init=tree,
                              tokens=tokens, steps=2,
                              grads=list(tl.param_shapes(tcfg))
                              if name == "f32" else ()))
    steps.append(dict(cfg=_cfgs("f32")[1], mesh="seq=2,pipe=2", step="mesh",
                      tokens=tokens))
    calls = [(ring_jobs, [job for _, job in ring]), (train_jobs, steps)]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch, rank_programs, WORLD, (calls, "cpu"),
                           device="cpu", timeout=TIMEOUT)
        want_ring = {key: _jax_ring(job) for key, job in ring}
        want_step = {}
        for name in DTYPES:
            jcfg, _ = _cfgs(name)
            for mesh in SEQ_LAYOUTS:
                init, step, ds, _ = jl.make_train_step(
                    jcfg, js.build_train_mesh(mesh,
                                              devices=jax.devices()[:WORLD]))
                state = init(jax.random.PRNGKey(0))
                for a, b in zip(jax.tree.leaves(tree),
                                jax.tree.leaves(state["params"])):
                    assert np.array_equal(a, np.asarray(b))
                toks = jax.device_put(tokens, ds)
                state, l1 = step(state, toks)
                _, l2 = step(state, toks)
                want_step[name, mesh] = [float(l1), float(l2)]
        jcfg, _ = _cfgs("f32")
        jgrads = jax.jit(jax.grad(lambda p: jl.loss_fn(
            jcfg, p, jnp.asarray(tokens))))(tree)
        reports = port.result()
    got_ring = {key: [rank[0][i] for rank in reports]
                for i, (key, _) in enumerate(ring)}
    got_step = {(name, mesh): [rank[1][i] for rank in reports]
                for i, (name, mesh) in enumerate(
                    (n, m) for n in DTYPES for m in SEQ_LAYOUTS)}
    return {"ring": ring, "got_ring": got_ring, "want_ring": want_ring,
            "got_step": got_step, "want_step": want_step,
            "jgrads": _flat(jax.tree.map(np.asarray, jgrads)),
            "refused": reports[0][1][-1]}


def _ring_whole(reps, job):
    """Every output and grad of the port's ring, reassembled from the
    ranks' shards (replicas must agree bit for bit)."""
    out = []
    for name, like in (("o", "q"), ("dq", "q"), ("dk", "k"), ("dv", "k")):
        shape = job[like].shape
        whole = np.full(shape, np.nan, np.float32)
        hq, hkv = job["q"].shape[2], job["k"].shape[2]
        for rep in reps:
            (b0, b1), (t0, t1), (h0, h1) = rep["bounds"][:3]
            if like == "k":
                h0, h1 = h0 * hkv // hq, h1 * hkv // hq
            part = whole[b0:b1, t0:t1, h0:h1]
            assert np.isnan(part).all() or np.array_equal(part, rep[name]), \
                name
            whole[b0:b1, t0:t1, h0:h1] = rep[name]
        assert not np.isnan(whole).any(), name
        out.append(whole)
    return out


@pytest.mark.parametrize("key", [key for key, _ in _ring_cases()],
                         ids=["-".join(map(str, key))
                              for key, _ in _ring_cases()])
def test_ring_attention_and_grads_match_jax(runs, key):
    job = dict(runs["ring"])[key]
    got = _ring_whole(runs["got_ring"][key], job)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got,
                          runs["want_ring"][key]):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{key} {name}")


@pytest.mark.parametrize("shape", RING_SHAPES, ids=[s[0] for s in RING_SHAPES])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_in_one_process_is_the_ring_over_ranks(runs, shape, causal):
    """The per-rank loops driven in lockstep with a list for the
    transport (what chip_smoke's seq_ring phase runs on one card) give
    the gloo ring's values bit for bit; their merged lse is the whole
    sequence's (float32, rtol = atol = 1e-5)."""
    key = (shape[0], "seq=4", causal)
    job = dict(runs["ring"])[key]
    got = _ring_whole(runs["got_ring"][key], job)
    t = {n: torch.from_numpy(job[n]) for n in ("q", "k", "v", "r")}
    o, lse, grads = ring_attention_simulated(t["q"], t["k"], t["v"], 4,
                                             causal, do=t["r"])
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads), got):
        assert np.array_equal(g.numpy(), w), name
    _, whole_lse = flash_attention_reference(t["q"], t["k"], t["v"], causal)
    torch.testing.assert_close(lse, whole_lse, rtol=1e-5, atol=1e-5)


def test_ring_refuses_unequal_blocks():
    x = torch.zeros(1, 30, 2, 16)
    with pytest.raises(ValueError, match="does not split"):
        ring_attention_simulated(x, x, x, 4)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("mesh", SEQ_LAYOUTS)
def test_mesh_step_losses_match_jax_gspmd_step(runs, name, mesh):
    reps = runs["got_step"][name, mesh]
    assert reps[0]["mesh"] == dict(
        (a, int(n)) for a, n in (p.split("=") for p in mesh.split(",")))
    np.testing.assert_allclose(reps[0]["losses"],
                               runs["want_step"][name, mesh],
                               rtol=DTYPES[name][2])
    for rep in reps[1:]:
        assert rep["losses"] == reps[0]["losses"]


@pytest.mark.parametrize("name", list(DTYPES))
def test_seq_layouts_agree_with_each_other(runs, name):
    losses = [runs["got_step"][name, m][0]["losses"] for m in SEQ_LAYOUTS]
    for other in losses[1:]:
        np.testing.assert_allclose(other, losses[0], rtol=2e-3)


@pytest.mark.parametrize("mesh", SEQ_LAYOUTS)
def test_mesh_step_first_grads_match_jax(runs, mesh):
    rep = runs["got_step"]["f32", mesh][0]
    got, want = rep["grads"], runs["jgrads"]
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=1e-4, atol=1e-4,
                                   err_msg=path)
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in want.values()))
    np.testing.assert_allclose(rep["grad_norm"], norm, rtol=1e-4)


def test_mesh_step_refuses_a_pipe_axis(runs):
    assert "live 'pipe' axis" in runs["refused"]["rejected"]
    assert "make_pipeline_train_step" in runs["refused"]["rejected"]

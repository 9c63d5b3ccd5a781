"""Port parity: expert parallelism of ray_tpu_torch against ray_tpu, on
the CPU — MoE routing and the expert FFN (``ops/moe.py``), the
differentiable all-to-all (``collective/collective.py``), the MoE decoder
and its single-card step (``models/moe_llama.py``) and the MoE mesh step
(``train/spmd.py:make_moe_train_step``) with live ``expert``, ``tensor``
and ``seq`` axes: routing over a row split across ``seq`` ranks, the
expert FFN under ``seq`` and under ``tensor``, and the step on every
layout JAX's ``moe_llama.make_train_step`` takes but ``pipe``.

Set-up: MoEConfig.debug() on both sides (4 experts, top 2), the JAX
params exported as numpy and carried into the port, token ids and every
other input made with numpy from a seed. The port's ranks are 4 gloo
processes through ``train/launch.py``; the mesh jobs of this file run in
one launch while JAX runs here on its virtual 8-device CPU mesh.

Tolerances:
- routing against JAX's ``top_k_routing``: dispatch exactly equal (the
  routing decisions), combine and aux within 1e-6; the experts each
  token chose in every layer of the decoder, against JAX's and, on every
  mesh layout, against the single-card step's: exactly equal;
- ``expert_capacity``: exact;
- ``moe_ffn`` values and input/weight grads, float32: rtol = atol = 1e-5
  (the JAX suite's exact-fallback bound, tests/test_flash_attention.py);
- the all-to-all and the expert-parallel FFN against the unsharded
  exchange and function, values and grads, float32: 1e-6; the same for
  the FFN under ``seq`` (the ranks' dispatches add zeros to disjoint
  slots); 1e-5 under ``tensor`` (its row-parallel sum changes the order:
  the exact-fallback bound);
- routing over a row split across ``seq`` ranks against JAX's
  ``top_k_routing`` on the whole row: dispatch exactly equal, combine and
  the ranks' mean aux within 1e-6;
- the decoder's logits and aux, first-step grads leaf by leaf and
  two-step losses against JAX's ``moe_llama``: rtol 1e-4 in float32
  (atol 1e-4 for the grads), 3e-3 in bfloat16 (tests/test_spmd_train.py's
  train-step bound);
- the mesh layouts' two-step losses against JAX's ``make_train_step`` on
  the same layout, and their first-step grads leaf by leaf against JAX's
  grads of the same global batch, float32: rtol 1e-4 (grads: rtol =
  atol = 1e-4).
"""

import concurrent.futures
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe_llama as jm
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel.sharding import logical_spec as jax_logical_spec
from ray_tpu.train import spmd as js
from ray_tpu.util.jax_compat import ensure_sharding_invariant_rng
from ray_tpu_torch.models import moe_llama as tm
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.train import spmd as ts
from ray_tpu_torch.train.launch import launch
from ray_tpu_torch.train.spmd_runs import (expert_parallel_cases,
                                           moe_jobs)

WORLD = 4
# seconds a launch may take before its ranks are killed; bounds each test
TIMEOUT = 240
LAYOUTS = [("expert=4", "streamed"), ("data=2,expert=2", "streamed"),
           ("fsdp=2,expert=2", "streamed"), ("fsdp=2,expert=2", "upfront"),
           # tensor inside each expert, and rows split over seq
           ("data=2,tensor=2", "streamed"), ("expert=2,tensor=2", "streamed"),
           ("fsdp=2,tensor=2", "streamed"), ("seq=4", "streamed"),
           ("seq=2,expert=2", "streamed"), ("seq=2,tensor=2", "streamed"),
           ("fsdp=2,seq=2", "streamed")]
LAYOUT_IDS = [f"{m}-{g}" for m, g in LAYOUTS]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-3)}
# (G, S, E, top_k, capacity_factor, tied): capacity drops at 1.0 and
# 1.25, none at 4; tied logits make argmax ties
ROUTING_CASES = [(2, 16, 4, 2, 1.25, False), (3, 32, 8, 2, 1.0, False),
                 (2, 24, 4, 1, 1.25, False), (1, 40, 8, 3, 4.0, False),
                 (2, 16, 4, 2, 1.25, True), (2, 32, 8, 2, 1.0, True)]
# the all-to-all's exchanges: ep 2 (two groups) and ep 4, two and three
# rows a chunk
A2A_CASES = [("data=2,expert=2", 2), ("expert=4", 2), ("expert=4", 3)]
FFN_MESHES = ["data=2,expert=2", "expert=4"]
# the FFN under seq 2 and 4, tensor 2, and tensor inside each expert
SHARDED_FFN_MESHES = ["data=2,seq=2", "seq=4", "data=2,tensor=2",
                      "expert=2,tensor=2"]
# the seq-split routing: every routing case over seq 2 and 4
SEQ_ROUTING = [(mesh, case) for mesh in ("data=2,seq=2", "seq=4")
               for case in ROUTING_CASES]


def _cfgs(name="f32", **kw):
    jdt, tdt, _ = DTYPES[name]
    return (dataclasses.replace(jm.MoEConfig.debug(), dtype=jdt, **kw),
            dataclasses.replace(tm.MoEConfig.debug(), dtype=tdt, **kw))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _jax_mesh(spec):
    return js.build_train_mesh(spec, devices=jax.devices()[:WORLD])


def _jax_choices(logits, top_k):
    """The experts JAX's top_k_routing picks (its repeated argmax over
    the softmax, each pick zeroed), [G, S, top_k]."""
    remaining = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    picks = []
    for _ in range(top_k):
        idx = jnp.argmax(remaining, axis=-1)
        picks.append(idx)
        remaining = remaining * (1.0 - jax.nn.one_hot(
            idx, logits.shape[-1], dtype=jnp.float32))
    return np.stack([np.asarray(p) for p in picks], -1)


def _routing_logits(G, S, E, tied, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(G, S, E).astype(np.float32)
    if tied:
        # two-level logits: most rows tie at their top one or two experts
        logits = (logits > 0.3).astype(np.float32)
    return logits


# --------------------------------------------------------------------------- #
# routing and the expert FFN, one process
# --------------------------------------------------------------------------- #


def test_expert_capacity_matches_jax():
    for S in (1, 7, 16, 100, 2048):
        for E in (1, 4, 8, 16):
            for k in (1, 2, 3):
                for cf in (0.5, 1.0, 1.25, 2.0):
                    assert tmoe.expert_capacity(S, E, k, cf) \
                        == jmoe.expert_capacity(S, E, k, cf), (S, E, k, cf)


@pytest.mark.parametrize("G,S,E,k,cf,tied", ROUTING_CASES)
def test_top_k_routing_matches_jax(G, S, E, k, cf, tied):
    logits = _routing_logits(G, S, E, tied)
    C = jmoe.expert_capacity(S, E, k, cf)
    jd, jc, ja = jmoe.top_k_routing(jnp.asarray(logits), E, k, C)
    td, tc, ta = tmoe.top_k_routing(torch.from_numpy(logits), E, k, C)
    # the routing decisions first, exactly: experts, slots, drops
    np.testing.assert_array_equal(
        tmoe.expert_choices(torch.softmax(torch.from_numpy(logits), -1),
                            k).numpy(), _jax_choices(jnp.asarray(logits), k))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    assert not td.requires_grad


@pytest.mark.parametrize("G,S,E,k,cf,tied", ROUTING_CASES[:3])
def test_routing_invariants(G, S, E, k, cf, tied):
    """tests/test_pipeline_moe.py's invariants, on the port's function."""
    C = tmoe.expert_capacity(S, E, k, cf)
    d, c, aux = tmoe.top_k_routing(
        torch.from_numpy(_routing_logits(G, S, E, tied, seed=1)), E, k, C)
    d, c = d.numpy(), c.numpy()
    assert d.sum(axis=(2, 3)).max() <= k + 1e-6  # at most k slots a token
    assert d.sum(axis=1).max() <= 1 + 1e-6  # at most a token a slot
    w = c.sum(axis=(2, 3))
    full = d.sum(axis=(2, 3)) >= k - 1e-6
    np.testing.assert_allclose(w[full], 1.0, atol=1e-5)
    assert np.isfinite(float(aux)) and float(aux) > 0


def _ffn_inputs(B=2, S=16, d=16, E=4, f=32, seed=0):
    rng = np.random.RandomState(seed)

    def r(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"x": r(B, S, d), "router": r(d, E, scale=0.5),
            "w_gate": r(E, d, f, scale=0.2), "w_up": r(E, d, f, scale=0.2),
            "w_down": r(E, f, d, scale=0.2), "r": r(B, S, d)}


WEIGHTS = ("router", "w_gate", "w_up", "w_down")


def _jax_ffn_grads(inp, k, cf, aux_coef=0.5):
    def f(x, *w):
        y, aux = jmoe.moe_ffn(x, *w, top_k=k, capacity_factor=cf,
                              compute_dtype=jnp.float32)
        return jnp.sum(y * inp["r"]) + aux_coef * aux, (y, aux)

    args = [jnp.asarray(inp[n]) for n in ("x",) + WEIGHTS]
    grads, (y, aux) = jax.grad(f, argnums=tuple(range(5)), has_aux=True)(
        *args)
    return np.asarray(y), float(aux), dict(zip(("x",) + WEIGHTS,
                                               map(np.asarray, grads)))


@pytest.mark.parametrize("k,cf", [(2, 1.25), (2, 4.0), (1, 1.0)])
def test_moe_ffn_values_and_grads_match_jax(k, cf):
    inp = _ffn_inputs()
    y_j, aux_j, g_j = _jax_ffn_grads(inp, k, cf)
    t = {n: torch.tensor(inp[n], requires_grad=True)
         for n in ("x",) + WEIGHTS}
    y, aux = tmoe.moe_ffn(t["x"], *(t[n] for n in WEIGHTS), top_k=k,
                          capacity_factor=cf, compute_dtype=torch.float32)
    ((y * torch.from_numpy(inp["r"])).sum() + 0.5 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), y_j, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.item(), aux_j, rtol=1e-5, atol=1e-5)
    for n, g in g_j.items():
        np.testing.assert_allclose(t[n].grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5, err_msg=n)


# --------------------------------------------------------------------------- #
# the decoder and its single-card step
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_tree():
    ensure_sharding_invariant_rng()
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0)))


def _tokens(B=8, T=33, seed=0):
    return np.random.RandomState(seed).randint(
        0, tm.MoEConfig.debug().vocab_size, (B, T)).astype(np.int32)


def test_config_and_shapes_match_jax(jax_tree):
    for preset in ("debug", "small"):
        jcfg = getattr(jm.MoEConfig, preset)()
        tcfg = getattr(tm.MoEConfig, preset)()
        for field in dataclasses.fields(jcfg):
            if field.name != "dtype":
                assert getattr(tcfg, field.name) == getattr(jcfg,
                                                            field.name)
        assert tcfg.num_params() == jcfg.num_params()
        assert tm.param_logical_axes(tcfg) == jm.param_logical_axes(jcfg)
    assert tm.MoEConfig.small().num_params() == 294_611_712
    tcfg = _cfgs()[1]
    assert {p: a.shape for p, a in _flat(jax_tree).items()} \
        == tm.param_shapes(tcfg)
    # a seeded init is the JAX init's distribution on the same leaves
    model = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for path, p in model.named_parameters():
        if path.endswith("norm"):
            assert bool((p == 1).all()), path
        else:
            std = float(p.detach().std()) * np.sqrt(p.shape[-2] if path
                                           != "embedding" else tcfg.dim)
            assert 0.8 < std < 1.2, path


def test_params_from_numpy_checks_paths_and_shapes(jax_tree):
    tcfg = _cfgs()[1]
    model = tm.params_from_numpy(tcfg, jax_tree, "cpu")
    assert isinstance(model, tm.MoELlama)
    got = {n.replace(".", "/"): p.detach().numpy()
           for n, p in model.named_parameters()}
    for path, leaf in _flat(jax_tree).items():
        assert got[path].tobytes() == leaf.tobytes(), path
    bad = {**jax_tree, "layers": {**jax_tree["layers"]}}
    del bad["layers"]["router"]
    with pytest.raises(ValueError, match="do not match"):
        tm.params_from_numpy(tcfg, bad, "cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_forward_with_aux_matches_jax(jax_tree, remat):
    jcfg, tcfg = _cfgs(remat=remat)
    tokens = _tokens(4, 32)
    j_logits, j_aux = jm.forward_with_aux(jcfg, jax_tree,
                                          jnp.asarray(tokens))
    model = tm.params_from_numpy(tcfg, jax_tree, "cpu")
    with torch.enable_grad():
        logits, aux = tm.forward_with_aux(tcfg, model.tree(),
                                          torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-4)


def test_routing_of_every_layer_matches_jax(jax_tree, monkeypatch):
    """The experts each token chose in each layer's forward, exactly:
    JAX's layers run eagerly (no scan) so its router logits can be read."""
    jcfg, tcfg = _cfgs()
    tokens = _tokens(4, 32)
    seen = {"jax": [], "port": []}
    j_route, t_choices = jmoe.top_k_routing, tmoe.expert_choices

    def j_rec(logits, E, k, C):
        seen["jax"].append(_jax_choices(logits, k))
        return j_route(logits, E, k, C)

    def t_rec(probs, k):
        picks = t_choices(probs, k)
        seen["port"].append(picks.numpy())
        return picks

    monkeypatch.setattr(jmoe, "top_k_routing", j_rec)
    monkeypatch.setattr(tmoe, "expert_choices", t_rec)
    B, T = tokens.shape
    x = jm.embed_tokens(jcfg, jax_tree, jnp.asarray(tokens), None)
    positions = jnp.arange(T, dtype=jnp.int32)[None, :].repeat(B, axis=0)
    for i in range(jcfg.n_layers):
        x, _ = jm._layer(jcfg, None, x, jax.tree.map(
            lambda a: a[i], jax_tree["layers"]), positions)
    model = tm.params_from_numpy(tcfg, jax_tree, "cpu")
    with torch.no_grad():
        tm.forward_with_aux(tcfg, model.tree(),
                            torch.from_numpy(tokens).long())
    assert len(seen["jax"]) == len(seen["port"]) == jcfg.n_layers
    for layer, (j, t) in enumerate(zip(seen["jax"], seen["port"])):
        np.testing.assert_array_equal(t, j, err_msg=f"layer {layer}")


def _jax_grads(jcfg, tree, tokens):
    return _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jm.loss_fn(jcfg, p, jnp.asarray(tokens))))(tree)))


@pytest.mark.parametrize("remat", [False, True])
def test_first_step_grads_match_jax_leaf_by_leaf(jax_tree, remat):
    jcfg, tcfg = _cfgs(remat=remat)
    tokens = _tokens()
    want = _jax_grads(jcfg, jax_tree, tokens)
    j_loss = float(jm.loss_fn(jcfg, jax_tree, jnp.asarray(tokens)))
    model = tm.params_from_numpy(tcfg, jax_tree, "cpu")
    loss = tm.loss_fn(tcfg, model.tree(), torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    got = {n.replace(".", "/"): p.grad.numpy()
           for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=1e-4, atol=1e-4,
                                   err_msg=path)


def _jax_step_losses(jcfg, tree, tokens, spec, steps=2):
    mesh = _jax_mesh(spec)
    init, step, ds, _ = jm.make_train_step(jcfg, mesh)
    state = init(jax.random.PRNGKey(0))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(state["params"])):
        assert np.array_equal(a, np.asarray(b))
    toks = jax.device_put(tokens, ds)
    losses = []
    for _ in range(steps):
        state, loss = step(state, toks)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name", list(DTYPES))
def test_two_step_losses_match_jax(jax_tree, name):
    jcfg, tcfg = _cfgs(name)
    tokens = _tokens()
    want = _jax_step_losses(jcfg, jax_tree, tokens, "data=1")
    init, step = tm.make_train_step(tcfg, device="cpu")
    state = init(jax_tree)
    got = [float(step(state, torch.from_numpy(tokens))) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=DTYPES[name][2])
    assert state["step"] == 2


def test_partition_rules_mirror_the_logical_axes():
    """The MoE rule table, leaf by leaf, restricted to a mesh, is JAX's
    DEFAULT_RULES through param_logical_axes on that mesh (padded with
    None to the leaf's rank), on meshes with fsdp, expert and tensor."""
    tcfg = _cfgs()[1]
    shapes = tm.param_shapes(tcfg)
    sample = ts._nest({p: torch.empty(s, device="meta")
                       for p, s in shapes.items()})
    rules = _flat(ts.match_partition_rules(ts.moe_partition_rules(),
                                           sample))
    for spec in ("fsdp=2,expert=2", "fsdp=2,tensor=2", "expert=2,tensor=2"):
        jmesh = _jax_mesh(spec)
        names = tuple(js.parse_mesh_spec(spec))
        mesh = SimpleNamespace(mesh_dim_names=names, shape=(2, 2))
        for path, axes in _flat(tm.param_logical_axes(tcfg)).items():
            want = tuple(jax_logical_spec(axes, jmesh))
            want += (None,) * (len(shapes[path]) - len(want))
            got = tuple(ts._restrict_spec(rules[path], mesh))
            got += (None,) * (len(shapes[path]) - len(got))
            assert got == want, (spec, path)


# --------------------------------------------------------------------------- #
# the exchange and the mesh step on 4 gloo ranks
# --------------------------------------------------------------------------- #


def _a2a_case(mesh, rows, seed=0):
    ep = int(mesh.split("expert=")[1])
    rng = np.random.RandomState(seed)
    return {"kind": "all_to_all", "mesh": mesh, "ep": ep, "rows": rows,
            "x": rng.randn(ep, ep * rows, 3).astype(np.float32),
            "r": rng.randn(ep, ep * rows, 3).astype(np.float32)}


def _ffn_case(mesh, S=16):
    return {"kind": "moe_ffn", "mesh": mesh, "top_k": 2,
            "capacity_factor": 1.25, "aux_coef": 0.5,
            **_ffn_inputs(B=4, S=S, E=4)}


def _routing_case(mesh, G, S, E, k, cf, tied):
    return {"kind": "routing", "mesh": mesh, "top_k": k,
            "capacity_factor": cf, "logits": _routing_logits(G, S, E, tied)}


def _mesh_jobs(tree, tokens):
    _, tcfg = _cfgs()
    leaves = list(tm.param_shapes(tcfg))
    jobs = [dict(cfg=tcfg, mesh="", init=tree, tokens=tokens, steps=2,
                 grads=leaves)]
    jobs += [dict(cfg=tcfg, mesh=mesh, gather=gather, init=tree,
                  tokens=tokens, steps=2, grads=leaves)
             for mesh, gather in LAYOUTS]
    # the refusals: pipe (JAX's MoE has no pipeline schedule), E % ep, an
    # MoE config in a Llama step, and the Llama steps refusing expert
    from ray_tpu_torch.models import llama as tl

    odd = dataclasses.replace(tcfg, num_experts=3)
    llama_cfg = dataclasses.replace(tl.LlamaConfig.debug(),
                                    dtype=torch.float32)
    jobs += [dict(cfg=tcfg, mesh="pipe=2,expert=2", tokens=tokens),
             dict(cfg=odd, mesh="expert=4", tokens=tokens),
             dict(cfg=tcfg, mesh="fsdp=4", step="spmd", tokens=tokens),
             dict(cfg=llama_cfg, mesh="data=2,expert=2", step="spmd",
                  tokens=tokens),
             dict(cfg=llama_cfg, mesh="data=2,expert=2", step="mesh",
                  tokens=tokens),
             dict(cfg=llama_cfg, mesh="pipe=2,expert=2", step="pipeline",
                  microbatches=1, tokens=tokens)]
    return jobs


N_REFUSED = 6


def _port_runs(tree, tokens):
    # S 32: capacity 20, which seq 2 and 4 divide
    cases = [_a2a_case(m, n) for m, n in A2A_CASES] \
        + [_ffn_case(m) for m in FFN_MESHES] \
        + [_ffn_case(m, S=32) for m in SHARDED_FFN_MESHES] \
        + [_routing_case(m, *c) for m, c in SEQ_ROUTING]
    jobs = _mesh_jobs(tree, tokens)
    from ray_tpu_torch.train.spmd_runs import rank_programs

    out = launch(rank_programs, WORLD,
                 ([(moe_jobs, jobs), (expert_parallel_cases, cases)],
                  "cpu"), device="cpu", timeout=TIMEOUT)
    return {"jobs": jobs, "reports": [r[0] for r in out],
            "cases": cases, "exchange": [r[1] for r in out]}


@pytest.fixture(scope="module")
def runs(jax_tree):
    tokens = _tokens()
    jcfg, tcfg = _cfgs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, jax_tree, tokens)
        want = {mesh: _jax_step_losses(jcfg, jax_tree, tokens, mesh)
                for mesh in dict.fromkeys(m for m, _ in LAYOUTS)}
        jgrads = _jax_grads(jcfg, jax_tree, tokens)
        # the single-card step's routing, for the layouts to match
        seen = []
        choices = tmoe.expert_choices

        def rec(probs, k):
            picks = choices(probs, k)
            if len(seen) < tcfg.n_layers:
                seen.append(picks.numpy())
            return picks

        tmoe.expert_choices = rec
        try:
            init, step = tm.make_train_step(tcfg, device="cpu")
            single = [float(step(init(jax_tree), torch.from_numpy(tokens)))]
        finally:
            tmoe.expert_choices = choices
        result = port.result()
    result.update(want=want, jgrads=jgrads, routing=np.stack(seen),
                  single_loss=single[0])
    return result


def _report(runs, mesh, gather):
    for i, job in enumerate(runs["jobs"]):
        if job["mesh"] == mesh and job.get("gather", "streamed") == gather:
            return [rank[i] for rank in runs["reports"]]
    raise KeyError((mesh, gather))


@pytest.mark.parametrize("mesh,gather", LAYOUTS, ids=LAYOUT_IDS)
def test_mesh_two_step_losses_match_jax(runs, mesh, gather):
    reps = _report(runs, mesh, gather)
    assert reps[0]["gather"] == (gather if "fsdp" in mesh else "upfront")
    np.testing.assert_allclose(reps[0]["losses"], runs["want"][mesh],
                               rtol=1e-4)
    np.testing.assert_allclose(reps[0]["losses"][0], runs["single_loss"],
                               rtol=1e-4)
    for rep in reps[1:]:
        assert rep["losses"] == reps[0]["losses"]


@pytest.mark.parametrize("mesh,gather", LAYOUTS + [("", "streamed")],
                         ids=LAYOUT_IDS + ["data=4"])
def test_mesh_first_step_grads_match_jax(runs, mesh, gather):
    rep = _report(runs, mesh, gather)[0]
    want = runs["jgrads"]
    assert set(rep["grads"]) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(rep["grads"][path], g, rtol=1e-4,
                                   atol=1e-4, err_msg=path)
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in want.values()))
    np.testing.assert_allclose(rep["grad_norm"], norm, rtol=1e-4)


@pytest.mark.parametrize("mesh,gather", LAYOUTS, ids=LAYOUT_IDS)
def test_mesh_routing_equals_the_single_card_step(runs, mesh, gather):
    """Each rank's tokens chose the experts the single-card step's did;
    the ranks' blocks (rows, and positions under seq) cover the global
    batch once, apart from the copies a tensor group holds, which route
    alike (their picks' checksums agree)."""
    reps = _report(runs, mesh, gather)
    rows, T = _tokens().shape
    blocks = {}
    for rep in reps:
        (r0, r1), (p0, p1) = rep["rows"], rep["positions"]
        np.testing.assert_array_equal(
            rep["routing"], runs["routing"][:, r0:r1, p0:p1], err_msg=mesh)
        blocks.setdefault((r0, r1, p0, p1), []).append(rep)
        sums = rep["tensor_checksums"]
        if "tensor" in mesh:
            assert len(sums) == 2 and sums[0] == sums[1], sums
        else:
            assert sums is None
    copies = 2 if "tensor" in mesh else 1
    assert all(len(b) == copies for b in blocks.values())
    covered = np.zeros((rows, T - 1), int)
    for r0, r1, p0, p1 in blocks:
        covered[r0:r1, p0:p1] += 1
    assert (covered == 1).all()


def test_expert_leaves_stay_sharded_over_expert(runs):
    """Expert leaves split over ``expert`` and are never gathered over
    it: the step's analytic residency counts an fsdp-gathered working
    copy of the rank's E/ep experts, and every other leaf whole."""
    from ray_tpu_torch.parallel.sharding import param_residency_bytes

    _, tcfg = _cfgs()
    mesh = SimpleNamespace(mesh_dim_names=("fsdp", "expert"), shape=(2, 2))
    sample, specs = ts.spmd_param_specs(tcfg, mesh)
    assert tuple(specs["layers"]["w_gate"]) == (None, "expert", "fsdp",
                                                None)
    assert tuple(specs["layers"]["router"]) == (None, "fsdp", None)
    rep = _report(runs, "fsdp=2,expert=2", "upfront")[0]
    assert rep["residency"] == param_residency_bytes(sample, specs, mesh)
    shapes = tm.param_shapes(tcfg)
    whole = sum(int(np.prod(s)) * 4 for p, s in shapes.items()
                if "/w_" not in p)
    experts = sum(int(np.prod(s)) * 4 for p, s in shapes.items()
                  if "/w_" in p)
    assert rep["residency"]["gathered_bytes"] == whole + experts // 2


def test_moe_step_refuses_what_is_not_ported(runs):
    msgs = [r.get("rejected") for r in runs["reports"][0][-N_REFUSED:]]
    assert all(msgs), msgs
    assert "live 'pipe' axis" in msgs[0]
    assert "MoE step has no pipeline schedule" in msgs[0]
    assert msgs[1] == ("expert axis size 4 does not divide "
                       "cfg.num_experts=3")
    assert "make_moe_train_step" in msgs[2]


def test_llama_steps_still_refuse_expert(runs):
    msgs = [r.get("rejected") for r in runs["reports"][0][-3:]]
    for step, msg in zip(("make_spmd_train_step", "make_mesh_train_step",
                          "make_pipeline_train_step"), msgs):
        assert msg is not None and msg.startswith(step), msg
        assert "live 'expert' axis" in msg
        assert "moe" in msg.lower()
        assert "not ported yet" not in msg


@pytest.mark.parametrize("mesh,rows", A2A_CASES,
                         ids=[f"{m}-{n}rows" for m, n in A2A_CASES])
def test_all_to_all_values_and_grads(runs, mesh, rows):
    """Rank j receives, in rank order, chunk j of every rank's x; the
    grad of rank j's chunk k is what rank k's cotangent holds for it:
    chunk j of r[k]. At ep 4 a wrong backward (one that does not send
    each chunk home) is told apart from the right one."""
    i_case = A2A_CASES.index((mesh, rows))
    case = runs["cases"][i_case]
    ep = case["ep"]

    def chunk(a, i):
        return a[i * rows:(i + 1) * rows]

    for rank, rep in enumerate(runs["exchange"]):
        j = rank % ep  # the expert axis is the minor one in both meshes
        want = np.concatenate([chunk(case["x"][i], j) for i in range(ep)])
        np.testing.assert_allclose(rep[i_case]["out"], want, rtol=1e-6,
                                   atol=1e-6)
        grad = np.concatenate([chunk(case["r"][k], j) for k in range(ep)])
        np.testing.assert_allclose(rep[i_case]["x"], grad, rtol=1e-6,
                                   atol=1e-6)


def _assemble(reps, key, whole, *dims, add=False):
    """The ranks' blocks of ``key`` laid into an array shaped as
    ``whole``: ``dims`` pairs a dim with the block that cuts it; a block
    two ranks share must hold the same values, unless ``add`` (each
    rank's part of a sum)."""
    out = np.zeros_like(whole)
    seen = {}
    for rep in reps:
        at = [slice(None)] * whole.ndim
        for dim, what in dims:
            at[dim] = slice(*rep["block"][what])
        at = tuple(at)
        if add:
            out[at] += rep[key]
            continue
        where = tuple((s.start, s.stop) for s in at)
        if where in seen:
            np.testing.assert_array_equal(rep[key], seen[where],
                                          err_msg=key)
        seen[where] = rep[key]
        out[at] = rep[key]
    return out


def _check_sharded_ffn(runs, i_case, tol):
    """A moe_ffn case against the unsharded function: the first group of
    ranks (every axis but expert, seq and tensor at 0) reassembled — y
    and x's grad by block, the router's grad summed over the blocks of
    rows and positions, an expert weight's grad by its experts and mlp
    columns and summed over seq, aux averaged over expert and seq."""
    case = runs["cases"][i_case]
    t = {n: torch.tensor(case[n], requires_grad=True)
         for n in ("x",) + WEIGHTS}
    y, aux = tmoe.moe_ffn(t["x"], *(t[n] for n in WEIGHTS), top_k=2,
                          capacity_factor=1.25, compute_dtype=torch.float32)
    ((y * torch.from_numpy(case["r"])).sum() + 0.5 * aux).backward()
    sizes = js.parse_mesh_spec(case["mesh"])
    n = int(np.prod([sizes.get(a, 1) for a in ("expert", "seq", "tensor")]))
    reps = [rank[i_case] for rank in runs["exchange"]][:n]
    rows = (0, "rows"), (1, "positions")
    tol = dict(rtol=tol, atol=tol)
    np.testing.assert_allclose(_assemble(reps, "y", case["x"], *rows),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(_assemble(reps, "x", case["x"], *rows),
                               t["x"].grad.numpy(), **tol)
    first = [r for r in reps if r["block"]["mlp"][0] == 0]
    np.testing.assert_allclose(sum(r["router"] for r in first),
                               t["router"].grad.numpy(), **tol)
    for name, mlp in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        np.testing.assert_allclose(
            _assemble(reps, name, case[name], (0, "experts"), (mlp, "mlp"),
                      add=True), t[name].grad.numpy(), **tol, err_msg=name)
    np.testing.assert_allclose(np.mean([r["aux"] for r in first]),
                               float(aux), **tol)


@pytest.mark.parametrize("mesh", FFN_MESHES)
def test_expert_parallel_ffn_matches_the_unsharded_function(runs, mesh):
    _check_sharded_ffn(runs, len(A2A_CASES) + FFN_MESHES.index(mesh), 1e-6)


@pytest.mark.parametrize("mesh", SHARDED_FFN_MESHES)
def test_seq_and_tensor_ffn_match_the_unsharded_function(runs, mesh):
    """Under seq the ranks' dispatches fill disjoint slots (1e-6); under
    tensor the row-parallel sum changes the order (1e-5)."""
    i_case = len(A2A_CASES) + len(FFN_MESHES) \
        + SHARDED_FFN_MESHES.index(mesh)
    _check_sharded_ffn(runs, i_case, 1e-5 if "tensor" in mesh else 1e-6)


@pytest.mark.parametrize("mesh,G,S,E,k,cf,tied",
                         [(m, *c) for m, c in SEQ_ROUTING])
def test_seq_split_routing_matches_jax_on_the_whole_row(runs, mesh, G, S,
                                                        E, k, cf, tied):
    """Each seq rank routes its block of the row; laid side by side, the
    blocks are JAX's routing of the whole row: the same slots and drops
    (choice-major across ranks), and the ranks' mean aux is JAX's."""
    i_case = len(A2A_CASES) + len(FFN_MESHES) + len(SHARDED_FFN_MESHES) \
        + SEQ_ROUTING.index((mesh, (G, S, E, k, cf, tied)))
    logits = _routing_logits(G, S, E, tied)
    C = jmoe.expert_capacity(S, E, k, cf)
    jd, jc, ja = (np.asarray(a) for a in jmoe.top_k_routing(
        jnp.asarray(logits), E, k, C))
    R = js.parse_mesh_spec(mesh)["seq"]
    reps = [rank[i_case] for rank in runs["exchange"]][:R]
    np.testing.assert_array_equal(
        _assemble(reps, "dispatch", jd, (1, "positions")), jd)
    np.testing.assert_allclose(
        _assemble(reps, "combine", jc, (1, "positions")), jc, rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(np.mean([r["aux"] for r in reps]), float(ja),
                               rtol=1e-6, atol=1e-6)


def test_batch_must_split_over_expert():
    _, tcfg = _cfgs()
    rows = np.zeros((3, 9), np.int32)  # 3 rows do not split over 2
    with pytest.raises(RuntimeError, match="does not split over expert"):
        launch(moe_jobs, 2, ([dict(cfg=tcfg, mesh="expert=2",
                                   tokens=rows)], "cpu"),
               device="cpu", timeout=TIMEOUT)


def test_mesh_entry_delegates_and_refuses_on_the_cpu():
    """moe_llama.make_train_step with no mesh is the single-card step;
    the MoE step takes only an MoE config."""
    from ray_tpu_torch.models import llama as tl

    _, tcfg = _cfgs()
    init, _ = tm.make_train_step(tcfg, device="cpu")
    assert isinstance(init(0)["params"], tm.MoELlama)
    with pytest.raises(TypeError, match="MoEConfig"):
        ts.make_moe_train_step(tl.LlamaConfig.debug(), None, device="cpu")

"""Port parity: the sharded train step of ray_tpu_torch.train.spmd against
ray_tpu.train.spmd, on the CPU.

Set-up: LlamaConfig.debug() on both sides, the JAX params exported as
numpy and carried into the port, token ids made with numpy from a seed.
The port runs in 4 gloo ranks through ``train/launch.py`` (one launch
runs every layout's jobs, while JAX runs here on its virtual 8-device CPU
mesh); JAX's step runs on a mesh of the same layout.

Tolerances:
- two-step losses against JAX's make_spmd_train_step on the same layout:
  rtol 1e-4 in float32 (the same float32 arithmetic in another order),
  3e-3 in bfloat16 (tests/test_spmd_train.py's train-step bound);
- the layouts against each other: rtol 2e-3 (its mesh-layout bound);
- the first step's grads, leaf by leaf, and the global grad norm against
  JAX's grads of the same global batch, float32: rtol = atol = 1e-4;
- the tensor-parallel helpers against their unsharded functions, float32:
  rtol = atol = 1e-5 (a wrong factor of the tensor size is far outside);
- shard → gather, seeded init across layouts, the analytic residency and
  the rules: exact.
"""

import concurrent.futures
import dataclasses
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel.sharding import param_residency_bytes
from ray_tpu.train import spmd as js
from ray_tpu.util.jax_compat import ensure_sharding_invariant_rng
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel.mesh import P
from ray_tpu_torch.train import spmd as ts
from ray_tpu_torch.train.launch import launch, loaded_modules
from ray_tpu_torch.train.spmd_runs import tp_helpers, train_jobs

WORLD = 4
# seconds a launch may take before its ranks are killed; bounds each test
TIMEOUT = 240
LAYOUTS = [("fsdp=4", "upfront"), ("fsdp=4", "streamed"),
           ("data=2,fsdp=2", "upfront"), ("data=2,fsdp=2", "streamed"),
           ("fsdp=2,tensor=2", "streamed")]
LAYOUT_IDS = [f"{m}-{g}" for m, g in LAYOUTS]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-3)}
DEEP = 6  # layers of the schedule and residency jobs
DEEP_LAYOUTS = [(m, g) for m in ("fsdp=4", "fsdp=2,tensor=2")
                for g in ("upfront", "streamed")]
SEEDED_MESHES = ("fsdp=4", "data=2,fsdp=2", "fsdp=2,tensor=2", "data=4")
# the tied-embedding branch (the embedding is also the head): fsdp-gathered
# and vocab-parallel at once
TIED_MESH = "fsdp=2,tensor=2"
SEED = 7


def _cfgs(name, **kw):
    jdt, tdt, _ = DTYPES[name]
    return (dataclasses.replace(jl.LlamaConfig.debug(), dtype=jdt, **kw),
            dataclasses.replace(tl.LlamaConfig.debug(), dtype=tdt, **kw))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _jax_mesh(spec):
    return js.build_train_mesh(spec, devices=jax.devices()[:WORLD])


def _port_runs(tree, tied_tree, tokens):
    """Every port job of this file in one 4-rank launch, then the
    tensor-parallel helpers in another."""
    jobs = []
    for name in DTYPES:
        _, tcfg = _cfgs(name)
        for mesh, gather in LAYOUTS:
            jobs.append(dict(cfg=tcfg, mesh=mesh, gather=gather, init=tree,
                             tokens=tokens, steps=2, params=name == "f32",
                             grads=list(tl.param_shapes(tcfg))
                             if name == "f32" else ()))
        _, tied = _cfgs(name, tie_embeddings=True)
        jobs.append(dict(cfg=tied, mesh=TIED_MESH, init=tied_tree,
                         tokens=tokens, steps=2,
                         grads=list(tl.param_shapes(tied))
                         if name == "f32" else ()))
    _, tcfg = _cfgs("f32")
    for mesh in SEEDED_MESHES:
        jobs.append(dict(cfg=tcfg, mesh=mesh, init=SEED, tokens=tokens,
                         steps=0, params=True))
    _, deep = _cfgs("f32", n_layers=DEEP)
    for mesh, gather in DEEP_LAYOUTS:
        jobs.append(dict(cfg=deep, mesh=mesh, gather=gather, init=SEED,
                         tokens=tokens, steps=1))
    bad = dataclasses.replace(tcfg, n_heads=3, n_kv_heads=3)
    jobs += [dict(cfg=bad, mesh="fsdp=2,tensor=2", tokens=tokens),
             dict(cfg=tcfg, mesh="data=2,seq=2", tokens=tokens),
             dict(cfg=tcfg, mesh="fsdp=4", gather="eager", tokens=tokens)]
    reports = launch(train_jobs, WORLD, (jobs, "cpu"), device="cpu",
                     timeout=TIMEOUT)
    tp = launch(tp_helpers, WORLD, (_tp_inputs(), "cpu"), device="cpu",
                timeout=TIMEOUT)
    return jobs, reports, tp


def _tp_inputs():
    cfg = _cfgs("f32")[1]
    rng = np.random.RandomState(5)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    B, T, d, V = 2, 8, cfg.dim, cfg.vocab_size
    return {"cfg": cfg, "x": r(B, T, d), "r": r(B, T, d),
            "w1": r(d, cfg.mlp_dim) / 8, "w2": r(cfg.mlp_dim, d) / 8,
            "emb": r(V, d), "head": r(d, V) / 8,
            "tokens": rng.randint(0, V, (B, T)),
            "targets": rng.randint(0, V, (B, T))}


@pytest.fixture(scope="module")
def runs():
    ensure_sharding_invariant_rng()
    jcfg, _ = _cfgs("f32")
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jl.init_params(jcfg, k))(jax.random.PRNGKey(0)))
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (8, 33)).astype(np.int32)
    tied_jcfg, _ = _cfgs("f32", tie_embeddings=True)
    tied_tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jl.init_params(tied_jcfg, k))(jax.random.PRNGKey(0)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, tree, tied_tree, tokens)
        want = {}
        for name in DTYPES:
            runs_of = [(_cfgs(name)[0], tree, mesh, gather)
                       for mesh, gather in LAYOUTS]
            runs_of.append((_cfgs(name, tie_embeddings=True)[0], tied_tree,
                            TIED_MESH, "streamed"))
            for jcfg, init_tree, mesh, gather in runs_of:
                init, step, ds, _ = js.make_spmd_train_step(
                    jcfg, _jax_mesh(mesh), donate=False, gather=gather)
                state = init(jax.random.PRNGKey(0))
                for a, b in zip(jax.tree.leaves(init_tree),
                                jax.tree.leaves(state["params"])):
                    assert np.array_equal(a, np.asarray(b))
                toks = jax.device_put(tokens, ds)
                state, l1 = step(state, toks)
                _, l2 = step(state, toks)
                want[name, mesh, gather, jcfg.tie_embeddings] = [
                    float(l1), float(l2)]
        jgrads = {}
        for tied, init_tree in ((False, tree), (True, tied_tree)):
            jcfg, _ = _cfgs("f32", tie_embeddings=tied)
            jgrads[tied] = _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda p: jl.loss_fn(jcfg, p, jnp.asarray(tokens))))(
                    init_tree)))
        jobs, reports, tp = port.result()
    index = {}
    for i, (job, rep) in enumerate(zip(jobs, reports[0])):
        if "rejected" not in rep:
            index[job["cfg"].dtype, job["cfg"].n_layers, job["mesh"],
                  job.get("gather", "streamed"),
                  isinstance(job.get("init"), int),
                  job["cfg"].tie_embeddings] = i
    return {"tree": tree, "want": want, "reports": reports,
            "index": index, "jgrads": jgrads, "tp": tp}


def _index(runs, name, mesh, gather, layers=2, seeded=False, tied=False):
    return runs["index"][DTYPES[name][1], layers, mesh, gather, seeded,
                         tied]


def _report(runs, *key, **kw):
    return runs["reports"][0][_index(runs, *key, **kw)]


# --------------------------------------------------------------------------- #
# rules and mesh specs (no ranks needed)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("preset", ["debug", "llama3_1b"])
def test_partition_rules_match_jax_leaf_by_leaf(preset):
    jcfg = getattr(jl.LlamaConfig, preset)()
    tcfg = getattr(tl.LlamaConfig, preset)()
    jparams = jax.eval_shape(lambda: jl.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    want = _flat(jax.tree.map(
        tuple, js.match_partition_rules(js.llama_partition_rules(), jparams),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    sample = ts._nest({p: torch.empty(s, device="meta")
                       for p, s in tl.param_shapes(tcfg).items()})
    got = _flat(ts.match_partition_rules(ts.llama_partition_rules(),
                                         sample))
    assert {k: tuple(v) for k, v in got.items()} == want
    assert _flat(ts.tree_paths(sample)) == {p: p for p in got}


def test_logical_specs_match_jax_and_the_rule_table():
    """DEFAULT_RULES through logical_spec, leaf by leaf: JAX's spec, and
    the rule table's (padded with None to the leaf's rank)."""
    from types import SimpleNamespace

    from ray_tpu.parallel.sharding import logical_spec as jax_logical_spec
    from ray_tpu_torch.parallel.sharding import logical_spec

    jmesh = _jax_mesh("fsdp=2,tensor=2")
    mesh = SimpleNamespace(mesh_dim_names=("fsdp", "tensor"))
    cfg = tl.LlamaConfig.debug()
    shapes = tl.param_shapes(cfg)
    sample = ts._nest({p: torch.empty(s, device="meta")
                       for p, s in shapes.items()})
    rules = _flat(ts.match_partition_rules(ts.llama_partition_rules(),
                                           sample))
    for path, axes in _flat(tl.param_logical_axes(cfg)).items():
        got = tuple(logical_spec(axes, mesh))
        assert got == tuple(jax_logical_spec(axes, jmesh)), path
        pad = (None,) * (len(shapes[path]) - len(rules[path]))
        assert got == tuple(rules[path]) + pad, path


def test_unmatched_leaf_raises_the_jax_error():
    from jax.sharding import PartitionSpec as JP

    tree = {"blocks": {"wq_new": np.zeros((4, 4), np.float32)}}
    errors = []
    for mod, spec in ((js, JP), (ts, P)):
        rules = ((r"layers/w(q|k|v)$", spec(None, "fsdp", "tensor")),
                 (r"norm$", spec()))
        with pytest.raises(ValueError) as e:
            mod.match_partition_rules(rules, tree)
        errors.append(str(e.value))
    assert errors[1] == errors[0]
    assert "blocks/wq_new" in errors[1]
    assert ts.match_partition_rules((), {"s": np.float32(1.0)})["s"] == P()


def test_mesh_specs_parse_and_raise_as_jax():
    from ray_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from ray_tpu_torch.parallel.mesh import MeshConfig

    for kw, n in ((dict(tensor=2), 8), (dict(data=2, fsdp=-1, seq=-1), 8),
                  (dict(data=2, fsdp=2), 8)):
        assert MeshConfig(**kw).resolved(n) == JaxMeshConfig(**kw).resolved(n)
    with pytest.raises(ValueError, match="incompatible"):
        MeshConfig(data=3).resolved(8)
    assert ts.parse_mesh_spec("data=4,fsdp=2") == {"data": 4, "fsdp": 2}
    assert ts.parse_mesh_spec("") == {}
    for spec, world in (("data:4", None), ("bogus=2", 8), ("data=64", 8)):
        msgs = []
        for call in (lambda: js.build_train_mesh(spec),
                     lambda: ts.build_train_mesh(spec, world_size=world)):
            with pytest.raises(ValueError) as e:
                call()
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0], spec


# --------------------------------------------------------------------------- #
# the sharded step on 4 gloo ranks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", ["fsdp=4", "data=2,fsdp=2"])
def test_shard_then_gather_is_byte_identical(runs, mesh):
    got = _flat(_report(runs, "f32", mesh, "streamed")["params"])
    want = _flat(runs["tree"])
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].tobytes() == np.asarray(leaf).tobytes(), path


def test_seeded_init_is_the_same_on_every_layout(runs):
    tcfg = _cfgs("f32")[1]
    model = tl.init_params(tcfg, torch.Generator().manual_seed(SEED), "cpu")
    want = {n.replace(".", "/"): p.detach().numpy()
            for n, p in model.named_parameters()}
    for mesh in SEEDED_MESHES:
        got = _flat(_report(runs, "f32", mesh, "streamed",
                            seeded=True)["params"])
        assert set(got) == set(want)
        for path, leaf in want.items():
            assert got[path].tobytes() == leaf.tobytes(), (mesh, path)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("mesh,gather", LAYOUTS, ids=LAYOUT_IDS)
def test_two_step_losses_match_jax(runs, name, mesh, gather):
    i = _index(runs, name, mesh, gather)
    rep = runs["reports"][0][i]
    assert rep["gather"] == gather
    np.testing.assert_allclose(rep["losses"],
                               runs["want"][name, mesh, gather, False],
                               rtol=DTYPES[name][2])
    # the reported loss is the same on every rank
    for rank_reports in runs["reports"][1:]:
        assert rank_reports[i]["losses"] == rep["losses"]


@pytest.mark.parametrize("name", list(DTYPES))
def test_layouts_agree_with_each_other(runs, name):
    losses = [_report(runs, name, m, g)["losses"] for m, g in LAYOUTS]
    for other in losses[1:]:
        np.testing.assert_allclose(other, losses[0], rtol=2e-3)


@pytest.mark.parametrize("mesh,gather", LAYOUTS, ids=LAYOUT_IDS)
def test_first_step_grads_match_jax(runs, mesh, gather):
    _check_grads(_report(runs, "f32", mesh, gather), runs["jgrads"][False])


def _check_grads(rep, want):
    got = rep["grads"]
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=1e-4, atol=1e-4,
                                   err_msg=path)
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in want.values()))
    np.testing.assert_allclose(rep["grad_norm"], norm, rtol=1e-4)


@pytest.mark.parametrize("name", list(DTYPES))
def test_tied_embeddings_losses_match_jax(runs, name):
    """The tied branch: the embedding shard is the lookup table and,
    transposed, the vocab-parallel head."""
    i = _index(runs, name, TIED_MESH, "streamed", tied=True)
    losses = runs["reports"][0][i]["losses"]
    np.testing.assert_allclose(
        losses, runs["want"][name, TIED_MESH, "streamed", True],
        rtol=DTYPES[name][2])
    for rank_reports in runs["reports"][1:]:
        assert rank_reports[i]["losses"] == losses


def test_tied_embeddings_first_grads_match_jax(runs):
    _check_grads(_report(runs, "f32", TIED_MESH, "streamed", tied=True),
                 runs["jgrads"][True])


def test_streamed_schedule_holds_at_most_two_gathered_layers(runs):
    for mesh in ("fsdp=4", "fsdp=2,tensor=2"):
        streamed = _report(runs, "f32", mesh, "streamed", DEEP, True)
        upfront = _report(runs, "f32", mesh, "upfront", DEEP, True)
        # one step: each layer gathered for the forward and again for
        # the backward, never more than the current and the next at once
        assert streamed["layers_gathered"] == {"peak_live": 2,
                                               "gathers": 2 * DEEP}
        assert upfront["layers_gathered"] == {"peak_live": DEEP,
                                              "gathers": DEEP}
        assert streamed["losses"] == pytest.approx(upfront["losses"],
                                                   rel=1e-5)


@pytest.mark.parametrize("mesh,gather", DEEP_LAYOUTS,
                         ids=[f"{m}-{g}" for m, g in DEEP_LAYOUTS])
def test_param_residency_bytes_matches_jax(runs, mesh, gather):
    jcfg, _ = _cfgs("f32", n_layers=DEEP)
    jmesh = _jax_mesh(mesh)
    sample, specs = js.spmd_param_specs(jcfg, jmesh)
    want = param_residency_bytes(sample, specs, jmesh, mode=gather)
    assert _report(runs, "f32", mesh, gather, DEEP, True)["residency"] \
        == want


def test_step_rejects_what_jax_rejects(runs):
    got = [rep.get("rejected") for rep in runs["reports"][0][-3:]]
    assert got[0] == "tensor axis size 2 does not divide cfg.n_heads=3"
    assert "live 'seq' axis" in got[1]
    assert got[2] == "gather must be 'streamed' or 'upfront', got 'eager'"


@pytest.mark.parametrize("part", ["pair", "embed", "nll"])
def test_tp_helpers_grads_match_the_unsharded_functions(runs, part):
    inp = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in _tp_inputs().items()}
    cfg, t = inp["cfg"], WORLD
    for k in ("x", "w1", "w2", "emb", "head"):
        inp[k].requires_grad_(True)
    if part == "pair":
        y = (inp["x"] @ inp["w1"]) @ inp["w2"]
        (y * inp["r"]).sum().backward()
        want = {"y": y, "x": inp["x"].grad}
        sharded = {"w1": (inp["w1"].grad, 1), "w2": (inp["w2"].grad, 0)}
    elif part == "embed":
        e = inp["emb"][inp["tokens"]]
        (e * inp["r"]).sum().backward()
        want, sharded = {"e": e}, {"emb": (inp["emb"].grad, 0)}
    else:
        nll = tl._plain_chunk_nll(cfg, inp["head"])(inp["x"],
                                                    inp["targets"])
        nll.sum().backward()
        want = {"nll": nll, "x": inp["x"].grad}
        sharded = {"head": (inp["head"].grad, 1)}
    got = [rank[part] for rank in runs["tp"]]
    assert len(got) == t
    for name, ref in want.items():
        for rank in got:
            np.testing.assert_allclose(rank[name], ref.detach().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    for name, (ref, dim) in sharded.items():
        whole = np.concatenate([rank[name] for rank in got], axis=dim)
        np.testing.assert_allclose(whole, ref.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #


def _inherited_env():
    """What a rank inherits that could load another package: the search
    path and the runtime's, JAX's and pytest's variables."""
    keys = sorted(k for k in os.environ if k == "PYTHONPATH" or k.startswith(
        ("RAY_TPU", "JAX", "XLA", "PYTEST")))
    return "inherited environment: " + ", ".join(
        f"{k}={os.environ[k]!r}" for k in keys)


def test_a_rank_process_loads_no_jax():
    t0 = time.monotonic()
    try:
        mods = launch(loaded_modules, 2, device="cpu", timeout=TIMEOUT)
    except RuntimeError as e:  # a rank's traceback, or the deadline
        pytest.fail(f"the launch failed after {time.monotonic() - t0:.1f} s "
                    f"(deadline {TIMEOUT} s): {e}\n{_inherited_env()}")
    for r, rank in enumerate(mods):
        assert "ray_tpu_torch.train.launch" in rank, \
            f"rank {r} did not load the launcher: {len(rank)} modules"
        bad = [m for m in rank if m.split(".")[0] in
               ("jax", "jaxlib", "ray_tpu")]
        assert not bad, (f"rank {r} loaded {len(bad)} modules of JAX or "
                         f"the JAX package: {bad[:20]}; {_inherited_env()}")


def test_launch_starts_ranks_again_when_they_fail_to_join(monkeypatch):
    """Ranks that fail joining their process group (gloo's TCP mesh did
    so in 6 of 60 launches started six or eight at once on one host) are
    started again on a fresh rendezvous; a failure on every start raises.
    The fault point fires in the ranks: on the first start only, then on
    each."""
    monkeypatch.setenv("RAY_TPU_TEST_FAULT_SPEC",
                       "launch.rendezvous.0=raise@1")
    mods = launch(loaded_modules, 2, device="cpu", timeout=TIMEOUT)
    assert all("ray_tpu_torch.train.launch" in rank for rank in mods)
    monkeypatch.setenv("RAY_TPU_TEST_FAULT_SPEC", "launch.rendezvous=raise@1")
    with pytest.raises(RuntimeError, match="could not form their process "
                                           "group in 3 attempts"):
        launch(loaded_modules, 2, device="cpu", timeout=TIMEOUT)


def test_launch_raises_on_a_failing_rank_and_at_its_deadline():
    cfg = _cfgs("f32")[1]
    odd = np.zeros((3, 9), np.int32)  # 3 rows do not split over 2 ranks
    with pytest.raises(RuntimeError, match="does not split"):
        launch(train_jobs, 2, ([dict(cfg=cfg, tokens=odd)], "cpu"),
               device="cpu", timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="did not finish within"):
        launch(train_jobs, 2, ([], "cpu"), device="cpu", timeout=0.2)
    with pytest.raises(ValueError, match="functions of ray_tpu_torch"):
        launch(np.sum, 2, device="cpu")


def _children(pid):
    """The live (not zombie) processes whose parent is ``pid``."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            stat = _stat(int(entry))
            if stat is not None and stat[1] == pid and stat[0] != "Z":
                out.append(int(entry))
    return out


def _stat(pid):
    """(state, parent pid) of ``pid``, or None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except (FileNotFoundError, ProcessLookupError):
        return None
    return fields[0], int(fields[1])


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="reads /proc; the ranks die with their parent "
                           "through Linux's PR_SET_PDEATHSIG")
def test_ranks_die_with_a_killed_launcher():
    """A launcher killed from outside (its ``finally`` never runs) takes
    its ranks with it, even ranks in the middle of a long job."""
    script = (
        "import numpy as np\n"
        "from ray_tpu_torch.models.llama import LlamaConfig\n"
        "from ray_tpu_torch.train.launch import launch\n"
        "from ray_tpu_torch.train.spmd_runs import train_jobs\n"
        "job = dict(cfg=LlamaConfig.debug(), mesh='fsdp=2', steps=10**6,\n"
        "           tokens=np.zeros((2, 9), np.int32))\n"
        "launch(train_jobs, 2, ([job], 'cpu'), device='cpu', timeout=600)\n")
    launcher = subprocess.Popen([sys.executable, "-c", script],
                                stdout=subprocess.DEVNULL)
    ranks = []
    try:
        deadline = time.monotonic() + 60
        while len(ranks) < 2 and time.monotonic() < deadline:
            assert launcher.poll() is None, "the launcher ended early"
            time.sleep(0.1)
            ranks = _children(launcher.pid)
        assert len(ranks) == 2
        time.sleep(3)  # into the job: past the rank's start-up
        assert all(_stat(r) is not None for r in ranks)
        launcher.kill()
        launcher.wait()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            left = [r for r in ranks if (_stat(r) or "Z")[0] != "Z"]
            if not left:
                break
            time.sleep(0.1)
        assert not left, f"ranks {left} outlived their launcher"
    finally:
        launcher.kill()
        launcher.wait()
        for r in ranks:
            if (_stat(r) or "Z")[0] != "Z":
                os.kill(r, signal.SIGKILL)

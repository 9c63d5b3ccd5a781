"""Rank programs for ``train/launch.py``: each builds its mesh in the
rank, drives the sharded train step (or its tensor-parallel pieces) and
returns plain results — numbers and numpy arrays — so the caller can hold
them against a reference. ``chip_smoke.py`` and the CPU parity tests run
them, e.g. ``launch(train_jobs, 4, ([job], "cpu"), device="cpu")``.
:func:`trainer_probe_loop` is the trainer's default loop with a probe of
each worker around it, for ``TorchTrainer``.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import resolve_device
from ray_tpu_torch.collective.collective import (_leaves, _map,
                                                 all_gather, all_to_all,
                                                 pmean_tree)
from ray_tpu_torch.core.config import global_config
from ray_tpu_torch.models.llama import (make_pipeline_train_step,
                                        pipeline_param_specs, tp_psum_pair,
                                        vp_chunk_nll, vp_embed)
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import moe as moe_ops
from ray_tpu_torch.parallel.mesh import (P, axis_sizes, batch_sharding,
                                         data_axes, shard_index)
from ray_tpu_torch.parallel.pipeline import make_pipelined_fn
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.sharding import (param_residency_bytes,
                                             shard_device_put)
from ray_tpu_torch.train.spmd import (_sp_compile, _sp_compute, _sp_gather,
                                      _sp_scatter, _sync, build_train_mesh,
                                      global_grad_norm,
                                      make_collective_probes,
                                      make_mesh_train_step,
                                      make_moe_train_step,
                                      make_shard_and_gather_fns,
                                      make_spmd_train_step, spmd_param_specs,
                                      spmd_train_loop, tree_paths)
from ray_tpu_torch.util import flight_recorder as fr
from ray_tpu_torch.util import program_observatory

KERNELS = {"fwd": fa.flash_attention_forward,
           "dq": fa.flash_attention_bwd_dq,
           "dkv": fa.flash_attention_bwd_dkv}
# the step constructors a job names
STEPS = {"spmd": make_spmd_train_step, "mesh": make_mesh_train_step,
         "moe": make_moe_train_step}


def train_jobs(jobs: Sequence[Dict[str, Any]], device=None) -> List[dict]:
    """Run each job in turn on this rank and return one report each.

    A job is a dict: ``cfg`` (LlamaConfig), ``mesh`` (spec, e.g.
    ``"fsdp=2,tensor=2"``; empty is data-parallel over every rank),
    ``step`` (``"spmd"``, the default, for ``make_spmd_train_step``;
    ``"mesh"`` for ``make_mesh_train_step``, which takes ``seq``;
    ``"pipeline"`` for ``models/llama.py:make_pipeline_train_step``, with
    ``microbatches``; ``"moe"`` for ``make_moe_train_step``, the MoE
    decoder's, which :func:`moe_jobs` runs), ``gather``, ``init`` (seed
    or JAX param tree as numpy), ``tokens`` (the global batch, numpy int
    ``[B, T+1]``) and ``steps``; and what else to report: ``params``
    (True: every leaf gathered after init), ``grads`` (the '/'-joined
    paths of the leaves whose first-step grads to gather; both numpy,
    from rank 0 only),
    ``probes`` (True: the collective probes' times), ``profile``
    (``[(group, [words in a kernel's name]), ...]``: one more step under
    ``torch.profiler``, device time by group, the first group whose words
    match a kernel's name taking it), ``observe`` (the
    ``xla_observatory_enabled`` knob for this job; default: as it is)
    and ``observation_cost`` (n: the mean seconds of n steady-state
    observations of the step on its real arguments, the fingerprint and
    the lookup without the call).

    A report holds the mesh, this rank's coordinates on it, the schedule
    run, each step's loss and host time (synchronised), the first step's
    global grad norm, the attention kernels' launches over the steps, the
    rows this rank trains on and, on CUDA, the peak memory over the
    steps; the sharded steps add the most fsdp-full layers held at once
    and the analytic ``param_residency_bytes``. Each step is a
    flight-recorder span (the first ``spmd.compile``, the rest
    ``spmd.compute``), and ``programs`` holds this rank's program report
    over the job's spans (``util/program_observatory.py``). A
    configuration that the step refuses reports ``{"rejected":
    message}``."""
    dev = resolve_device(device)
    meshes: Dict[str, Any] = {}
    reports = []
    for job in jobs:
        spec = job.get("mesh", "")
        if spec not in meshes:
            meshes[spec] = build_train_mesh(spec, device=dev)
        reports.append(_train_job(meshes[spec], dev, job))
    return reports


def _train_job(mesh, dev, job):
    knobs = global_config()
    observed = knobs.xla_observatory_enabled
    knobs.xla_observatory_enabled = job.get("observe", observed)
    try:
        return _run_train_job(mesh, dev, job)
    finally:
        knobs.xla_observatory_enabled = observed


def _run_train_job(mesh, dev, job):
    cfg, step = job["cfg"], job.get("step", "spmd")
    try:
        if step == "pipeline":
            init_state, train_step = make_pipeline_train_step(
                cfg, mesh, job["microbatches"], device=dev)
        else:
            init_state, train_step = STEPS[step](
                cfg, mesh, gather=job.get("gather", "streamed"), device=dev)
    except ValueError as e:
        return {"rejected": str(e)}
    stats = getattr(train_step, "gather_stats", None)
    if stats is None:
        sample, specs = None, pipeline_param_specs(cfg, mesh)
    else:
        sample, specs = spmd_param_specs(cfg, mesh)
    _, gather_fns = make_shard_and_gather_fns(specs, mesh, device=dev)
    first = dist.get_rank() == 0

    def gathered(tree, fns=gather_fns):
        # a copy: a replicated leaf's "gathered" tensor is the leaf itself
        out = _map(lambda f, x: f(x.detach()).cpu().numpy().copy(), fns,
                   tree)
        return out if first else None

    state = init_state(job.get("init", 0))
    report: Dict[str, Any] = {"world": dist.get_world_size(),
                              "mesh": axis_sizes(mesh), "step": step,
                              "coords": {a: mesh.get_local_rank(a)
                                         for a in mesh.mesh_dim_names},
                              "gather": stats and stats.schedule}
    if job.get("params"):
        report["params"] = gathered(state["params"])
    rows = torch.from_numpy(np.ascontiguousarray(
        batch_sharding(mesh)(np.asarray(job["tokens"]))))
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for fn in KERNELS.values():
        fn.launches = 0
    losses, step_ms = [], []
    mark = fr.next_seq()
    for s in range(job.get("steps", 2)):
        _sync(dev)
        t_span = fr.now()
        t0 = time.perf_counter()
        loss = float(train_step(state, rows))
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        (_sp_compile if s == 0 else _sp_compute).end(t_span)
        losses.append(loss)
        if s == 0:
            report["grad_norm"] = float(global_grad_norm(
                state["params"], specs, mesh))
            if job.get("grads"):
                grads = dict(zip(_leaves(tree_paths(specs)),
                                 _leaves(_map(lambda p: p.grad,
                                              state["params"]))))
                fns = dict(zip(_leaves(tree_paths(specs)),
                               _leaves(gather_fns)))
                report["grads"] = gathered(
                    {p: grads[p] for p in job["grads"]},
                    {p: fns[p] for p in job["grads"]})
    report.update(
        losses=losses, step_ms=step_ms,
        launches={k: fn.launches for k, fn in KERNELS.items()},
        local_batch=int(rows.shape[0]),
        programs=program_observatory.program_report(mark)["programs"])
    if job.get("observation_cost"):
        n = int(job["observation_cost"])
        t0 = time.perf_counter()
        hits = sum(train_step.probe(state, rows) for _ in range(n))
        report["observation_cost_s"] = (time.perf_counter() - t0) / n
        report["observation_hits"] = hits
    if stats is not None:
        report.update(
            layers_gathered={"peak_live": stats.peak,
                             "gathers": stats.gathers},
            residency=param_residency_bytes(sample, specs, mesh,
                                            mode=stats.schedule))
    if dev.type == "cuda":
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
    if job.get("probes"):
        report["probes_ms"] = _probe_ms(cfg, mesh, state["params"], dev)
    if job.get("profile"):
        report["profile"] = _profile(lambda: train_step(state, rows), dev,
                                     job["profile"])
    return report


def moe_jobs(jobs: Sequence[Dict[str, Any]], device=None) -> List[dict]:
    """:func:`train_jobs` for the MoE decoder (``cfg`` an MoEConfig; the
    ``step`` defaults to ``"moe"``, ``train/spmd.py:make_moe_train_step``).
    A report also holds ``routing``, the experts this rank's tokens chose
    in the first step's forward (``[L, rows, T, top_k]`` int8, before
    capacity); ``rows``, the ``(start, stop)`` of those rows in the
    global batch (its batch shard's block, then its expert rank's);
    ``positions``, the ``(start, stop)`` of its tokens in each row (its
    ``seq`` rank's block); and ``tensor_checksums``, under a live
    ``tensor`` axis, each tensor rank's checksum of each layer's picks
    (``[t, L]``, all-gathered over the tensor group: the ranks of a group
    must route alike), else None."""
    dev = resolve_device(device)
    meshes: Dict[str, Any] = {}
    reports = []
    for job in jobs:
        job = {"step": "moe", **job}
        spec = job.get("mesh", "")
        if spec not in meshes:
            meshes[spec] = build_train_mesh(spec, device=dev)
        mesh = meshes[spec]
        log: List[np.ndarray] = []
        choices = moe_ops.expert_choices

        def recorded(probs, top_k):
            picks = choices(probs, top_k)
            # the first step's forward: one call a layer, in order
            if len(log) < job["cfg"].n_layers:
                log.append(picks.to(torch.int8).cpu().numpy())
            return picks

        moe_ops.expert_choices = recorded
        try:
            report = _train_job(mesh, dev, job)
        finally:
            moe_ops.expert_choices = choices
        if "rejected" not in report:
            report["routing"] = np.stack(log) if log else None
            rows, T = np.shape(job["tokens"])
            report["rows"] = _moe_rows(mesh, rows)
            report["positions"] = _block(mesh, "seq", T - 1)
            report["tensor_checksums"] = _tensor_checksums(mesh, log, dev)
        reports.append(report)
    return reports


def _moe_rows(mesh, global_rows: int):
    """(start, stop) in the global batch of the rows this rank of the MoE
    step trains on."""
    index, count = shard_index(mesh, data_axes(mesh)) \
        if data_axes(mesh) else (0, 1)
    per = global_rows // count
    names = mesh.mesh_dim_names
    if "expert" in names:
        ep = axis_sizes(mesh)["expert"]
        per //= ep
        index = index * ep + mesh.get_local_rank("expert")
    return index * per, (index + 1) * per


def _block(mesh, axis: str, n: int):
    """(start, stop) of this rank's block of ``n`` split over ``axis``
    (the whole of it where the axis is not live)."""
    if axis not in mesh.mesh_dim_names:
        return 0, n
    per = n // axis_sizes(mesh)[axis]
    i = mesh.get_local_rank(axis)
    return i * per, (i + 1) * per


def _tensor_checksums(mesh, log: List[np.ndarray], dev):
    """Each tensor rank's checksum of each layer's picks, ``[t, L]``
    (a position-weighted sum, so a moved pick changes it), all-gathered
    over the tensor group; None without a live tensor axis."""
    if "tensor" not in mesh.mesh_dim_names or not log:
        return None
    picks = torch.from_numpy(np.stack(log)).to(dev).long()
    flat = picks.reshape(len(log), -1)
    weights = torch.arange(1, flat.shape[1] + 1, device=dev)
    sums = (flat * weights).sum(1)
    return all_gather(sums[None], 0, mesh.get_group("tensor")).cpu() \
        .tolist()


def _profile(fn, dev, groups) -> Dict[str, Any]:
    """One call of ``fn`` under ``torch.profiler``: its host ms
    (synchronised), the device kernels' ms by group and, by name, the
    device ms of the kernels launched inside each ``record_function``
    range of the port (``moe.*``, ``ops/moe.py``). Kernels on different
    streams (NCCL's beside the compute stream) overlap, so the groups may
    add up to more than the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_group: Dict[str, float] = {}
    regions: Dict[str, float] = {}
    kernels = 0
    for e in prof.key_averages():
        if e.key.startswith("moe.") and e.device_type == DeviceType.CPU:
            # the range on the host: its kernels' device time
            regions[e.key] = e.device_time_total / 1e3
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0 \
                or getattr(e, "is_user_annotation", False):
            continue
        group = next((g for g, words in groups
                      if any(w in e.key for w in words)), "other")
        by_group[group] = by_group.get(group, 0.0) \
            + e.device_time_total / 1e3
        kernels += e.count
    return {"wall_ms": wall_ms, "device_ms_by_group": by_group,
            "device_kernels": kernels, "region_device_ms": regions}


def _probe_ms(cfg, mesh, params, dev, reps: int = 3) -> Dict[str, float]:
    """Mean host ms (synchronised) of each collective probe over ``reps``
    calls after one warm-up call."""
    gather_probe, scatter_probe = make_collective_probes(cfg, mesh)
    out = {}
    for name, probe, span in (("gather", gather_probe, _sp_gather),
                              ("scatter", scatter_probe, _sp_scatter)):
        float(probe(params))
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            t_span = fr.now()
            float(probe(params))
            span.end(t_span)
        _sync(dev)
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def tp_helpers(inputs: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The tensor-parallel helpers on a ``tensor=world`` mesh, each on this
    rank's shard of the full inputs in ``inputs`` (numpy): a Megatron MLP
    block through ``tp_psum_pair`` (``y = g((f(x) @ w1) @ w2)``),
    ``vp_embed`` and ``vp_chunk_nll`` (on ``f(x)``), with the grads of
    ``sum(y * r)``, ``sum(e * r)`` and ``sum(nll)``. Returns this rank's
    values and grads as numpy: a sharded leaf's grad is this rank's
    slice of it."""
    dev = resolve_device(device)
    world = dist.get_world_size()
    mesh = build_train_mesh(f"tensor={world}", device=dev)
    group = mesh.get_group("tensor")
    rank = dist.get_rank(group)
    f, g = tp_psum_pair(group)
    cfg = inputs["cfg"]

    def full(name, grad=False):
        return torch.tensor(inputs[name], device=dev).requires_grad_(grad)

    def local(name, dim):
        t = full(name)
        n = t.shape[dim] // world
        return t.narrow(dim, rank * n, n).clone().requires_grad_(True)

    out = {}
    x, r = full("x", True), full("r")
    w1, w2 = local("w1", 1), local("w2", 0)
    y = g((f(x) @ w1) @ w2)
    (y * r).sum().backward()
    out["pair"] = {"y": _np(y), "x": _np(x.grad), "w1": _np(w1.grad),
                   "w2": _np(w2.grad)}

    emb, tokens = local("emb", 0), full("tokens")
    e = vp_embed(cfg, emb, tokens, group, g)
    (e.float() * r).sum().backward()
    out["embed"] = {"e": _np(e), "emb": _np(emb.grad)}

    x = full("x", True)
    head, targets = local("head", 1), full("targets")
    nll = vp_chunk_nll(cfg, head, group, g)(f(x), targets)
    nll.sum().backward()
    out["nll"] = {"nll": _np(nll), "x": _np(x.grad), "head": _np(head.grad)}
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def ring_jobs(jobs: Sequence[Dict[str, Any]], device=None) -> List[dict]:
    """Ring attention (``parallel/ring_attention.py:ring_attention``) on
    this rank's shards. A job holds ``mesh`` (spec), ``causal``, whole
    q, k, v ``[B, T, H, D]`` and an output cotangent ``r`` (numpy, the
    same on every rank), optionally ``dtype`` (a torch dtype for q, k,
    v; float32 by default). The rank takes its shard of each under JAX's
    spec ``P(batch axes, seq, tensor, None)``, runs ``ring_attention``
    and back-propagates ``sum(o * r)``. Returns per job the shard's
    ``(start, stop)`` in each dim, this rank's o, dq, dk, dv (numpy) and
    its kernel launches."""
    dev = resolve_device(device)
    reports = []
    for job in jobs:
        mesh = build_train_mesh(job["mesh"], device=dev)
        names = mesh.mesh_dim_names
        spec = P(data_axes(mesh) or None, "seq" if "seq" in names else None,
                 "tensor" if "tensor" in names else None, None)
        q, k, v, r = (shard_device_put(job[n], mesh, spec, dev)
                      for n in ("q", "k", "v", "r"))
        q, k, v = (t.to(job.get("dtype", torch.float32)).requires_grad_(True)
                   for t in (q, k, v))
        for fn in KERNELS.values():
            fn.launches = 0
        o = ring_attention(q, k, v, mesh, causal=job["causal"])
        (o.float() * r).sum().backward()
        bounds = []
        for n, axes in zip(job["q"].shape, spec):
            i, c = shard_index(mesh, axes) if axes is not None else (0, 1)
            bounds.append((i * n // c, (i + 1) * n // c))
        reports.append({"bounds": bounds, "o": _np(o), "dq": _np(q.grad),
                        "dk": _np(k.grad), "dv": _np(v.grad),
                        "launches": {n: fn.launches
                                     for n, fn in KERNELS.items()}})
    return reports


def pipeline_schedule(cases: Sequence[Dict[str, Any]], device=None
                      ) -> List[dict]:
    """``parallel/pipeline.py``'s GPipe schedule on affine-tanh stages
    (``tanh(x @ w + b)``, or ``tanh(x @ w)`` without ``b``). A case holds
    ``mesh`` (a spec with a ``pipe`` axis of P), ``w`` ``[P, d, d]``,
    optionally ``b`` ``[P, d]``, ``x`` ``[B, d]`` and ``M`` (numpy, the
    same on every rank); the rank keeps stage s's ``w[s]`` (and ``b[s]``).
    Returns per case the outputs, and the grads of ``sum(out ** 2)`` in
    this stage's w and b and in x (None off stage 0), as numpy."""
    dev = resolve_device(device)
    reports = []
    for case in cases:
        mesh = build_train_mesh(case["mesh"], device=dev)
        stage = mesh.get_local_rank("pipe")

        def mine(name):
            return torch.tensor(case[name][stage], device=dev,
                                requires_grad=True)

        w = mine("w")
        b = mine("b") if case.get("b") is not None else None
        x = torch.tensor(case["x"], device=dev, requires_grad=True)

        def stage_fn(p, act):
            return torch.tanh(act @ p[0] + p[1]) if len(p) == 2 \
                else torch.tanh(act @ p[0])

        fn = make_pipelined_fn(stage_fn, mesh, case["M"])
        out = fn((w, b) if b is not None else (w,), x)
        out.pow(2).sum().backward()
        reports.append({
            "stage": stage, "out": _np(out), "w": _np(w.grad),
            "b": _np(b.grad) if b is not None else None,
            "x": _np(x.grad) if x.grad is not None else None})
    return reports


def expert_parallel_cases(cases: Sequence[Dict[str, Any]], device=None
                          ) -> List[dict]:
    """The MoE FFN's exchanges on this rank. A case holds ``mesh`` (a
    spec) and ``kind``:

    - ``"all_to_all"`` (an ``expert`` axis of ep ranks): ``x`` and ``r``,
      ``[ep, rows, m]`` numpy (rank j's are ``x[j]``, ``r[j]``; rows a
      multiple of ep): returns this rank's ``all_to_all(x[j])`` and the
      grad of ``sum(out * r[j])`` in ``x[j]``;
    - ``"routing"`` (a ``seq`` axis of R ranks): ``logits [G, S, E]``,
      ``top_k`` and ``capacity_factor``: ``top_k_routing`` on this seq
      rank's block of S/R tokens with the whole row's capacity and
      ``frac`` averaged over ``seq``; returns its dispatch, combine and
      aux;
    - ``"moe_ffn"``: ``x [B, S, d]``, ``router``, ``w_gate``, ``w_up``,
      ``w_down`` (all experts), ``r`` (a cotangent like x), ``top_k``,
      ``capacity_factor`` and ``aux_coef``, on any of ``expert`` (ep),
      ``seq`` (R) and ``tensor``: this rank takes its expert rank's rows
      and experts, its seq rank's block of S and its tensor rank's block
      of each expert's mlp dim, runs ``moe_ffn`` over those groups with
      ``frac`` averaged over ``expert`` and ``seq``, and back-propagates
      ``sum(y * r) + aux_coef * aux / (ep R)`` (so the sum over a tensor
      group's copies is the unsharded ``sum(y * r) + aux_coef * aux``).
      Returns its block's y, its aux, the grads of its x block, of the
      router (this rank's part) and of its experts' weight shards (this
      seq rank's part).

    Every case but the all-to-all reports ``block``: the ``(start,
    stop)`` of this rank's rows, positions, experts and mlp columns.
    Float32 throughout; results as numpy."""
    dev = resolve_device(device)
    reports = []
    for case in cases:
        mesh = build_train_mesh(case["mesh"], device=dev)
        live = {a: mesh.get_group(a) for a in ("expert", "seq", "tensor")
                if a in mesh.mesh_dim_names}
        if case["kind"] == "all_to_all":
            j = mesh.get_local_rank("expert")
            x = torch.tensor(case["x"][j], device=dev, requires_grad=True)
            out = all_to_all(x, live["expert"])
            (out * torch.tensor(case["r"][j], device=dev)).sum().backward()
            reports.append({"out": _np(out), "x": _np(x.grad)})
            continue
        frac_axes = [a for a in ("expert", "seq") if a in live]

        def frac_mean(f):
            return pmean_tree(f.detach().clone(), mesh, frac_axes)

        if case["kind"] == "routing":
            G, S, E = case["logits"].shape
            block = {"positions": _block(mesh, "seq", S)}
            logits = torch.tensor(case["logits"], device=dev)[
                :, slice(*block["positions"])]
            C = moe_ops.expert_capacity(S, E, case["top_k"],
                                        case["capacity_factor"])
            d, c, aux = moe_ops.top_k_routing(
                logits, E, case["top_k"], C, frac_mean, live["seq"])
            reports.append({"dispatch": _np(d), "combine": _np(c),
                            "aux": float(aux), "block": block})
            continue
        B, S, _ = case["x"].shape
        E, _, f = case["w_gate"].shape
        block = {"rows": _block(mesh, "expert", B),
                 "positions": _block(mesh, "seq", S),
                 "experts": _block(mesh, "expert", E),
                 "mlp": _block(mesh, "tensor", f)}

        def mine(name, *dims):
            t = torch.tensor(case[name], device=dev)
            for dim, what in dims:
                start, stop = block[what]
                t = t.narrow(dim, start, stop - start)
            return t.clone().requires_grad_(True)

        x = mine("x", (0, "rows"), (1, "positions"))
        r = mine("r", (0, "rows"), (1, "positions"))
        router = mine("router")
        w = {"w_gate": mine("w_gate", (0, "experts"), (2, "mlp")),
             "w_up": mine("w_up", (0, "experts"), (2, "mlp")),
             "w_down": mine("w_down", (0, "experts"), (1, "mlp"))}
        y, aux = moe_ops.moe_ffn(
            x, router, w["w_gate"], w["w_up"], w["w_down"],
            top_k=case["top_k"], capacity_factor=case["capacity_factor"],
            compute_dtype=torch.float32, expert_group=live.get("expert"),
            frac_mean=frac_mean, seq_group=live.get("seq"),
            collectives=tp_psum_pair(live["tensor"]) if "tensor" in live
            else None)
        shares = int(np.prod([dist.get_world_size(live[a])
                              for a in frac_axes]))
        ((y * r).sum() + case["aux_coef"] * aux / shares).backward()
        reports.append({"y": _np(y), "aux": float(aux), "x": _np(x.grad),
                        "router": _np(router.grad), "block": block,
                        **{n: _np(t.grad) for n, t in w.items()}})
    return reports


def rank_programs(calls: Sequence[Any], device=None) -> List[Any]:
    """Several of this module's rank programs in one launch: ``calls`` is
    a list of ``(program, jobs)`` pairs; returns each program's result,
    in order."""
    return [program(jobs, device) for program, jobs in calls]


def _foreign_modules() -> List[str]:
    """The modules of JAX or of the JAX package this process has loaded."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))


def _probed(loop, config: Dict[str, Any], with_loss: bool = False):
    """``loop(config)`` in a ``TorchTrainer`` worker with a probe of this
    worker around it: the kernels' launch counts are set to 0 just before
    the loop and read just after, with the peak device memory over the
    loop. Rank 0 then reports one more row, ``{"ranks": [...]}``, one
    probe a rank (all-gathered): its process id, its
    ``CUDA_VISIBLE_DEVICES``, the cards it sees and the first one's UUID,
    its launches, its peak bytes, the modules of JAX or of ``ray_tpu``
    it has loaded, the count and seconds
    of each ``spmd.*`` span the loop recorded (at the recorder's
    configured duration floor, ``flight_recorder_min_span_us``: shorter
    spans are not recorded) and what the loop returned (``result``);
    ``with_loss`` puts that result in the row as ``loss`` too. Returns
    that."""
    from ray_tpu_torch.train import session

    cuda = dist.get_backend() == "nccl"
    for fn in KERNELS.values():
        fn.launches = 0
    if cuda:
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    mark = fr.next_seq()
    result = loop(config)
    recorded = fr.snapshot_payload_since(mark)
    spans: Dict[str, Dict[str, float]] = {}
    for event in recorded["events"]:
        name = recorded["names"][event[1]]["name"]
        if name.startswith("spmd."):
            acc = spans.setdefault(name, {"count": 0, "s": 0.0})
            acc["count"] += 1
            acc["s"] += event[4]
    mine = {"rank": dist.get_rank(), "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count() if cuda else 0,
            "uuid": str(torch.cuda.get_device_properties(0).uuid)
            if cuda else None,
            "launches": {k: fn.launches for k, fn in KERNELS.items()},
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda
            else None,
            "foreign_modules": _foreign_modules(),
            "spans": spans,
            "result": result}
    ranks: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if dist.get_rank() == 0:
        row = {"ranks": ranks}
        if with_loss:
            row["loss"] = result
        session.report(row)
    return result


def trainer_probe_loop(config: Dict[str, Any]):
    """``TorchTrainer``'s default loop (``train/spmd.py:spmd_train_loop``)
    under :func:`_probed`; returns the loop's last loss. Like the default
    loop it takes every dataset whole and its own rows of each batch."""
    return _probed(spmd_train_loop, config)


trainer_probe_loop.reads_whole_datasets = True


def tune_probe_loop(config: Dict[str, Any]):
    """:func:`trainer_probe_loop` for a Tune trial (``Tuner(TorchTrainer(
    tune_probe_loop, ...))``): its last row carries the loop's last loss
    beside the probe, so the trial's final metrics, which Tune ranks,
    hold ``loss`` and every rank's card."""
    return _probed(spmd_train_loop, config, with_loss=True)


tune_probe_loop.reads_whole_datasets = True


# --------------------------------------------------------------------------- #
# Checkpoints: train, save, restore
# --------------------------------------------------------------------------- #


def _local_state(state, digest: bool) -> Dict[str, Any]:
    """This rank's part of a train state, by checkpoint key: each param
    and moment shard (and step count) as numpy, or, with ``digest``, the
    SHA-256 of its bytes."""
    import hashlib

    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.train.dcp_checkpoint import _state_dict

    out: Dict[str, Any] = {}
    for key, v in _state_dict(state).items():
        if isinstance(v, DTensor):
            v = v.to_local()
        if torch.is_tensor(v):
            a = np.ascontiguousarray(v.detach().cpu().numpy())
            v = hashlib.sha256(a.view(np.uint8)).hexdigest() if digest \
                else a.copy()
        out[key] = v
    return out


def _gathered_state(state, specs, mesh, dev) -> Dict[str, np.ndarray]:
    """Every param and moment whole (a collective), by checkpoint key."""
    _, gather_fns = make_shard_and_gather_fns(specs, mesh, device=dev)
    paths = _leaves(tree_paths(specs))
    fns = dict(zip(paths, _leaves(gather_fns)))
    leaves = dict(zip(paths, _leaves(state["params"])))
    opt = state["opt_state"]
    out = {}
    for path in paths:
        p = leaves[path]
        out[f"params/{path}"] = fns[path](p.detach()).cpu().numpy()
        for name in ("exp_avg", "exp_avg_sq"):
            if name in opt.state[p]:
                out[f"opt_state/{path}/{name}"] = fns[path](
                    opt.state[p][name]).cpu().numpy()
    return out


def _checkpoint_job(mesh, dev, job) -> Dict[str, Any]:
    from ray_tpu_torch.train.checkpoint import directory_bytes
    from ray_tpu_torch.train.dcp_checkpoint import (restore_torch_state,
                                                    save_torch_state)

    cfg = job["cfg"]
    init_state, train_step = make_spmd_train_step(
        cfg, mesh, gather=job.get("gather", "streamed"), device=dev)
    state = init_state(job.get("init", 0))
    digest = bool(job.get("digest"))
    report: Dict[str, Any] = {"mesh": axis_sizes(mesh),
                              "rank": dist.get_rank()}
    if job.get("restore"):
        _sync(dev)
        t0 = time.perf_counter()
        restore_torch_state(job["restore"], target=dict(
            state, layout=None) if job.get("plain") else state)
        _sync(dev)
        report["restore_s"] = time.perf_counter() - t0
        report["restored"] = _local_state(state, digest)
        report["restore_bytes"] = directory_bytes(job["restore"])
    rows_of = batch_sharding(mesh)
    batches = job.get("batches", [])
    losses = []
    for _ in range(job.get("steps", 0)):
        # the state's own step picks the batch, so a resumed run
        # continues where the saved one stopped
        tokens = batches[state["step"] % len(batches)]
        rows = torch.tensor(rows_of(tokens))  # a copy: may be read-only
        losses.append(float(train_step(state, rows)))
    report.update(losses=losses, step=state["step"])
    if job.get("save"):
        report["saved"] = _local_state(state, digest)
        # "plain": the shards as plain tensors, the form of one device's
        # state; across ranks DCP keeps one copy of each
        saved = dict(state, layout=None) if job.get("plain") else state
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        save_torch_state(job["save"], saved)
        dist.barrier()
        report["save_s"] = time.perf_counter() - t0
        report["save_bytes"] = directory_bytes(job["save"])
    if job.get("gathered"):
        _, specs = spmd_param_specs(cfg, mesh)
        full = _gathered_state(state, specs, mesh, dev)
        report["gathered"] = full if dist.get_rank() == 0 else None
    return report


def checkpoint_jobs(jobs: Sequence[Dict[str, Any]], device=None
                    ) -> List[dict]:
    """Train, save and restore sharded train states on this rank, one
    job after another (``train/dcp_checkpoint.py``), and report what
    each rank held.

    A job: ``cfg``, ``mesh`` (spec), ``gather``, ``init``, ``batches``
    (global batches, numpy int ``[B, T+1]``; step *s* of a state takes
    batch *s* mod their count, so a resumed state continues the stream),
    ``steps``; ``restore`` (a path: read into a fresh ``init_state``
    first), ``save`` (a path: save after the steps), ``plain`` (save and
    restore the shards as plain tensors instead), ``gathered`` (rank 0
    reports every
    param and moment whole), ``digest`` (report hashes instead of
    arrays). A report holds the losses and the state's step, and
    ``restored`` / ``saved``: this rank's shards and moments by
    checkpoint key as they were just after the restore and just before
    the save, with the seconds and on-disk bytes of each."""
    dev = resolve_device(device)
    return [_checkpoint_job(build_train_mesh(job.get("mesh", ""),
                                             device=dev), dev, job)
            for job in jobs]


def _checkpoint_loop(config: Dict[str, Any]) -> Dict[str, Any]:
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import Checkpoint

    dev = resolve_device(torch.device("cuda", 0)
                         if dist.get_backend() == "nccl" else "cpu")
    job = dict(config["job"])
    ckpt = session.get_checkpoint()
    if ckpt is not None:
        job["restore"] = ckpt.path
    mesh = build_train_mesh(config.get("mesh", ""), device=dev)
    report = _checkpoint_job(mesh, dev, job)
    saved = job.get("save") and dist.get_rank() == 0
    session.report({"losses": report["losses"], "step": report["step"]},
                   checkpoint=Checkpoint(job["save"]) if saved else None)
    return report


def checkpoint_probe_loop(config: Dict[str, Any]):
    """A ``TorchTrainer`` loop that trains with checkpoints, under
    :func:`_probed`: ``config["job"]`` is one :func:`checkpoint_jobs` job
    (``mesh`` from the config, as the default loop takes it). The loop
    restores from ``train.get_checkpoint()`` when the trainer resumes
    from one, takes the job's steps, and with ``save`` saves there and
    reports it as rank 0's checkpoint; each rank's probe ``result`` is
    its job report (digests by default)."""
    config = dict(config)
    config["job"] = {"digest": True, **config["job"]}
    return _probed(_checkpoint_loop, config)

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: ``python3 chip_smoke.py``.

Drives ``ray_tpu_torch`` only (no JAX, nothing of ``ray_tpu``). Each phase
prints one JSON line; any failed check raises, so the script exits
non-zero and never prints the final ``ok`` line.

1. environment: the card, its power limit, torch/CUDA versions, sm_90;
2. build: every CUDA kernel (forward, dQ, dK/dV) from
   ``ray_tpu_torch/ops/csrc``, with ptxas's registers, static shared
   memory and spills per kernel, and the dynamic shared memory, threads
   and launch registers of each;
3. each kernel against its plain version on the card, at the Llama-3-8B
   head shapes, the prefill shapes of the serving path, the training
   shape, shapes at the edges of the TMA rings and tile schedules (T 65
   to 4096, two batches, causal and full, head_dim 64, 80, 128) and a
   strided q (gradients element by element and per 64-row block, and
   the dQ kernel's delta = rowsum(o * do)), and at the head counts one
   rank sees under tensor parallelism; bitwise repeatability; at
   the table and training shapes each kernel, and the whole backward,
   timed in turns with SDPA (ratio, TFLOP/s, share of bound) and its
   plain version;
4. ``seq_ring``: ring attention's per-rank math (``parallel/
   ring_attention.py``) for each of 4 ring positions in one process, a
   list standing in for the transport, forward and backward at B 1, T
   8192 (four blocks of 2048) with the Llama-3-1B and Llama-3-8B heads
   (causal, and the 1B heads full): each block on the kernels, merged by
   lse; held against the whole-T kernels and the fp32 plain version
   (o and grads element by element and per 64-row block, and the merged
   lse), bitwise repeatable, launches R(R+1)/2
   (causal) or R^2 of each kernel; the whole-T kernels, the ring and SDPA
   timed in turns;
5. prefill at Llama-3-8B widths and 2 layers, kernel against plain attention;
6. one train step at Llama-3-1B widths and 2 layers, kernels against
   autograd through plain attention (loss, global grad norm and the
   grads of each layer's wq, wk, wv), with no plain delta on the way;
7. full-depth Llama-3-8B serving: a DecodeScheduler over the paged-KV
   engine answers six requests (one a prefix-cache hit), with the forward
   kernel's launch count read from this run; then ``serve_plane``: the
   same engine and weights behind the serve control plane
   (``serve.run`` -> controller -> one replica actor holding one card)
   on two dispatch planes, the HTTP proxy's SSE streams (the proxy a
   worker: the eager plane) and the ``DeploymentHandle`` streams (the
   compiled decode lane): the six prompts one after another over HTTP
   and the handle, bitwise the tokens above; 16 prompts alone, then all
   at once over HTTP and again through the handle, each burst stream
   bitwise its run alone; the six again over the default driver proxy,
   whose SSE rides the lane; each stream on its plane; for each
   plane TTFT and ms/token p50 / p99 at the client, tokens/s, and from
   the replica its launches against its cold prefills (32 a prefill)
   and peak memory; its card and modules; then ``dag``: a compiled
   graph of two actors on the card (a card each given more) whose
   ``device_channels`` edges carry a bf16 CUDA tensor of 1 x 2048 x
   4096, bitwise the same two functions run here, with no serialized
   bytes on either actor; ms an execution and the edges' GB/s
   pipelined over 50, and a 3-actor scalar chain compiled against
   eager;
8. full-depth Llama-3-1B training: 3 warm-up and 5 timed AdamW steps at
   batch 4 x 2048, with step time, tokens/s, MFU, peak memory, a profile
   of one step and the three kernels' launch counts read from this run;
9. the sharded steps, one rank per card (up to 4) over NCCL through
   ``train/launch.py`` in one launch (a ``world: N`` line first; one card
   runs the size-1 mesh): each layout at Llama-3-1B widths and reduced
   depth against the single-device step on the same global batch, then
   at full depth with step time, tokens/s per card and peak memory per
   rank. The ``spmd`` line: ``train/spmd.py``'s sharded step on ``fsdp``
   under both gather schedules (beside the analytic param residency and
   the collective probes; the streamed one's peak below the upfront
   one's) and ``fsdp x tensor 2``, and its mesh step with a live ``seq``
   axis (the ring over NCCL): ``seq`` over every card at T 8192, and on
   four ``fsdp=2,seq=2`` and ``seq=2,tensor=2`` at T 4096. The ``pipe``
   line: the GPipe step (``models/llama.py:make_pipeline_train_step``),
   ``pipe`` over every card and on four ``pipe=2,tensor=2``, with its
   bubble (P-1)/(M+P-1); one card prints a line that it needs two. Each
   rank's launches are read from its own counts;
10. ``moe``: the MoE decoder (``models/moe_llama.py``) at
   ``MoEConfig.small`` (12/4 heads: a GQA group of 3, also in the kernel
   gates above): on one card a 2-layer step through the kernels against
   plain attention (loss and grad norm free-running; the wq/wk/wv grads
   and each layer's routing agreement with the plain run replaying the
   kernel run's expert picks), then full depth timed (tokens/s, MFU on
   the active params, peak memory, a profile with the ``moe.*`` ranges);
   given two or four cards, ``make_moe_train_step`` on ``expert=2`` and
   ``tensor=2``, or on four ``expert=4``, ``fsdp=2,expert=2``,
   ``expert=2,tensor=2`` (tensor inside each expert) and
   ``seq=2,expert=2`` (each row split, the whole row's routing), against
   the single card at 2 layers and timed at full depth, with rank 0's
   NCCL device time by collective and, under ``tensor``, a checksum of
   each layer's picks equal across each tensor group;
11. ``mpmd`` (after the trainer's paths): the MPMD pipeline trainer
   (``train/pipeline.py``) at Llama-3-1B full width and depth, SGD, 8
   one-row microbatches of 2048 tokens a step, K = 2 stage actors at
   half a card each on one card (K = 4, a card each, on four); 1F1B and
   GPipe, 3 warm-up and 5 timed steps each, activations and grads on
   ``device_channels`` edges; held against ``reference_llama_losses``
   run here after the stages are gone (losses rtol 3e-3, each leaf's
   update 3e-2), no serialized bytes, stash at most K under 1F1B, each
   stage's launches exact; step ms, tokens/s per card, MFU, measured
   bubble against (K-1)/(M+K-1), peak per stage, the hop alone;
12. ``tune``: ``Tuner(TorchTrainer(...))`` over the default loop at
   Llama-3-1B widths and 2 layers, a grid of two learning rates (one
   trial at a time on one card, two on four): each trial's loss that of
   a direct fit, the best the lower, the workers' cards and launches,
   no card held and no JAX loaded by any other process of the runtime;
13. ``rllib`` (after ``tune``): PPO at ``PPOConfig``'s defaults on
   CartPole-v1, 2 remote CPU env runners and the learner on the card:
   iteration s (sampling, learning), env steps/s, ms a minibatch update
   on the card and the CPU, kernels an update, the learner's peak; no
   runner with a CUDA context, a card or JAX; one PPO, one IMPALA
   V-trace and one SAC update on the card against the CPU (loss, stats
   and grads 1e-5, the Adam step on the same grads 1e-6); the
   reference's CartPole learning gate (450 within 120 iterations) with
   the learner on the card; on two cards or more, two learners over
   NCCL against two gloo learners on the CPU. RLlib launches none of
   the three attention kernels;
14. the ``kernels`` line, the card's ``name, power.limit``, and last the
   ``{"ok": true, "device": ...}`` line.

Weights are random, made from ``--seed``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

from ray_tpu_torch.ops.flash_attention import attention_work
from ray_tpu_torch.util import program_observatory

# allclose bounds of a bf16 kernel against its fp32 plain version: the JAX
# suite's own forward tolerance (tests/test_flash_attention.py)
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 2e-2
# the backward kernels' dq, dk, dv against their fp32 plain versions: the
# JAX suite's grad bound (tests/test_flash_attention.py), element by element
GRAD_ATOL = 5e-2
GRAD_RTOL = 5e-2
# and block by block: per (batch, 64-row block, head), rms(err) over
# rms(ref) + GRAD_FLOOR at most GRAD_BLOCK_RTOL. With unit inputs a causal
# row's gradient shrinks as 1/sqrt(its span), to about 0.04 at T = 2048,
# so the element bound alone holds only the early rows; this one holds
# every block to its own size. GRAD_FLOOR keeps a block whose exact value
# is 0 (T = 1: dq = dk = 0) at its float32 rounding noise. On an H100 the
# sound kernels read at most 0.0034 over the 27 shapes, and a dQ or dK/dV
# kernel that skips one 64-row tile of its loop in long rows 0.18-0.52.
GRAD_BLOCK_RTOL = 2e-2
GRAD_FLOOR = 1e-3
# prefill logits, kernel vs plain attention, relative to max |logit|: the
# bound the CPU bf16 parity tests use
LOGITS_REL_TOL = 2e-2
# first-step loss and global grad norm, kernels vs plain attention: the
# JAX suite's train-step bound (tests/test_spmd_train.py)
TRAIN_RTOL = 3e-3
# the gradients of the leaves the backward kernels feed (wq, wk, wv of
# each layer), kernels vs plain attention: |g - g_plain| / |g_plain| of
# the worst leaf. The global norm above is mostly embedding and lm_head,
# so it cannot see a fault in dQ, dK or dV; this can. On an H100 the
# sound kernels read 0.018 (bf16 rounding through two layers), and a
# kernel that skips one tile of its loop in long rows 0.10 (dQ) or 0.12
# (dK/dV), while the global norm stays within 3e-3.
ATTN_GRAD_RTOL = 3e-2
# the dQ kernel's delta = rowsum(o * do) against the plain torch row sum:
# |err| <= DELTA_RTOL * rowsum(|o * do|), the float32 bound of one row sum
# taken in another order
DELTA_RTOL = 1e-5
# a ring's merged lse (float32) against the whole-T kernel's and the plain
# version's: max |err|. An lse off by e scales its row's probabilities by
# exp(-e), so 1e-3 holds P within 0.1%, a twentieth of the block bound;
# the card tests hold the forward kernel's lse at the same bound
RING_LSE_ATOL = 1e-3
# the streamed gather schedule's peak memory per rank must sit below the
# upfront one's by at least this share of the gathered bytes the analytic
# param_residency_bytes says it saves (its at-most-two-layers window
# against the whole stack); the rest of the gap is activations and grads,
# which the model leaves out
STREAMED_SAVING_SHARE = 0.5
# the MoE phase's routing agreement: the share of (token, choice) expert
# picks equal to the reference run's. A near-tie in the fp32 router logits
# can flip under bf16 rounding elsewhere in the step; a flip shows as a
# reading below 1 here, not as a loosened bound
ROUTING_AGREEMENT_MIN = 0.99
# The MoE step's attention leaves are held with the routing replayed: the
# reference run takes the experts the run under test chose, layer by
# layer, so the leaves compare attention and not the router's near-ties.
# Free-running, the 1.1 % of picks that flip under bf16 rounding (any two
# sound attention implementations: on an H100, SDPA against the fp32
# plain version reads 0.9889 agreement) move every wq/wk/wv grad by
# 0.09-0.21 at MoEConfig.small widths, 2 layers, B 4 x 2048.

# the observability phase (the program observatory, the serving hooks,
# device telemetry). Counted FLOPs of an observed program against the
# analytic count from the code: exact but for float rounding in a prefill
# or decode bucket, within 1 % for the train step
PROGRAM_FLOPS_RTOL = 1e-3
TRAIN_STEP_FLOPS_RTOL = 1e-2
# the report's MFU over the phase's own (6 N + 6 L H T D a token) against
# counted FLOPs over that count: the two differ in their time base only
# (the report's spans against the phase's timed steps)
MFU_RATIO_RTOL = 0.05
# steady-state observation (fingerprint and lookup) at most this share of
# a decode step's and a train step's time, timed over this many calls on
# the real arguments
OBSERVATION_COST_MAX = 0.01
OBSERVATION_CALLS = 1000
# max_memory_allocated of a run with observation on against one with it
# off
OBSERVED_PEAK_RTOL = 0.01
# the telemetry collector's interval in the observability phase
TELEMETRY_INTERVAL_MS = 50
# the serving phase's scheduler (its spans and gauges carry this tag), and
# a wait past the scheduler's 0.25 s gauge interval
SERVE_DEPLOYMENT = "llama3_8b"
SERVE_GAUGE_WAIT_S = 0.3

# device kernels by name, for the profile's breakdown (first match wins)
KERNEL_GROUPS = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
    ("optimizer", ("multi_tensor_apply",)),
    ("copy_cast", ("copy",)),
    ("reduce_softmax", ("reduce", "softmax", "index")),
)


# and on the sharded step's ranks, the collectives (NCCL's kernels) first
SPMD_KERNEL_GROUPS = (("nccl", ("nccl", "ncclDevKernel")),) + KERNEL_GROUPS
# on the MoE step's ranks NCCL's kernels by collective: the all-to-all is
# send/recv kernels, as are the ring's hops under seq
MOE_KERNEL_GROUPS = (("nccl_send_recv", ("SendRecv", "AllToAll")),
                     ("nccl_all_reduce", ("AllReduce",)),
                     ("nccl_all_gather", ("AllGather",)),
                     ("nccl_reduce_scatter", ("ReduceScatter",))) \
    + SPMD_KERNEL_GROUPS


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    """(bf16 FLOP/s, bytes/s) of the card from the program observatory's
    table (``util/program_observatory.py:PEAKS``, NVIDIA data sheets)."""
    peaks = program_observatory.peaks_for(name)
    if peaks is None:
        raise RuntimeError(f"no published peaks for card {name!r}")
    return peaks


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_ms(torch, fn) -> dict:
    """Run ``fn`` once plainly (host clock, synchronised) and once under
    torch.profiler: device kernel ms by name (top 8), their sum, the
    device's busy share of the plain run's wall time and the device ms of
    the kernels inside each of the port's ``moe.*`` ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    regions = {e.key: e.device_time_total / 1e3
               for e in prof.key_averages()
               if e.key.startswith("moe.") and e.device_type == DeviceType.CPU}
    # device kernels only: a user annotation (e.g. the optimizer's
    # record_function range) spans kernels already counted
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    groups: dict = {}
    for ms, _, key in rows:
        group = next((g for g, words in KERNEL_GROUPS
                      if any(w in key for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    return {"wall_ms": wall_ms,
            "device_ms": busy if rows else "not measured",
            "device_busy_share": busy / wall_ms if rows else "not measured",
            "device_kernels": sum(r[1] for r in rows),
            "device_ms_by_group": groups,
            "region_device_ms": regions,
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": n}
                            for ms, n, k in rows[:10]]}


def bound(flops, nbytes, peaks) -> dict:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def block_rel_err(torch, got, ref, rows: int = 64) -> float:
    """Worst over (batch, ``rows``-row block, head) of rms(got - ref) /
    (rms(ref) + GRAD_FLOOR), for [B, T, H, D] tensors."""
    B, T, H, D = ref.shape
    nb = -(-T // rows)

    def block_sums(x):
        x = torch.nn.functional.pad(x.pow(2), (0, 0, 0, 0, 0, nb * rows - T))
        return x.reshape(B, nb, rows, H, D).sum((2, 4))

    n = ((T - rows * torch.arange(nb, device=ref.device)).clamp(max=rows)
         * D).view(1, nb, 1)
    err_rms = (block_sums(got.float() - ref.float()) / n).sqrt()
    ref_rms = (block_sums(ref.float()) / n).sqrt()
    return (err_rms / (ref_rms + GRAD_FLOOR)).max().item()


def ptxas_report(log: str):
    """Registers, static shared memory and spills per kernel
    instantiation from ``nvcc -Xptxas -v`` output."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)ILi(\d+)E",
                             m.group(1))
            cur = {"kernel": f"{name.group(1)}<{name.group(2)}>"
                   if name else m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def launch_shapes(_build) -> dict:
    """Dynamic shared memory, threads, registers at launch and rows of a
    block of each kernel, per head_dim it is built for, as their
    libraries report them."""
    import ctypes

    shapes = {}
    for lib, entry, kernel in (
            ("flash_attention_fwd", "flash_attention_fwd_config",
             "flash_fwd_kernel"),
            ("flash_attention_bwd", "flash_attention_bwd_dq_config",
             "flash_bwd_dq_kernel"),
            ("flash_attention_bwd", "flash_attention_bwd_dkv_config",
             "flash_bwd_dkv_kernel")):
        fn = getattr(_build.load(lib), entry)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        for D in (64, 128):
            out = (ctypes.c_int * 4)()
            check(fn(D, out) == 0, f"{entry}({D}) failed")
            shapes[f"{kernel}<{D}>"] = {
                "dynamic_smem_bytes": out[0], "threads": out[1],
                "registers_at_launch": out[2], "rows": out[3]}
    return shapes


def phase_build(_build) -> None:
    """Build every kernel source (one nvcc each, all started together)
    and print ptxas's report of each instantiation and the launch shape
    of each kernel."""
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    # a library built earlier from the same source keeps its ptxas log
    logs = {n: _build.library_path(n).with_suffix(".log").read_text()
            for n in _build.SOURCES}
    emit({"phase": "build", "seconds": build_s, "built": sorted(built),
          "seconds_each": {n: r["seconds"] for n, r in built.items()},
          "ptxas": {n: ptxas_report(log) for n, log in logs.items()},
          "launch": launch_shapes(_build)})


def in_turns(torch, kernel, library, iters: int = 20) -> dict:
    """Kernel and library call timed in turns (kernel, library, library,
    kernel) on the same inputs: each one's mean of its two readings."""
    k1 = cuda_ms(kernel, iters)
    l1 = cuda_ms(library, iters)
    l2 = cuda_ms(library, iters)
    k2 = cuda_ms(kernel, iters)
    return {"ms": (k1 + k2) / 2, "library_ms": (l1 + l2) / 2,
            "ms_each": [k1, k2], "library_ms_each": [l1, l2],
            "ratio_to_library": (k1 + k2) / (l1 + l2)}


def rates(timing: dict) -> dict:
    """Achieved TFLOP/s and share of the bound of a timed kernel."""
    seconds = timing["ms"] * 1e-3
    return {"achieved_tflops": timing["flops"] / seconds / 1e12,
            "share_of_bound": timing["bound_ms"] / timing["ms"]}


def strided_qkv(torch, gen, B, T, Hq, Hkv, D):
    """q, k, v as column slices of one fused projection output (q is a
    view into a wider tensor, not contiguous)."""
    fused = torch.randn(B, T, (Hq + 2 * Hkv) * D, device="cuda",
                        generator=gen).to(torch.bfloat16)
    q = fused[..., :Hq * D].view(B, T, Hq, D)
    k = fused[..., Hq * D:(Hq + Hkv) * D].view(B, T, Hkv, D)
    v = fused[..., (Hq + Hkv) * D:].view(B, T, Hkv, D)
    check(not q.is_contiguous(), "the strided case's q is contiguous")
    return q, k, v


# gate shapes that stress the K/V and Q/dO rings and the tile schedules:
# lengths one short of, at and past the 64- and 128-row tiles, two
# batches, causal and full, both head_dims the wgmma kernels are built
# for and one (80) read through a narrower TMA map
RING_CASES = ([(2, 32, 8, D, T, causal)
               for D in (64, 128)
               for T in (65, 127, 128, 129, 257, 4096)
               for causal in (True, False)]
              + [(2, 32, 8, 80, T, causal) for T in (129, 257)
                 for causal in (True, False)])


# the heads one rank sees under tensor parallelism (the sharded step's
# attention): the 1B at tensor 2 (16/4, D 64), the 8B at tensor 2 and 4
# (16/4 and 8/2, D 128), at the training and table lengths and at ragged
# ones
TP_CASES = [(4, 16, 4, 64, 2048, True), (1, 16, 4, 128, 2048, True),
            (1, 8, 2, 128, 2048, True), (2, 16, 4, 64, 257, False),
            (2, 8, 2, 128, 129, True), (2, 16, 4, 128, 129, False)]


# the MoE decoder's heads (MoEConfig.small: 12/4, D 64, a GQA group of 3)
# at its training shape and at a ragged length
MOE_CASES = [(4, 12, 4, 64, 2048, True), (2, 12, 4, 64, 257, False)]


# the two timed shapes: the 8B heads at a 2k-token prefill, and the 1B
# training step's attention
TIMED_SHAPES = (("table", (1, 2048, 32, 8, 128)),
                ("train", (4, 2048, 32, 8, 64)))


def phase_kernel(torch, gen, peaks):
    from ray_tpu_torch.ops.flash_attention import (flash_attention_forward,
                                                   flash_attention_reference)

    def inputs(B, T, Hq, Hkv, D):
        def r(h):
            return torch.randn(B, T, h, D, device="cuda", generator=gen,
                               dtype=torch.float32).to(torch.bfloat16)
        return r(Hq), r(Hkv), r(Hkv)

    cases = [(1, Hq, Hkv, D, T, causal)
             for (Hq, Hkv, D) in ((32, 8, 128), (32, 8, 64))
             for T in (1, 17, 64, 100, 512, 2048)
             for causal in (True, False)]
    # the serving phase's padded prefill lengths (page_size 16)
    cases += [(1, 32, 8, 128, T, True) for T in (16, 208, 1008, 2000)]
    cases += RING_CASES + TP_CASES + MOE_CASES
    cases += [("strided", 32, 8, D, 257, True) for D in (64, 128)]
    worst_o = worst_lse = worst_ratio = 0.0
    for B, Hq, Hkv, D, T, causal in cases:
        if B == "strided":
            q, k, v = strided_qkv(torch, gen, 2, T, Hq, Hkv, D)
        else:
            q, k, v = inputs(B, T, Hq, Hkv, D)
        shape = (B, Hq, Hkv, D, T, causal)
        o, lse = flash_attention_forward(q, k, v, causal)
        o2, lse2 = flash_attention_forward(q, k, v, causal)
        torch.cuda.synchronize()
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"kernel not bitwise repeatable at {shape}")
        ro, rlse = flash_attention_reference(q, k, v, causal)
        err_o = (o.float() - ro.float()).abs()
        ratio = (err_o / (KERNEL_ATOL + KERNEL_RTOL * ro.float().abs())
                 ).max().item()
        err_lse = (lse - rlse).abs().max().item()
        worst_o = max(worst_o, err_o.max().item())
        worst_lse = max(worst_lse, err_lse)
        worst_ratio = max(worst_ratio, ratio)
        check(ratio <= 1.0 and err_lse <= KERNEL_ATOL,
              f"kernel disagrees with its plain version at {shape}: max "
              f"|o err| {err_o.max().item()}, max |lse err| {err_lse}")
        del o, o2, lse, lse2, ro, rlse, err_o
    emit({"phase": "kernel_vs_plain", "cases": len(cases),
          "max_abs_err_o": worst_o, "max_abs_err_lse": worst_lse,
          "worst_err_over_tolerance": worst_ratio,
          "tolerance": {"atol": KERNEL_ATOL, "rtol": KERNEL_RTOL},
          "bitwise_repeatable": True})

    timings = {}
    for label, (B, T, Hq, Hkv, D) in TIMED_SHAPES:
        q, k, v = inputs(B, T, Hq, Hkv, D)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        timing = in_turns(
            torch, lambda: flash_attention_forward(q, k, v, True),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        timing.update(
            shape={"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D,
                   "causal": True, "dtype": "bfloat16"},
            plain_ms=cuda_ms(
                lambda: flash_attention_reference(q, k, v, True), iters=5),
            library="torch.nn.functional.scaled_dot_product_attention",
            **bound(*attention_work(B, T, Hq, Hkv, D, True), peaks))
        timing.update(rates(timing))
        timings[label] = timing
        emit({"phase": "kernel_timing", "kernel": "fwd", "at": label,
              **timing})
        del qt, kt, vt
    return worst_o, worst_lse, worst_ratio, timings


def phase_backward(torch, gen, peaks):
    """The dQ kernel (dq and its delta) and the dK/dV kernel, fed that
    delta, against their plain versions on the forward's shape grid,
    bench()'s heads, the training shape, the ring cases and a strided q;
    then their times, and the whole backward's, at the 8B table shape and
    the training shape, in turns with SDPA's backward."""
    from ray_tpu_torch.ops import flash_attention as fa

    def inputs(B, T, Hq, Hkv, D, causal):
        def r(h):
            return torch.randn(B, T, h, D, device="cuda", generator=gen,
                               dtype=torch.float32).to(torch.bfloat16)
        if B == "strided":
            q, k, v = strided_qkv(torch, gen, 2, T, Hq, Hkv, D)
            do = torch.randn(q.shape, device="cuda", generator=gen,
                             dtype=torch.float32).to(torch.bfloat16)
        else:
            q, k, v, do = r(Hq), r(Hkv), r(Hkv), r(Hq)
        o, lse = fa.flash_attention_forward(q, k, v, causal)
        return q, k, v, o, lse, do

    cases = [(1, Hq, Hkv, D, T, causal)
             for (Hq, Hkv, D) in ((32, 8, 128), (32, 8, 64))
             for T in (1, 17, 64, 100, 512, 2048)
             for causal in (True, False)]
    cases += [(1, 12, 6, 128, 2048, True), (1, 12, 6, 128, 100, False),
              (4, 32, 8, 64, 2048, True)]
    cases += RING_CASES + TP_CASES + MOE_CASES
    cases += [("strided", 32, 8, D, 257, True) for D in (64, 128)]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    worst_ratio = {"dq": 0.0, "dkv": 0.0}
    worst_block = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    worst_delta = {"max_abs_err": 0.0, "err_over_bound": 0.0}
    train_block = {}
    for B, Hq, Hkv, D, T, causal in cases:
        q, k, v, o, lse, do = inputs(B, T, Hq, Hkv, D, causal)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta2,
                                              causal)
        torch.cuda.synchronize()
        shape = (B, Hq, Hkv, D, T, causal)
        check(torch.equal(dq, dq2) and torch.equal(delta, delta2)
              and torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"backward kernels not bitwise repeatable at {shape}")
        prod = o.float() * do.float()
        err = (delta - prod.sum(-1).transpose(1, 2)).abs()
        bound_d = DELTA_RTOL * prod.abs().sum(-1).transpose(1, 2)
        worst_delta["max_abs_err"] = max(worst_delta["max_abs_err"],
                                         err.max().item())
        worst_delta["err_over_bound"] = max(
            worst_delta["err_over_bound"],
            (err / bound_d.clamp_min(1e-30)).max().item())
        check(bool((err <= bound_d).all()),
              f"dQ kernel's delta disagrees with rowsum(o * do) at {shape}:"
              f" max |err| {err.max().item()}")
        del prod, err, bound_d
        want = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     causal)
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            err = (got.float() - ref.float()).abs()
            ratio = (err / (GRAD_ATOL + GRAD_RTOL * ref.float().abs())
                     ).max().item()
            rel = block_rel_err(torch, got, ref)
            worst[name] = max(worst[name], err.max().item())
            worst_block[name] = max(worst_block[name], rel)
            if (B, T, Hq) == (4, 2048, 32):
                train_block[name] = rel
            kern = "dq" if name == "dq" else "dkv"
            worst_ratio[kern] = max(worst_ratio[kern], ratio)
            check(ratio <= 1.0 and rel <= GRAD_BLOCK_RTOL,
                  f"{name} kernel disagrees with its plain version at "
                  f"{shape}: max |err| {err.max().item()}, "
                  f"err over tolerance {ratio}, block rel err {rel}")
        del want, dq, dk, dv, dq2, dk2, dv2, delta, delta2
    emit({"phase": "kernel_vs_plain_backward", "cases": len(cases),
          "max_abs_err": worst, "worst_err_over_tolerance": worst_ratio,
          "block_rel_err": worst_block,
          "block_rel_err_train_shape": train_block,
          "delta": worst_delta,
          "tolerance": {"atol": GRAD_ATOL, "rtol": GRAD_RTOL,
                        "block_rtol": GRAD_BLOCK_RTOL,
                        "block_floor": GRAD_FLOOR,
                        "delta_rtol_of_abs_rowsum": DELTA_RTOL},
          "bitwise_repeatable": True})

    timings = {}
    for label, (B, T, Hq, Hkv, D) in TIMED_SHAPES:
        q, k, v, o, lse, do = inputs(B, T, Hq, Hkv, D, True)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
        # SDPA's backward alone (dq, dk, dv together): the yardstick,
        # never called by the port
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        runs = {
            "dq": (lambda: fa.flash_attention_bwd_dq(
                q, k, v, o, do, lse, True),
                lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, o, do, lse, True)),
            "dkv": (lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, True),
                lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, lse, delta, True)),
            # the port's whole backward (dQ with delta, then dK/dV): the
            # same function as SDPA's backward
            "bwd": (lambda: fa.flash_attention_backward(
                q, k, v, o, lse, do, True),
                lambda: fa.flash_attention_backward_reference(
                    q, k, v, o, lse, do, True)),
        }
        timings[label] = {}
        for name, (kern, plain) in runs.items():
            timing = in_turns(torch, kern, library)
            timing.update(
                plain_ms=cuda_ms(plain, iters=3, warmup=1),
                **bound(*attention_work(B, T, Hq, Hkv, D, True, name),
                        peaks))
            timing.update(rates(timing))
            timings[label][name] = timing
        # what the two-kernel design does beyond the function: S and dP,
        # computed in both kernels (not part of the bound)
        done = sum(attention_work(B, T, Hq, Hkv, D, True, name)[0]
                   for name in ("dq", "dkv"))
        whole = timings[label]["bwd"]
        whole["split_design"] = {
            "flops_done": done, "repeated_flops": done - whole["flops"],
            "tflops_done": done / (whole["ms"] * 1e-3) / 1e12}
        emit({"phase": "kernel_timing_backward", "at": label,
              "shape": {"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D,
                        "causal": True, "dtype": "bfloat16"},
              "grid_blocks": {"dq": -(-T // (128 if D > 64 else 64))
                              * Hq * B, "dkv": -(-T // 64) * Hkv * B},
              "library": "scaled_dot_product_attention backward "
                         "(dq, dk, dv together)", **timings[label]})
        del out, qt, kt, vt, delta
    return worst, worst_ratio, worst_block, worst_delta, timings


# the ring of the seq_ring phase: R virtual positions in one process, at
# full width (B 1, T 8192: four blocks of 2048), Llama-3-1B heads (D 64)
# and Llama-3-8B heads (D 128) under causal, and the 1B heads full
RING_SIZE = 4
SEQ_RING_CASES = (("1b", (1, 8192, 32, 8, 64), True),
                  ("8b", (1, 8192, 32, 8, 128), True),
                  ("1b_full", (1, 8192, 32, 8, 64), False))


def ring_launches(ring: int, causal: bool) -> int:
    """Launches of each kernel in one ring attention call over ``ring``
    ranks, all ranks together: rank r visits r+1 blocks under causal."""
    return ring * (ring + 1) // 2 if causal else ring * ring


def plain_by_kv_head(torch, fa, q, k, v, do, causal):
    """The fp32 plain forward and backward, one kv head's group of q
    heads at a time, so the [B, H, T, T] scores at T 8192 fit: ``([o,
    dq, dk, dv], lse)``."""
    rep = q.shape[2] // k.shape[2]
    parts, lses = [], []
    for g in range(k.shape[2]):
        qs, dos = (x[:, :, g * rep:(g + 1) * rep] for x in (q, do))
        ks, vs = (x[:, :, g:g + 1] for x in (k, v))
        o, lse = fa.flash_attention_reference(qs, ks, vs, causal)
        parts.append((o, *fa.flash_attention_backward_reference(
            qs, ks, vs, o, lse, dos, causal)))
        lses.append(lse)
    return [torch.cat(x, dim=2) for x in zip(*parts)], torch.cat(lses, 1)


def seq_ring_readings(torch, gen, cases=SEQ_RING_CASES) -> dict:
    """Each case's ring (``ring_attention_simulated``: the per-rank loops
    of every position, the same kernel calls as over a process group),
    forward and backward in one call with its launches counted, run twice
    (bitwise repeatable), and its o, dq, dk, dv and merged lse held
    against the whole-T kernels and the fp32 plain version on the same
    inputs: the forward's and the grads' element bounds (error over atol
    + rtol |ref|), the block error of o and of each grad, and the lse's
    max error over RING_LSE_ATOL."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.ring_attention import \
        ring_attention_simulated

    out = {}
    for label, (B, T, Hq, Hkv, D), causal in cases:
        def r(h):
            return torch.randn(B, T, h, D, device="cuda", generator=gen,
                               dtype=torch.float32).to(torch.bfloat16)
        q, k, v, do = r(Hq), r(Hkv), r(Hkv), r(Hq)
        reset_launches(fa)
        o, lse, grads = ring_attention_simulated(q, k, v, RING_SIZE, causal,
                                                 do=do)
        torch.cuda.synchronize()
        launches = read_launches(fa)
        got = [o, lse, *grads]
        again = ring_attention_simulated(q, k, v, RING_SIZE, causal, do=do)
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(got, [again[0], again[1], *again[2]]))
        del again, o, grads
        wo, wlse = fa.flash_attention_forward(q, k, v, causal)
        plain, plain_lse = plain_by_kv_head(torch, fa, q, k, v, do, causal)
        refs = {"kernel_whole_T": ([wo, *fa.flash_attention_backward(
                    q, k, v, wo, wlse, do, causal)], wlse),
                "plain": (plain, plain_lse)}
        reading = {"shape": {"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D,
                             "causal": causal, "ring": RING_SIZE},
                   "launches": launches,
                   "want_launches": ring_launches(RING_SIZE, causal),
                   "bitwise_repeatable": bitwise}
        for ref_name, (ref, ref_lse) in refs.items():
            errs = {}
            for name, g, w in zip(("o", "dq", "dk", "dv"),
                                  [got[0], *got[2:]], ref):
                atol, rtol = (KERNEL_ATOL, KERNEL_RTOL) if name == "o" \
                    else (GRAD_ATOL, GRAD_RTOL)
                diff = (g.float() - w.float()).abs()
                errs[name] = {
                    "max_abs_err": diff.max().item(),
                    "err_over_tolerance": (diff / (atol + rtol * w.float()
                                                   .abs())).max().item(),
                    "block_rel_err": block_rel_err(torch, g, w)}
            lse_err = (got[1] - ref_lse).abs().max().item()
            errs["lse"] = {"max_abs_err": lse_err,
                           "err_over_tolerance": lse_err / RING_LSE_ATOL}
            reading[ref_name] = errs
        out[label] = reading
        del got, refs, wo, wlse, plain, plain_lse, q, k, v, do
        torch.cuda.empty_cache()
    return out


def seq_ring_failures(readings: dict) -> list:
    """The seq_ring gates a reading breaks."""
    bad = []
    for label, rd in readings.items():
        want = rd["want_launches"]
        if rd["launches"] != {"fwd": want, "dq": want, "dkv": want}:
            bad.append(f"{label}: launched {rd['launches']}, want {want} "
                       f"of each")
        if not rd["bitwise_repeatable"]:
            bad.append(f"{label}: not bitwise repeatable")
        for ref_name in ("kernel_whole_T", "plain"):
            for name, e in rd[ref_name].items():
                if e["err_over_tolerance"] > 1.0 \
                        or e.get("block_rel_err", 0.0) > GRAD_BLOCK_RTOL:
                    bad.append(f"{label}: {name} against {ref_name}: {e}")
    return bad


def phase_seq_ring(torch, gen, peaks, smi):
    """Ring attention's kernel path on one card (the seq_ring phase): the
    gates of :func:`seq_ring_readings`, then at the two causal shapes the
    whole-T kernels, the ring (its blocks over all R positions, with the
    merges) and SDPA, forward and forward + backward, timed in turns."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.ring_attention import \
        ring_attention_simulated

    readings = seq_ring_readings(torch, gen)
    bad = seq_ring_failures(readings)
    timings = {}
    for label, (B, T, Hq, Hkv, D), causal in SEQ_RING_CASES:
        if not causal:
            continue
        def r(h):
            return torch.randn(B, T, h, D, device="cuda", generator=gen,
                               dtype=torch.float32).to(torch.bfloat16)
        q, k, v, do = r(Hq), r(Hkv), r(Hkv), r(Hq)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)

        def whole_both():
            o, lse = fa.flash_attention_forward(q, k, v, True)
            return fa.flash_attention_backward(q, k, v, o, lse, do, True)

        runs = {"fwd": (lambda: fa.flash_attention_forward(q, k, v, True),
                        lambda: ring_attention_simulated(q, k, v, RING_SIZE),
                        lambda: sdpa().detach()),
                "fwd_bwd": (whole_both,
                            lambda: ring_attention_simulated(
                                q, k, v, RING_SIZE, do=do),
                            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                        dot))}
        timings[label] = {}
        for what, (whole, ring, library) in runs.items():
            # in turns: ring, whole, library, library, whole, ring
            reads = {"ring": [cuda_ms(ring, 5, 1)],
                     "whole_T": [cuda_ms(whole, 5, 1)],
                     "library": [cuda_ms(library, 5, 1)]}
            reads["library"].append(cuda_ms(library, 5, 1))
            reads["whole_T"].append(cuda_ms(whole, 5, 1))
            reads["ring"].append(cuda_ms(ring, 5, 1))
            work = [attention_work(B, T, Hq, Hkv, D, True, kern)
                    for kern in (("fwd",) if what == "fwd"
                                 else ("fwd", "bwd"))]
            timing = {f"{k}_ms": sum(x) / 2 for k, x in reads.items()}
            timing.update({f"{k}_ms_each": x for k, x in reads.items()},
                          **bound(sum(w[0] for w in work),
                                  sum(w[1] for w in work), peaks))
            timing["ring_over_whole_T"] = timing["ring_ms"] \
                / timing["whole_T_ms"]
            timings[label][what] = timing
        del q, k, v, do, qt, kt, vt, dot
        torch.cuda.empty_cache()
    emit({"phase": "seq_ring", "card": smi, "ring": RING_SIZE,
          "cases": readings, "timings": timings,
          "library": "torch.nn.functional.scaled_dot_product_attention "
                     "(forward; forward + backward)",
          "tolerance": {"fwd_atol": KERNEL_ATOL, "fwd_rtol": KERNEL_RTOL,
                        "grad_atol": GRAD_ATOL, "grad_rtol": GRAD_RTOL,
                        "block_rtol": GRAD_BLOCK_RTOL,
                        "lse_atol": RING_LSE_ATOL}})
    check(not bad, f"seq_ring gates failed: {bad}")
    return {k: sum(rd["launches"][k] for rd in readings.values())
            for k in ("fwd", "dq", "dkv")}


def _grad_norm(torch, model) -> float:
    return math.sqrt(sum(float(p.grad.float().pow(2).sum())
                         for p in model.parameters()))


def phase_reduced_depth_train(torch, seed):
    """One train step at Llama-3-1B widths and 2 layers through the
    kernels, against the same step with attention autograd through the
    plain forward."""
    from unittest import mock

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_1b(), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2049), device="cuda",
                           generator=gen)
    init_state, train_step = llama.make_train_step(cfg)

    def one_step():
        state = init_state(seed)
        loss = float(train_step(state, tokens))
        layers = state["params"].layers
        # the leaves dq, dk and dv flow into, layer by layer
        leaves = {f"{name}[{i}]": g.clone()
                  for name in ("wq", "wk", "wv")
                  for i, g in enumerate(getattr(layers, name).grad)}
        return loss, _grad_norm(torch, state["params"]), leaves

    reset_launches(fa)
    patch, delta_calls = counting_plain_delta(fa)
    with patch:
        loss, gnorm, leaves = one_step()
    counts = read_launches(fa)
    check(counts == expected_launches(cfg, 1),
          f"reduced-depth train step launched {counts}")
    check(not delta_calls, f"the kernel step took the plain delta "
                           f"{len(delta_calls)} times")
    with mock.patch.object(
            llama, "flash_attention",
            lambda q, k, v, causal: fa.flash_attention_reference(
                q, k, v, causal)[0]):
        plain_loss, plain_gnorm, plain_leaves = one_step()
    torch.cuda.empty_cache()
    rel = {"loss": abs(loss - plain_loss) / abs(plain_loss),
           "grad_norm": abs(gnorm - plain_gnorm) / abs(plain_gnorm)}
    leaf_rel = {name: ((g - plain_leaves[name]).norm()
                       / plain_leaves[name].norm()).item()
                for name, g in leaves.items()}
    emit({"phase": "reduced_depth_train", "n_layers": cfg.n_layers,
          "dim": cfg.dim, "batch": 1, "T": tokens.shape[1] - 1,
          "loss": loss,
          "plain_loss": plain_loss, "grad_norm": gnorm,
          "plain_grad_norm": plain_gnorm, "rel_diff": rel,
          "rtol": TRAIN_RTOL, "attn_leaf_rel_diff": leaf_rel,
          "attn_leaf_rtol": ATTN_GRAD_RTOL, "launches": counts,
          "plain_delta_calls": len(delta_calls)})
    check(math.isfinite(loss) and math.isfinite(gnorm),
          "non-finite reduced-depth loss or grad norm")
    check(max(rel.values()) <= TRAIN_RTOL,
          f"kernel train step differs from plain attention: {rel}")
    check(max(leaf_rel.values()) <= ATTN_GRAD_RTOL,
          f"kernel train step's attention-leaf grads differ from plain "
          f"attention: {leaf_rel}")


def expected_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps: each layer's forward runs
    once more in the backward pass under remat; dQ and dK/dV once."""
    L = cfg.n_layers * steps
    return {"fwd": (2 if cfg.remat else 1) * L, "dq": L, "dkv": L}


def counting_plain_delta(fa):
    """A patch that counts the calls of the plain row sum
    ``attention_delta``, and the list it counts in: the card path takes
    delta from the dQ kernel, so a run under the patch should make none."""
    from unittest import mock

    calls = []
    real = fa.attention_delta

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    return mock.patch.object(fa, "attention_delta", counted), calls


def reset_launches(fa) -> None:
    for fn in (fa.flash_attention_forward, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv):
        fn.launches = 0


def read_launches(fa) -> dict:
    return {"fwd": fa.flash_attention_forward.launches,
            "dq": fa.flash_attention_bwd_dq.launches,
            "dkv": fa.flash_attention_bwd_dkv.launches}


def phase_training(torch, seed, smi, peak_flops):
    """Full-depth Llama-3-1B: 3 warm-up and 5 timed AdamW steps on one
    batch of 4 x 2048 tokens, remat on, 256-token loss chunks."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = llama.LlamaConfig.llama3_1b()
    B, T, warmup, timed = 4, 2048, 3, 5
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), device="cuda",
                           generator=gen)
    init_state, train_step = llama.make_train_step(cfg)
    state = init_state(seed)
    torch.cuda.synchronize()

    reset_launches(fa)
    patch, delta_calls = counting_plain_delta(fa)
    with patch:
        losses = [train_step(state, tokens) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [train_step(state, tokens) for _ in range(timed)]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / timed
    launches = read_launches(fa)
    losses = [float(x) for x in losses]
    steps = warmup + timed
    L = cfg.n_layers
    check(all(math.isfinite(x) for x in losses),
          f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == expected_launches(cfg, steps),
          f"training launched {launches} over {steps} steps of {L} layers")
    check(not delta_calls, f"training took the plain delta "
                           f"{len(delta_calls)} times")
    peak_bytes = torch.cuda.max_memory_allocated()

    tokens_per_s = B * T / step_s
    n_params = cfg.num_params()
    # bench.py's MFU: 6 N per token, plus 6 L H T D per token for the
    # causal attention products
    model_flops = 6.0 * n_params * tokens_per_s
    attn_flops = 6.0 * L * cfg.n_heads * T * cfg.head_dim * tokens_per_s
    profile_ms(torch, torch.cuda.synchronize)  # profiler start-up
    prof = profile_ms(torch, lambda: train_step(state, tokens))
    emit({"phase": "training", "model": "llama3_1b", "n_layers": L,
          "dim": cfg.dim, "params": n_params, "batch": B, "T": T,
          "remat": cfg.remat, "loss_chunk": cfg.loss_chunk,
          "optimizer": "AdamW(lr=3e-4, betas=(0.9, 0.95), eps=1e-8, "
                       "weight_decay=0.1)",
          "card": smi, "warmup_steps": warmup, "timed_steps": timed,
          "step_ms": step_s * 1e3, "tokens_per_s": tokens_per_s,
          "mfu": model_flops / peak_flops,
          "mfu_with_attn": (model_flops + attn_flops) / peak_flops,
          "max_memory_allocated_bytes": peak_bytes, "losses": losses,
          "launches": launches, "plain_delta_calls": len(delta_calls),
          "profile_one_step": prof})
    return launches


def spmd_world(torch) -> int:
    """Ranks of the sharded step: one per card, up to 4, a power of two
    (so every layout below divides the 1B's heads)."""
    n = min(torch.cuda.device_count(), 4)
    return 4 if n == 4 else 2 if n >= 2 else 1


# a layout: (mesh spec, gather schedule, step, sequence length T, rows per
# batch shard at full depth)
def spmd_layouts(world: int):
    """The layouts the sharded steps run on: ``fsdp`` under both
    schedules and ``fsdp x tensor 2`` (``make_spmd_train_step``), then
    sequence parallelism (``make_mesh_train_step``): ``seq`` over every
    card at T 8192 and, on four, ``fsdp=2,seq=2`` and ``seq=2,tensor=2``
    at T 4096; on one card the size-1 mesh, where every collective is the
    identity."""
    if world == 1:
        return [("", "upfront", "spmd", 2048, 4)]
    tp = "tensor=2" if world == 2 else f"fsdp={world // 2},tensor=2"
    out = [(f"fsdp={world}", "streamed", "spmd", 2048, 4),
           (f"fsdp={world}", "upfront", "spmd", 2048, 4),
           (tp, "streamed", "spmd", 2048, 4),
           (f"seq={world}", "streamed", "mesh", 2048 * world, 4)]
    if world == 4:
        out += [("fsdp=2,seq=2", "streamed", "mesh", 4096, 4),
                ("seq=2,tensor=2", "streamed", "mesh", 4096, 4)]
    return out


def pipe_layouts(world: int):
    """(mesh spec, microbatches of 1 x 2048) of the pipeline step: every
    card a stage, and on four cards also two stages of tensor 2."""
    if world == 1:
        return []
    if world == 2:
        return [("pipe=2", 8)]
    return [("pipe=4", 16), ("pipe=2,tensor=2", 8)]


def rank_launches(cfg, steps: int, rep: dict, microbatches: int = 1) -> dict:
    """Kernel launches one rank makes in ``steps`` train steps: each layer
    call runs the forward twice under remat (once more in the backward)
    and each backward kernel once; a pipeline stage calls its L/P layers
    once a microbatch; seq rank r of a causal ring runs each kernel on
    r+1 K/V blocks a layer call."""
    sizes = rep["mesh"]
    calls = cfg.n_layers // sizes.get("pipe", 1) * microbatches * steps
    calls *= rep["coords"].get("seq", 0) + 1
    return {"fwd": (2 if cfg.remat else 1) * calls, "dq": calls,
            "dkv": calls}


def batch_shards(mesh: dict) -> int:
    return math.prod(mesh.get(a, 1) for a in ("slice", "data", "fsdp"))


def phase_spmd(torch, seed, smi, peak_flops, timeout=600.0):
    """The sharded steps in one rank per card over NCCL, launched through
    train/launch.py: ``make_spmd_train_step`` and ``make_mesh_train_step``
    (the ``spmd`` line) and ``make_pipeline_train_step`` (the ``pipe``
    line), one launch for all. Each layout at Llama-3-1B widths and
    reduced depth (2 layers; 4 for the pipeline, so every stage count
    divides it) against the single-device step on the same global batch
    (three steps' losses, the first step's global grad norm and wq/wk/wv
    grads, gathered), then at full depth: step time, tokens/s per card,
    peak memory per rank (beside the analytic param residency and the
    collective probes for the sharded step; beside the bubble for the
    pipeline). Every rank's kernel launches are read from its own counts
    and held to what its place on the mesh makes."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.launch import launch
    from ray_tpu_torch.train.spmd_runs import train_jobs

    world = spmd_world(torch)
    layouts = spmd_layouts(world)
    pipes = pipe_layouts(world)
    print(f"world: {world}", flush=True)
    full = llama.LlamaConfig.llama3_1b()
    # reduced depth: 2 layers, and for the pipeline one layer a stage
    reduced = {n: dataclasses.replace(full, n_layers=n) for n in
               {2, *(parse_mesh(mesh)["pipe"] for mesh, _ in pipes)}}
    T_ref, steps, warmup, timed = 2048, 3, 3, 5
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def tokens(rows, T):
        return torch.randint(0, full.vocab_size, (rows, T + 1), device="cuda",
                             generator=gen).cpu().numpy()

    # reduced depth: the global batch splits over the batch axes, so
    # `world` rows cover every layout; the pipeline's microbatches are its
    # rows, one each
    small = tokens(world, T_ref)
    leaves = [f"layers/{n}" for n in ("wq", "wk", "wv")]
    jobs = [dict(cfg=reduced[2], mesh=mesh, gather=gather, step=step,
                 init=seed, tokens=small, steps=steps, grads=leaves)
            for mesh, gather, step, _, _ in layouts]
    jobs += [dict(cfg=reduced[parse_mesh(mesh)["pipe"]], mesh=mesh,
                  step="pipeline", microbatches=world, init=seed,
                  tokens=small, steps=steps, grads=leaves)
             for mesh, _ in pipes]
    full_jobs = []
    for mesh, gather, step, T, rows in layouts:
        shards = batch_shards(parse_mesh(mesh))
        full_jobs.append(dict(cfg=full, mesh=mesh, gather=gather, step=step,
                              init=seed, tokens=tokens(rows * shards, T),
                              steps=warmup + timed, probes=True,
                              profile=SPMD_KERNEL_GROUPS))
    # the observability phase reads the first layout's observed
    # spmd.train_step, and the steady-state cost of observing it
    full_jobs[0]["observation_cost"] = OBSERVATION_CALLS
    for mesh, m in pipes:
        full_jobs.append(dict(cfg=full, mesh=mesh, step="pipeline",
                              microbatches=m, init=seed,
                              tokens=tokens(m, T_ref), steps=warmup + timed,
                              profile=SPMD_KERNEL_GROUPS))
    t0 = time.perf_counter()
    ranks = launch(train_jobs, world, (jobs + full_jobs,), timeout=timeout)
    launch_s = time.perf_counter() - t0

    # the single-device step on the same global batches, from the same seed
    refs = {}
    for n, cfg in reduced.items():
        init_state, train_step = llama.make_train_step(cfg)
        state = init_state(seed)
        ref = {"losses": []}
        for s_ in range(steps):
            ref["losses"].append(float(train_step(
                state, torch.from_numpy(small))))
            if s_ == 0:
                ref["grad_norm"] = _grad_norm(torch, state["params"])
                ref["leaves"] = {
                    path: getattr(state["params"].layers,
                                  path.split("/")[1]).grad.cpu()
                    for path in leaves}
        refs[n] = ref
        del state
        torch.cuda.empty_cache()

    def parity(j, microbatches=1):
        reps = [r[j] for r in ranks]
        cfg = jobs[j]["cfg"]
        rep, ref = reps[0], refs[cfg.n_layers]
        name = f"{rep['step']}:{jobs[j]['mesh'] or 'data=1'}" \
            + (f"/{rep['gather']}" if rep["gather"] else "")
        rel = [abs(a - b) / abs(b) for a, b in zip(rep["losses"],
                                                   ref["losses"])]
        gnorm_rel = abs(rep["grad_norm"] - ref["grad_norm"]) \
            / ref["grad_norm"]
        leaf_rel = {f"{path.split('/')[1]}[{i}]": (
            (torch.from_numpy(rep["grads"][path][i]) - want[i]).norm()
            / want[i].norm()).item()
            for path, want in ref["leaves"].items()
            for i in range(len(want))}
        want = [rank_launches(cfg, steps, r, microbatches) for r in reps]
        out = {"mesh": rep["mesh"], "gather": rep["gather"],
               "losses": rep["losses"],
               "single_device_losses": ref["losses"],
               "loss_rel_diff": rel, "grad_norm_rel_diff": gnorm_rel,
               "attn_leaf_rel_diff_worst": max(leaf_rel.values()),
               "launches_per_rank": [r["launches"] for r in reps]}
        check(all(math.isfinite(x) for x in rep["losses"]),
              f"{name}: non-finite losses {rep['losses']}")
        check(all(r["losses"] == rep["losses"] for r in reps),
              f"{name}: the ranks report different losses")
        check(max(rel) <= TRAIN_RTOL and gnorm_rel <= TRAIN_RTOL,
              f"{name}: sharded step differs from the single-device step: "
              f"loss {rel}, grad norm {gnorm_rel}")
        check(max(leaf_rel.values()) <= ATTN_GRAD_RTOL,
              f"{name}: sharded attention-leaf grads differ: {leaf_rel}")
        check([r["launches"] for r in reps] == want,
              f"{name}: ranks launched {[r['launches'] for r in reps]}, "
              f"want {want}")
        return name, out

    def full_depth(j, microbatches=1):
        reps = [r[j] for r in ranks]
        rep = reps[0]
        T = full_jobs[j - len(jobs)]["tokens"].shape[1] - 1
        step_ms = sum(rep["step_ms"][warmup:]) / timed
        global_batch = rep["local_batch"] * batch_shards(rep["mesh"])
        tokens_per_s = global_batch * T * 1e3 / step_ms
        want = [rank_launches(full, warmup + timed, r, microbatches)
                for r in reps]
        out = {"mesh": rep["mesh"], "gather": rep["gather"],
               "global_batch": global_batch, "T": T,
               "step_ms": step_ms, "step_ms_each": rep["step_ms"],
               "tokens_per_s": tokens_per_s,
               "tokens_per_s_per_card": tokens_per_s / world,
               "mfu": 6.0 * full.num_params() * tokens_per_s / world
               / peak_flops,
               "peak_bytes_per_rank": [r["peak_bytes"] for r in reps],
               "profile_one_step_rank0": rep["profile"],
               "losses": rep["losses"],
               "launches_per_rank": [r["launches"] for r in reps]}
        check(all(math.isfinite(x) for x in rep["losses"])
              and rep["losses"][-1] < rep["losses"][0],
              f"{rep['mesh']}: full-depth losses {rep['losses']}")
        check([r["launches"] for r in reps] == want,
              f"{rep['mesh']}: full depth launched "
              f"{[r['launches'] for r in reps]}, want {want}")
        return out, reps

    spmd_parity, timing = {}, {}
    for j in range(len(layouts)):
        name, spmd_parity[name] = parity(j)
        out, reps = full_depth(len(jobs) + j)
        rep = reps[0]
        out.update(param_residency_bytes=rep["residency"],
                   layers_gathered=rep["layers_gathered"],
                   probes_ms=[r["probes_ms"] for r in reps])
        timing[name] = out
        if rep["gather"] == "streamed" and "fsdp" in rep["mesh"]:
            check(rep["layers_gathered"]["peak_live"] <= 2,
                  f"{name}: streamed schedule held "
                  f"{rep['layers_gathered']['peak_live']} gathered layers")
    saving = {}
    for mesh in dict.fromkeys(m for m, _, _, _, _ in layouts):
        streamed = timing.get(f"spmd:{mesh}/streamed")
        upfront = timing.get(f"spmd:{mesh}/upfront")
        if streamed is None or upfront is None \
                or "fsdp" not in streamed["mesh"]:
            continue
        model = (upfront["param_residency_bytes"]["gathered_bytes"]
                 - streamed["param_residency_bytes"]["gathered_bytes"])
        got = (max(upfront["peak_bytes_per_rank"])
               - max(streamed["peak_bytes_per_rank"]))
        saving[mesh] = {"peak_bytes_saved": got,
                        "residency_model_bytes_saved": model}
        check(got >= STREAMED_SAVING_SHARE * model,
              f"{mesh}: the streamed schedule's peak is {got} bytes below "
              f"the upfront one's, want at least {STREAMED_SAVING_SHARE} "
              f"x the residency model's {model}")

    def launches_of(first, count):
        return {k: sum(r[first + j]["launches"][k]
                       for r in ranks for j in range(count))
                for k in ("fwd", "dq", "dkv")}

    n_full = len(jobs)
    observed = {"cfg": full, "layout": list(timing)[0],
                "T": full_jobs[0]["tokens"].shape[1] - 1,
                "reps": [r[n_full] for r in ranks],
                **{k: timing[list(timing)[0]][k]
                   for k in ("step_ms", "tokens_per_s", "global_batch")}}
    emit({"phase": "spmd", "world": world, "card": smi,
          "layouts": list(timing), "backend": "nccl", "launch_s": launch_s,
          "reduced_depth": {"n_layers": 2, "batch": world, "T": T_ref,
                            "steps": steps,
                            "rtol": TRAIN_RTOL,
                            "attn_leaf_rtol": ATTN_GRAD_RTOL,
                            "layouts": spmd_parity},
          "full_depth": {"model": "llama3_1b", "n_layers": full.n_layers,
                         "warmup_steps": warmup, "timed_steps": timed,
                         "layouts": timing,
                         "streamed_peak_saving": saving},
          "launches_full_depth_all_ranks": launches_of(n_full, len(layouts))})
    launches = {"spmd_all_ranks": launches_of(n_full, len(layouts))}
    if not pipes:
        print("pipe: the pipeline step needs two or more cards; this "
              "machine has one, so the pipe phase did not run", flush=True)
        return launches, observed
    pipe_parity, pipe_timing = {}, {}
    for i, (mesh, m) in enumerate(pipes):
        name, pipe_parity[name] = parity(len(layouts) + i, world)
        out, _ = full_depth(n_full + len(layouts) + i, m)
        P = parse_mesh(mesh)["pipe"]
        out.update(microbatches=m, microbatch_rows=1,
                   bubble=(P - 1) / (m + P - 1))
        pipe_timing[name] = out
    launches["pipe_all_ranks"] = launches_of(n_full + len(layouts),
                                             len(pipes))
    observed["pipe_step_ms"] = {name: t["step_ms"]
                                for name, t in pipe_timing.items()}
    emit({"phase": "pipe", "world": world, "card": smi,
          "layouts": list(pipe_timing), "backend": "nccl",
          "reduced_depth": {"n_layers": "one a stage", "batch": world,
                            "microbatches": world, "T": T_ref,
                            "steps": steps, "rtol": TRAIN_RTOL,
                            "attn_leaf_rtol": ATTN_GRAD_RTOL,
                            "layouts": pipe_parity},
          "full_depth": {"model": "llama3_1b", "n_layers": full.n_layers,
                         "warmup_steps": warmup, "timed_steps": timed,
                         "layouts": pipe_timing},
          "launches_full_depth_all_ranks": launches["pipe_all_ranks"]})
    return launches, observed


def trainer_windows(rows, batch: int, T: int):
    """Seconds from the loop's start to each report, from its cumulative
    ``tokens_per_sec`` (report i covers i steps of ``batch`` x ``T``
    tokens)."""
    return [r["step"] * batch * T / r["tokens_per_sec"] for r in rows]


def trainer_fit(loop, config, world: int, storage: str, name: str,
                **kw):
    """``TorchTrainer(loop)`` over ``world`` workers of a card each;
    returns the reports that carry a loss, the probe row's ranks
    (``spmd_runs._probed``) and the result."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    result = TorchTrainer(
        loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=world, use_gpu=True),
        run_config=RunConfig(name=name, storage_path=storage), **kw).fit()
    check(result.error is None, f"trainer {name}: {result.error}")
    rows = result.metrics_dataframe
    probe = [r for r in rows if "ranks" in r]
    check(len(probe) == 1, f"trainer {name}: no probe row")
    return [r for r in rows if "loss" in r or "losses" in r], \
        probe[0]["ranks"], result


def hold_ranks(name: str, ranks, world: int, want: dict) -> None:
    """The probe's gates: one card a worker and no card shared, the
    kernels' launches exact on every rank, no JAX or ``ray_tpu`` module
    in any worker."""
    uuids = [r["uuid"] for r in ranks]
    check(all(r["device_count"] == 1 for r in ranks),
          f"trainer {name}: a worker sees "
          f"{[r['device_count'] for r in ranks]} cards, want 1")
    check(len(set(uuids)) == world,
          f"trainer {name}: the workers share cards: {uuids}")
    check([r["launches"] for r in ranks] == [want] * world,
          f"trainer {name}: ranks launched "
          f"{[r['launches'] for r in ranks]}, want {want} each")
    check(not any(r["foreign_modules"] for r in ranks),
          f"trainer {name}: a worker loaded "
          f"{[r['foreign_modules'] for r in ranks]}")


def hold_losses(name: str, got, want, world: int,
                same_program: bool = False) -> dict:
    """``got`` against ``want``: bitwise on one card, within rtol 3e-3
    across cards. ``same_program``: both runs are one program on one
    layout and only the path of the rows or a restart lies between them,
    so the losses must be bitwise equal on any number of cards (a batch
    read twice or skipped, or rows dealt to the wrong rank, would move
    them by less than the rtol)."""
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    bitwise = world == 1 or same_program
    check(len(got) == len(want), f"{name}: {len(got)} losses, want "
          f"{len(want)}")
    if bitwise:
        check(got == want, f"{name}: {got} != {want} (bitwise)")
    else:
        check(max(rel) <= TRAIN_RTOL, f"{name}: {got} vs {want}, rel {rel}")
    return {"losses": got, "reference_losses": want, "loss_rel_diff": rel,
            "bitwise": got == want,
            "rule": "bitwise" if bitwise else f"rtol {TRAIN_RTOL}"}


def phase_trainer_paths(torch, seed, smi, peak_flops, trained,
                        timeout=600.0):
    """The runtime's paths on one ``init()``: ``trainer`` (the default
    loop on the synthetic stream), then ``ingest`` (the full-depth fit on
    distinct batches, from the stream and fed by a dataset of its rows)
    and ``checkpoint`` (save, restore, continue). Returns each
    path's launches over all ranks."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt

    world = spmd_world(torch)
    storage = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    rt.init()
    try:
        launches, synthetic = phase_trainer(torch, seed, smi, peak_flops,
                                            trained, world, storage,
                                            timeout)
        launches.update(phase_ingest(torch, smi, peak_flops, synthetic,
                                     world, storage))
        launches.update(phase_checkpoint(torch, seed, smi, world, storage))
        return launches
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)


def phase_trainer(torch, seed, smi, peak_flops, trained, world, storage,
                  timeout=600.0):
    """``TorchTrainer`` on the port's runtime, one worker actor a card (up
    to 4): ``init()`` with no ``num_gpus`` must find the cards; the
    default loop (``train/spmd.py:spmd_train_loop``, wrapped by
    ``spmd_runs.trainer_probe_loop``, which reads each worker's card,
    launches, peak memory and modules around it) at Llama-3-1B widths on
    ``fsdp`` over every worker (the size-1 mesh on one card): 2 layers, 3
    steps from seed 0, held against ``train/launch.py``'s ``train_jobs``
    on the same synthetic batch (bitwise on one card, rtol 3e-3 across
    cards); then full depth, B 4 x 2048 a worker, 3 warm-up and 5 timed
    steps, beside the ``spmd`` phase's first layout in this run. Returns
    the launches and that full-depth fit's settings, for the ``ingest``
    phase."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.launch import launch
    from ray_tpu_torch.train.spmd import _synthetic_token_batches
    from ray_tpu_torch.train.spmd_runs import train_jobs, trainer_probe_loop

    mesh = f"fsdp={world}"
    full = llama.LlamaConfig.llama3_1b()
    reduced = dataclasses.replace(full, n_layers=2)
    T, steps, warmup, timed, per_worker = 2048, 3, 3, 5, 4
    t0 = time.perf_counter()
    gpus = rt.cluster_resources().get("GPU", 0)
    print(f"trainer: the runtime found {gpus:g} GPUs; {world} workers",
          flush=True)
    check(gpus >= world, f"the runtime found {gpus} GPUs, want at least "
          f"{world}")

    def fit(cfg, n_steps, rows, name):
        return trainer_fit(
            trainer_probe_loop,
            {"llama_config": cfg, "steps": n_steps, "seq": T, "seed": seed,
             "mesh": mesh, "batch_per_device": rows, "distinct_batches": 1},
            world, storage, name)[:2]

    def hold(name, cfg, n_steps, reports, ranks):
        hold_ranks(name, ranks, world, rank_launches(
            cfg, n_steps, {"mesh": {"fsdp": world}, "coords": {}}))
        losses = [r["loss"] for r in reports]
        check(len(losses) == n_steps
              and all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"trainer {name}: losses {losses}")
        return losses

    reports, ranks = fit(reduced, steps, 1, "parity")
    got = hold("parity", reduced, steps, reports, ranks)
    tokens = next(_synthetic_token_batches(full.vocab_size, world, T,
                                           seed, distinct=1))
    ref = launch(train_jobs, world, ([dict(
        cfg=reduced, mesh=mesh, init=seed, tokens=tokens,
        steps=steps)],), timeout=timeout)[0][0]["losses"]
    held = hold_losses("trainer parity", got, ref, world)
    parity = {"n_layers": reduced.n_layers, "steps": steps,
              "global_batch": world, "T": T, "losses": got,
              "launch_path_losses": ref,
              "loss_rel_diff": held["loss_rel_diff"],
              "bitwise": held["bitwise"], "rule": held["rule"],
              "launches_per_rank": [r["launches"] for r in ranks]}

    n = warmup + timed
    reports, ranks = fit(full, n, per_worker, "full")
    losses = hold("full", full, n, reports, ranks)
    batch = per_worker * world
    at = trainer_windows(reports, batch, T)
    step_ms = (at[-1] - at[warmup - 1]) / timed * 1e3
    tokens_per_s = timed * batch * T / (at[-1] - at[warmup - 1])
    full_depth = {
        "n_layers": full.n_layers, "global_batch": batch, "T": T,
        "warmup_steps": warmup, "timed_steps": timed,
        "step_ms": step_ms,
        "step_ms_each": [(b - a) * 1e3 for a, b in
                         zip([0.0] + at[:-1], at)],
        "tokens_per_s_per_card": tokens_per_s / world,
        "mfu": 6.0 * full.num_params() * tokens_per_s / world
        / peak_flops,
        "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
        "ingest_wait_ms_per_step": ingest_wait_ms(ranks, n),
        "losses": losses,
        "launches_per_rank": [r["launches"] for r in ranks],
        "launch_path": {"layout": trained["layout"],
                        "step_ms": trained["step_ms"]},
        "step_ms_over_launch_path": step_ms / trained["step_ms"]}
    emit({"phase": "trainer", "world": world, "card": smi,
          "gpus_detected": gpus, "mesh": mesh, "backend": "nccl",
          "cards": [{"rank": r["rank"], "uuid": r["uuid"],
                     "cuda_visible_devices": r["cuda_visible_devices"]}
                    for r in ranks],
          "reduced_depth": parity, "full_depth": full_depth,
          "phase_s": time.perf_counter() - t0})
    launches = {k: sum(r["launches"][k] for r in ranks)
                + sum(x[k] for x in parity["launches_per_rank"])
                for k in ("fwd", "dq", "dkv")}
    synthetic = {"cfg": full, "seed": seed, "T": T, "warmup": warmup,
                 "timed": timed, "per_worker": per_worker, "mesh": mesh,
                 "step_ms": step_ms}
    return {"trainer_all_ranks": launches}, synthetic


def ingest_wait_ms(ranks, steps: int) -> list:
    """Each rank's ``spmd.ingest_wait`` ms a step, from its probe: the
    waits the flight recorder kept (those of at least its
    ``flight_recorder_min_span_us`` floor, 500 us by default) over the
    steps, so a lower bound."""
    return [r["spans"].get("spmd.ingest_wait", {"s": 0.0})["s"] * 1e3
            / steps for r in ranks]


def phase_ingest(torch, smi, peak_flops, synthetic, world, storage):
    """The ``trainer`` phase's full-depth fit on distinct batches, twice:
    first from the synthetic stream with no batch repeated
    (``distinct_batches`` = the steps), then through
    ``TorchTrainer(datasets={"train": from_numpy(rows)})``, the rows
    being that stream's batches in order, which the default loop reads
    through ``to_device`` (pinned, double-buffered, each rank its
    ``batch_sharding`` rows). Gates: the two fits' losses bitwise equal
    on any number of cards (one program on one layout, only the path of
    the rows differs), launches exact on every rank, no JAX or
    ``ray_tpu`` module in any worker. Prints step ms beside the
    synthetic fit's, ``spmd.ingest_wait`` ms a step and peak bytes a
    rank."""
    import numpy as np

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.core.config import global_config
    from ray_tpu_torch.train.spmd import _synthetic_token_batches
    from ray_tpu_torch.train.spmd_runs import trainer_probe_loop

    cfg, T, seed = synthetic["cfg"], synthetic["T"], synthetic["seed"]
    warmup, timed = synthetic["warmup"], synthetic["timed"]
    n = warmup + timed
    batch = synthetic["per_worker"] * world
    want = rank_launches(cfg, n, {"mesh": {"fsdp": world}, "coords": {}})
    config = {"llama_config": cfg, "steps": n, "seq": T, "seed": seed,
              "mesh": synthetic["mesh"],
              "batch_per_device": synthetic["per_worker"]}
    t0 = time.perf_counter()

    def fit(name, **kw):
        reports, ranks, _ = trainer_fit(trainer_probe_loop, config, world,
                                        storage, name, **kw)
        hold_ranks(name, ranks, world, want)
        at = trainer_windows(reports, batch, T)
        return ([r["loss"] for r in reports], ranks,
                (at[-1] - at[warmup - 1]) / timed * 1e3)

    config["distinct_batches"] = n
    ref, ref_ranks, ref_ms = fit("ingest_synthetic")
    del config["distinct_batches"]
    stream = _synthetic_token_batches(cfg.vocab_size, batch, T, seed,
                                      distinct=n)
    rows = np.concatenate([next(stream) for _ in range(n)])
    losses, ranks, step_ms = fit(
        "ingest", datasets={"train": rd.from_numpy(rows, column="tokens")})
    check(len(ref) == n and all(math.isfinite(x) for x in ref),
          f"ingest: synthetic fit losses {ref}")
    held = hold_losses("ingest vs the synthetic fit", losses, ref, world,
                       same_program=True)
    emit({"phase": "ingest", "world": world, "card": smi,
          "mesh": synthetic["mesh"], "dataset_rows": int(rows.shape[0]),
          "distinct_batches": n, "n_layers": cfg.n_layers,
          "global_batch": batch, "T": T, "warmup_steps": warmup,
          "timed_steps": timed, "step_ms": step_ms,
          "synthetic_step_ms": ref_ms,
          "step_ms_over_synthetic": step_ms / ref_ms,
          "trainer_phase_step_ms": synthetic["step_ms"],
          "tokens_per_s_per_card": batch * T / step_ms * 1e3 / world,
          "mfu": 6.0 * cfg.num_params() * batch * T / step_ms * 1e3
          / world / peak_flops,
          "ingest_wait_ms_per_step": ingest_wait_ms(ranks, n),
          "synthetic_ingest_wait_ms_per_step": ingest_wait_ms(ref_ranks, n),
          "ingest_wait_floor_us":
              global_config().flight_recorder_min_span_us,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
          "launches_per_rank": [r["launches"] for r in ranks], **held,
          "phase_s": time.perf_counter() - t0})
    return {"ingest_all_ranks": {
        k: sum(r["launches"][k] for rs in (ref_ranks, ranks) for r in rs)
        for k in ("fwd", "dq", "dkv")}}


def phase_checkpoint(torch, seed, smi, world, storage):
    """Save, restore, continue through ``TorchTrainer`` at Llama-3-1B
    widths and 2 layers on ``fsdp`` over every worker, B 4 x 2048 a
    worker, six distinct synthetic batches
    (``spmd_runs.checkpoint_probe_loop``): run A takes 6 steps; run B
    takes 3, saves (``train/dcp_checkpoint.py:save_torch_state``) and
    reports the checkpoint; run C resumes from it
    (``resume_from_checkpoint``) and takes 3 more. Gates: C's losses
    equal A's steps 4-6 bitwise on any number of cards (one program on
    one layout; a restart from the wrong step or batch moves them),
    and every rank's restored param and AdamW moment shards hash to what
    it saved; launches exact on every rank. Prints save and restore
    seconds, bytes and GB/s."""
    import shutil

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.spmd import _synthetic_token_batches
    from ray_tpu_torch.train.spmd_runs import checkpoint_probe_loop

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_1b(), n_layers=2)
    T, per_worker, mesh = 2048, 4, f"fsdp={world}"
    t0 = time.perf_counter()
    stream = _synthetic_token_batches(cfg.vocab_size, per_worker * world,
                                      T, seed, distinct=6)
    batches = [next(stream) for _ in range(6)]
    ckpt = f"{storage}/saved_b"  # beside the runs' own directories
    want = {n: rank_launches(cfg, n, {"mesh": {"fsdp": world},
                                      "coords": {}}) for n in (3, 6)}

    def fit(name, steps, **kw):
        job = {"cfg": cfg, "init": seed, "batches": batches,
               "steps": steps, **kw.pop("job", {})}
        _, ranks, result = trainer_fit(
            checkpoint_probe_loop, {"mesh": mesh, "job": job}, world,
            storage, f"checkpoint_{name}", **kw)
        hold_ranks(f"checkpoint {name}", ranks, world, want[steps])
        return [r["result"] for r in ranks], ranks, result

    a, ranks_a, _ = fit("a", 6)
    b, ranks_b, result_b = fit("b", 3, job={"save": ckpt})
    check(result_b.checkpoint is not None, "checkpoint b: no checkpoint")
    free_gb = shutil.disk_usage(storage).free / 1e9
    shutil.rmtree(ckpt)  # the trainer keeps its copy
    c, ranks_c, _ = fit("c", 3, resume_from_checkpoint=result_b.checkpoint)
    held = hold_losses("checkpoint: resumed vs uninterrupted",
                       c[0]["losses"], a[0]["losses"][3:], world,
                       same_program=True)
    check(b[0]["losses"] == a[0]["losses"][:3],
          f"checkpoint: run b {b[0]['losses']} is not run a's first steps "
          f"{a[0]['losses'][:3]}")
    for rb, rc in zip(b, c):
        bad = sorted(k for k in rb["saved"]
                     if rb["saved"][k] != rc["restored"].get(k))
        check(not bad and set(rb["saved"]) == set(rc["restored"]),
              f"checkpoint: rank {rb['rank']} restored {bad} unlike it "
              f"saved them")
    save_s = max(r["save_s"] for r in b)
    restore_s = max(r["restore_s"] for r in c)
    emit({"phase": "checkpoint", "world": world, "card": smi, "mesh": mesh,
          "n_layers": cfg.n_layers, "global_batch": per_worker * world,
          "T": T, "losses_a": a[0]["losses"], "losses_b": b[0]["losses"],
          "losses_c": c[0]["losses"], **held,
          "keys_per_rank": len(b[0]["saved"]),
          "save_s": save_s, "save_bytes": b[0]["save_bytes"],
          "save_gb_per_s": b[0]["save_bytes"] / save_s / 1e9,
          "restore_s": restore_s, "restore_bytes": c[0]["restore_bytes"],
          "restore_gb_per_s": c[0]["restore_bytes"] / restore_s / 1e9,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks_c],
          "disk_free_gb_after_save": free_gb,
          "phase_s": time.perf_counter() - t0})
    return {"checkpoint_all_ranks": {
        k: sum(r["launches"][k] for rs in (ranks_a, ranks_b, ranks_c)
               for r in rs) for k in ("fwd", "dq", "dkv")}}


def routing_patch(n_layers: int, replay=None):
    """A patch of ``ops/moe.py``'s ``expert_choices`` for one step's
    forward (its first ``n_layers`` calls, one a layer; run the step
    without remat when replaying): it records the experts each token of
    each layer chooses before capacity and, given ``replay`` (``[L, B,
    T, k]``, another run's record), routes the layer by those instead.
    Returns the patch and the list it records in."""
    from unittest import mock

    from ray_tpu_torch.ops import moe

    seen = []
    real = moe.expert_choices

    def choices(probs, top_k):
        own = real(probs, top_k)
        layer = len(seen)
        if layer >= n_layers:
            return own
        seen.append(own.cpu())
        return own if replay is None else replay[layer].to(own.device)

    return mock.patch.object(moe, "expert_choices", choices), seen


def routing_agreement(torch, got, want) -> float:
    """The share of (layer, token, choice) expert picks that agree."""
    return (torch.as_tensor(got).long() == torch.as_tensor(want).long()) \
        .float().mean().item()


def moe_layouts(world: int):
    """(mesh spec, gather schedule) of the MoE step across cards: every
    card an expert rank, or a tensor rank; on four also fsdp 2 x expert
    2, tensor 2 inside each of 2 expert ranks, and seq 2 x expert 2."""
    if world == 1:
        return []
    if world == 2:
        return [("expert=2", "streamed"), ("tensor=2", "streamed")]
    return [("expert=4", "streamed"), ("fsdp=2,expert=2", "streamed"),
            ("expert=2,tensor=2", "streamed"),
            ("seq=2,expert=2", "streamed")]


def moe_row_blocks(mesh: dict) -> int:
    """The blocks the MoE step splits the global batch's rows into: its
    batch shards times its expert ranks (tensor and seq ranks share a
    block's rows)."""
    return batch_shards(mesh) * mesh.get("expert", 1)


def moe_routing(torch, reps) -> "torch.Tensor":
    """The global batch's expert picks ``[L, B, T, k]`` from the ranks'
    reports: each block of rows laid out by its positions (seq), the
    blocks in row order; the ranks that share a block (a tensor group)
    recorded the same picks."""
    blocks = {}
    for r in reps:
        blocks.setdefault(tuple(r["rows"]), {})[tuple(r["positions"])] = \
            r["routing"]
    return torch.cat([torch.cat([torch.from_numpy(by_pos[p]).long()
                                 for p in sorted(by_pos)], dim=2)
                      for _, by_pos in sorted(blocks.items())], dim=1)


def tensor_routing_agrees(reps) -> bool:
    """Every tensor group's ranks made the same picks in every layer: the
    checksums each rank all-gathered over its group are equal."""
    return all(r["tensor_checksums"] is None
               or all(c == r["tensor_checksums"][0]
                      for c in r["tensor_checksums"]) for r in reps)


def moe_flops_per_token(cfg, T: int) -> float:
    """The model work of one token of an MoE train step: 6 times the
    active params (every expert but its top-k left out) plus 6 L H T D
    for causal attention. The dispatch and combine products and the
    capacity slots' padding are overhead, not model work."""
    return 6.0 * cfg.active_params() \
        + 6.0 * cfg.n_layers * cfg.n_heads * T * cfg.head_dim


def phase_moe(torch, seed, smi, peak_flops, timeout=600.0):
    """The MoE decoder (``models/moe_llama.py``) at ``MoEConfig.small``
    widths, bf16 compute, remat, random weights from ``seed``:

    - one card, 2 layers, B 4 x 2048: one step through the kernels
      against the same step through plain attention (loss, grad norm,
      each layer's wq/wk/wv grads, routing agreement), launches exact and
      no plain delta;
    - one card, full depth (12 layers), B 4 x 2048: 3 warm-up and 5
      timed steps, tokens/s, MFU on the active params, peak memory, a
      profile of one step, launches exact;
    - two or four cards, one rank a card (``make_moe_train_step`` in
      ``spmd_runs.moe_jobs``, one launch): each layout at 2 layers
      against the single-card step on the same params and global batch
      (loss, grad norm, leaves, routing), then at full depth with 4 rows
      a block of rows (tensor and seq ranks share a block: ``seq`` ranks
      hold 1024 of its 2048 positions): step time, tokens/s per card,
      peak per rank, rank 0's profile with NCCL's device time by
      collective, every rank's launches; under ``tensor``, each layer's
      picks equal across each tensor group (checksums all-gathered in
      the ranks), at both depths.
    Returns the full-depth runs' launches by path: the one card's, and
    each layout's over all its ranks."""
    from unittest import mock

    from ray_tpu_torch.models import moe_llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train.launch import launch
    from ray_tpu_torch.train.spmd_runs import moe_jobs

    full = moe_llama.MoEConfig.small()
    reduced = dataclasses.replace(full, n_layers=2)
    B, T, warmup, timed, steps = 4, 2048, 3, 5, 3
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def tokens(rows):
        return torch.randint(0, full.vocab_size, (rows, T + 1),
                             device="cuda", generator=gen)

    leaves = ("wq", "wk", "wv")

    def steps_of(cfg, batch, n, patch=None, replay=None):
        """n steps of the single-card step from ``seed`` (the first one's
        routing recorded, or replayed from ``replay`` without remat):
        losses, the first step's grad norm, wq/wk/wv grads and routing."""
        if replay is not None:
            cfg = dataclasses.replace(cfg, remat=False)
        init_state, train_step = moe_llama.make_train_step(cfg)
        state = init_state(seed)
        route, seen = routing_patch(cfg.n_layers, replay)
        out = {"losses": []}
        with route, (patch or contextlib.nullcontext()):
            for i in range(n):
                out["losses"].append(float(train_step(state, batch)))
                if i == 0:
                    out["grad_norm"] = _grad_norm(torch, state["params"])
                    out["leaves"] = {
                        name: getattr(state["params"].layers, name).grad
                        .clone() for name in leaves}
        out["routing"] = torch.stack(seen)
        del state
        torch.cuda.empty_cache()
        return out

    def compare(got, ref, name, held):
        """Losses and grad norm within TRAIN_RTOL, always; with ``held``
        (``ref`` replayed ``got``'s routing) each layer's wq/wk/wv grads
        within ATTN_GRAD_RTOL and its own picks agreeing with ``got``'s
        in at least ROUTING_AGREEMENT_MIN of (token, choice)s."""
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   ref["losses"])]
        gnorm = abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        leaf = {f"{n}[{i}]": ((torch.as_tensor(got["leaves"][n][i]).cuda()
                               - ref["leaves"][n][i]).norm()
                              / ref["leaves"][n][i].norm()).item()
                for n in leaves for i in range(len(ref["leaves"][n]))}
        agree = [routing_agreement(torch, a, b)
                 for a, b in zip(got["routing"], ref["routing"])]
        check(all(math.isfinite(x) for x in got["losses"]),
              f"{name}: non-finite losses {got['losses']}")
        check(max(rel) <= TRAIN_RTOL and gnorm <= TRAIN_RTOL,
              f"{name}: loss {rel}, grad norm {gnorm} beyond {TRAIN_RTOL}")
        if held:
            check(max(leaf.values()) <= ATTN_GRAD_RTOL,
                  f"{name}: attention-leaf grads differ: {leaf}")
            check(min(agree) >= ROUTING_AGREEMENT_MIN,
                  f"{name}: routing agreement by layer {agree}")
        return {"loss_rel_diff": rel, "grad_norm_rel_diff": gnorm,
                "attn_leaf_rel_diff_worst": max(leaf.values()),
                "routing_agreement_by_layer": agree}

    # one card, reduced depth: kernels against plain attention, the plain
    # run free and with the kernel run's routing replayed
    batch = tokens(B)
    reset_launches(fa)
    patch, delta_calls = counting_plain_delta(fa)
    kern = steps_of(reduced, batch, 1, patch)
    counts = read_launches(fa)
    check(counts == expected_launches(reduced, 1),
          f"MoE reduced-depth step launched {counts}")
    check(not delta_calls, f"the MoE kernel step took the plain delta "
                           f"{len(delta_calls)} times")

    def plain_attention():
        return mock.patch.object(
            moe_llama, "flash_attention",
            lambda q, k, v, causal: fa.flash_attention_reference(
                q, k, v, causal)[0])

    free = steps_of(reduced, batch, 1, plain_attention())
    held = steps_of(reduced, batch, 1, plain_attention(), kern["routing"])
    one_card = {"losses": kern["losses"], "plain_losses": held["losses"],
                "launches": counts, "plain_delta_calls": len(delta_calls),
                "routing_replayed": compare(kern, held, "moe one card vs "
                                            "plain attention", True),
                "free_running": compare(kern, free, "moe one card vs plain "
                                        "attention, free-running", False)}
    del kern, free, held

    # one card, full depth: timed steps
    batch = tokens(B)
    init_state, train_step = moe_llama.make_train_step(full)
    state = init_state(seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    patch, delta_calls = counting_plain_delta(fa)
    with patch:
        losses = [train_step(state, batch) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [train_step(state, batch) for _ in range(timed)]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / timed
    train_launches = read_launches(fa)
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"MoE full-depth losses {losses}")
    check(train_launches == expected_launches(full, warmup + timed),
          f"MoE training launched {train_launches} over {warmup + timed} "
          f"steps of {full.n_layers} layers")
    check(not delta_calls, f"MoE training took the plain delta "
                           f"{len(delta_calls)} times")
    tokens_per_s = B * T / step_s
    profile_ms(torch, torch.cuda.synchronize)  # profiler start-up
    prof = profile_ms(torch, lambda: train_step(state, batch))
    single = {"batch": B, "T": T, "warmup_steps": warmup,
              "timed_steps": timed, "step_ms": step_s * 1e3,
              "tokens_per_s": tokens_per_s,
              "mfu_active": moe_flops_per_token(full, T) * tokens_per_s
              / peak_flops,
              "max_memory_allocated_bytes": peak_bytes, "losses": losses,
              "launches": train_launches,
              "plain_delta_calls": len(delta_calls),
              "profile_one_step": prof}
    del state, train_step, init_state
    gc.collect()
    torch.cuda.empty_cache()

    # across cards
    world = spmd_world(torch)
    layouts = moe_layouts(world)
    mesh_out, mesh_launches = {}, {}
    if layouts:
        small = tokens(world).cpu().numpy()
        grads = [f"layers/{n}" for n in leaves]
        jobs = [dict(cfg=reduced, mesh=mesh, gather=gather, init=seed,
                     tokens=small, steps=steps, grads=grads)
                for mesh, gather in layouts]
        jobs += [dict(cfg=full, mesh=mesh, gather=gather, init=seed,
                      tokens=tokens(4 * moe_row_blocks(parse_mesh(mesh)))
                      .cpu().numpy(),
                      steps=warmup + timed, profile=MOE_KERNEL_GROUPS)
                 for mesh, gather in layouts]
        t0 = time.perf_counter()
        ranks = launch(moe_jobs, world, (jobs,), timeout=timeout)
        launch_s = time.perf_counter() - t0
        for j, (mesh, gather) in enumerate(layouts):
            reps = [r[j] for r in ranks]
            check(tensor_routing_agrees(reps),
                  f"moe {mesh}: a tensor group's ranks routed apart: "
                  f"{[r['tensor_checksums'] for r in reps]}")
            routing = moe_routing(torch, reps)
            # the single card on the same batch, replaying the mesh's
            # routing in its first step
            ref = steps_of(reduced, torch.from_numpy(small), steps,
                           replay=routing)
            got = {"losses": reps[0]["losses"],
                   "grad_norm": reps[0]["grad_norm"],
                   "leaves": {n: torch.from_numpy(
                       reps[0]["grads"][f"layers/{n}"]) for n in leaves},
                   "routing": routing}
            check(all(r["losses"] == reps[0]["losses"] for r in reps),
                  f"moe {mesh}: the ranks report different losses")
            want = [rank_launches(reduced, steps, r) for r in reps]
            check([r["launches"] for r in reps] == want,
                  f"moe {mesh}: ranks launched "
                  f"{[r['launches'] for r in reps]}, want {want}")
            parity = {"single_card_losses": ref["losses"],
                      "launches_per_rank": [r["launches"] for r in reps],
                      **compare(got, ref, f"moe {mesh}", True)}

            reps = [r[len(layouts) + j] for r in ranks]
            rep = reps[0]
            check(tensor_routing_agrees(reps),
                  f"moe {mesh}: at full depth a tensor group's ranks "
                  f"routed apart: {[r['tensor_checksums'] for r in reps]}")
            step_ms = sum(rep["step_ms"][warmup:]) / timed
            rows = len(jobs[len(layouts) + j]["tokens"])
            per_s = rows * T * 1e3 / step_ms
            want = [rank_launches(full, warmup + timed, r) for r in reps]
            check(all(math.isfinite(x) for x in rep["losses"])
                  and rep["losses"][-1] < rep["losses"][0],
                  f"moe {mesh}: full-depth losses {rep['losses']}")
            check([r["launches"] for r in reps] == want,
                  f"moe {mesh}: full depth launched "
                  f"{[r['launches'] for r in reps]}, want {want}")
            prof_r0 = rep["profile"]
            nccl = {g: ms for g, ms in prof_r0["device_ms_by_group"].items()
                    if g.startswith("nccl")}
            mesh_out[mesh] = {
                "gather": rep["gather"], "reduced_depth": parity,
                "global_batch": rows, "rows_per_block": 4, "T": T,
                "positions_per_rank": T // parse_mesh(mesh).get("seq", 1),
                "tensor_checksums_rank0": rep["tensor_checksums"],
                "step_ms": step_ms, "step_ms_each": rep["step_ms"],
                "tokens_per_s": per_s, "tokens_per_s_per_card": per_s / world,
                "mfu_active": moe_flops_per_token(full, T) * per_s / world
                / peak_flops,
                "peak_bytes_per_rank": [r["peak_bytes"] for r in reps],
                "nccl_device_ms_by_collective_rank0": nccl
                or "not measured",
                "profile_one_step_rank0": prof_r0,
                "losses": rep["losses"],
                "launches_per_rank": [r["launches"] for r in reps]}
            mesh_launches[f"moe_{mesh}_all_ranks"] = {
                k: sum(r["launches"][k] for r in reps)
                for k in ("fwd", "dq", "dkv")}
    else:
        launch_s = None
        print("moe: the expert-parallel step needs two or more cards; this "
              "machine has one, so its layouts did not run", flush=True)
    emit({"phase": "moe", "model": "MoEConfig.small", "card": smi,
          "dim": full.dim, "n_layers": full.n_layers,
          "heads": [full.n_heads, full.n_kv_heads],
          "experts": full.num_experts, "top_k": full.top_k,
          "capacity_factor": full.capacity_factor,
          "params": full.num_params(), "active_params": full.active_params(),
          "mfu_note": "6 x active params + 6 L H T D per token against the "
                      "bf16 peak; dispatch/combine einsums and capacity "
                      "padding counted as overhead, not model work",
          "one_card_reduced_depth": {"n_layers": reduced.n_layers,
                                     "batch": B, "T": T,
                                     "rtol": TRAIN_RTOL,
                                     "attn_leaf_rtol": ATTN_GRAD_RTOL,
                                     "routing_min": ROUTING_AGREEMENT_MIN,
                                     **one_card},
          "one_card_full_depth": single,
          "world": world, "launch_s": launch_s, "layouts": mesh_out})
    return {"moe_training": train_launches, **mesh_launches}


def parse_mesh(spec: str) -> dict:
    """``"fsdp=2,seq=2"`` -> ``{"fsdp": 2, "seq": 2}``."""
    return {a: int(n) for a, n in (p.split("=") for p in spec.split(",")
                                   if p)}


def phase_reduced_depth(torch, seed):
    from unittest import mock

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import (flash_attention_forward,
                                                   flash_attention_reference)

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.compute_params(
        cfg, llama.init_params(cfg, gen, "cuda"), "cuda")
    T = 1000
    tokens = torch.randint(0, cfg.vocab_size, (1, T), device="cuda",
                           generator=gen)
    with torch.inference_mode():
        before = flash_attention_forward.launches
        kern, _, _ = llama.prefill_with_cache(cfg, params, tokens)
        check(flash_attention_forward.launches - before == cfg.n_layers,
              "reduced-depth prefill did not launch the kernel per layer")
        with mock.patch.object(
                llama, "flash_attention",
                lambda q, k, v, causal: flash_attention_reference(
                    q, k, v, causal)[0]):
            plain, _, _ = llama.prefill_with_cache(cfg, params, tokens)
    check(bool(torch.isfinite(kern).all()), "non-finite prefill logits")
    diff = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    top1 = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    emit({"phase": "reduced_depth_prefill", "n_layers": cfg.n_layers,
          "dim": cfg.dim, "T": T, "max_abs_diff": diff,
          "max_abs_logit": scale, "rel_diff": diff / scale,
          "rel_tolerance": LOGITS_REL_TOL, "top1_agreement": top1})
    check(diff <= LOGITS_REL_TOL * scale,
          f"kernel prefill logits differ from plain: {diff} vs max "
          f"|logit| {scale}")


def phase_serving(torch, np, seed, smi):
    from unittest import mock

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import (flash_attention_forward,
                                                   flash_attention_reference)
    from ray_tpu_torch.serve.decode import DecodeScheduler
    from ray_tpu_torch.util import flight_recorder as fr

    cfg = llama.LlamaConfig.llama3_8b()
    # record every span, however short (a prefix hit's admission is
    # shorter than the default floor), so the observability phase can
    # hold the span counts to the scheduler's
    fr.configure(min_span_us=0.0)
    t0 = time.perf_counter()
    engine = llama.LlamaDecodeEngine(cfg, n_pages=512, page_size=16,
                                     seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # each kind's padded lengths in the order first served: the engine's
    # programs analyse their first new fingerprints and count the rest
    stats = {"prefill_s": [], "prefill_tokens": 0, "decode_s": [],
             "finite": True, "tpads": {"prefill": [], "decode": []}}
    prefill, decode = engine.prefill, engine.decode

    def note_tpad(kind, pages):
        tpads = stats["tpads"][kind]
        if len(pages) * engine.page_size not in tpads:
            tpads.append(len(pages) * engine.page_size)

    def timed_prefill(tokens, pages):
        note_tpad("prefill", pages)
        t = time.perf_counter()
        out = prefill(tokens, pages)
        stats["prefill_s"].append(time.perf_counter() - t)
        stats["prefill_tokens"] += len(tokens)
        stats["finite"] &= bool(np.isfinite(out).all())
        return out

    def timed_decode(pos, token, pages):
        note_tpad("decode", pages)
        t = time.perf_counter()
        out = decode(pos, token, pages)
        stats["decode_s"].append(time.perf_counter() - t)
        stats["finite"] &= bool(np.isfinite(out).all())
        return out

    engine.prefill, engine.decode = timed_prefill, timed_decode
    rng = np.random.RandomState(seed)
    lengths = {"p7": 7, "p64": 64, "p200": 200, "p1000": 1000,
               "p2000": 2000}
    prompts = {c: rng.randint(0, cfg.vocab_size, n).tolist()
               for c, n in lengths.items()}
    prompts["p200_repeat"] = list(prompts["p200"])
    max_tokens = 16
    sched = DecodeScheduler(engine, deployment=SERVE_DEPLOYMENT)
    submitted, first, finals = {}, {}, {}
    # what the scheduler emitted: token chunks, and the iterations that
    # decoded (one serve.decode_step span each)
    emitted = {"chunks": 0, "decode_iterations": 0}

    def submit(corr):
        submitted[corr] = time.perf_counter()
        check(sched.submit(corr, {"prompt": prompts[corr],
                                  "max_tokens": max_tokens}) is None,
              f"request {corr} refused")

    def step():
        decodes = len(stats["decode_s"])
        replies, active = sched.step()
        now = time.perf_counter()
        emitted["decode_iterations"] += len(stats["decode_s"]) > decodes
        for corr, kind, payload in replies:
            check(kind != "error", f"request {corr} failed: {payload}")
            first.setdefault(corr, now)
            emitted["chunks"] += kind == "chunk"
            if kind == "final":
                finals[corr] = json.loads(payload)
        return active

    flash_attention_forward.launches = 0
    t0 = time.perf_counter()
    for corr in lengths:
        submit(corr)
    step()
    # the repeat arrives while the others decode: continuous batching
    # admits it in the next iteration, from the prefix cache
    submit("p200_repeat")
    while step():
        pass
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash_attention_forward.launches
    # one idle iteration after the gauge interval: the scheduler flushes
    # the KV gauges from the pool's final state
    time.sleep(SERVE_GAUGE_WAIT_S)
    sched.step()
    kv_truth = {"pages_used": engine.pool.used,
                "pages_capacity": engine.pool.n_pages,
                "prefix_hit_rate": engine.prefix_cache.hit_rate}

    check(set(finals) == set(prompts), f"final frames for {sorted(finals)}")
    for corr, fin in finals.items():
        check(fin["n_generated"] == max_tokens
              and len(fin["tokens"]) == max_tokens,
              f"{corr} generated {fin['n_generated']} tokens")
    check(finals["p200_repeat"]["cached_prefix"] is True
          and finals["p200"]["cached_prefix"] is False,
          "the repeated prompt was not served from the prefix cache")
    check(finals["p200_repeat"]["tokens"] == finals["p200"]["tokens"],
          "prefix hit generated other tokens than its cold run")
    check(stats["finite"], "non-finite logits on the serving path")
    check(engine.prefill_calls == len(lengths),
          f"{engine.prefill_calls} cold prefills, expected {len(lengths)}")
    check(launches == cfg.n_layers * engine.prefill_calls,
          f"{launches} kernel launches for {engine.prefill_calls} cold "
          f"prefills of {cfg.n_layers} layers")
    peak_bytes = torch.cuda.max_memory_allocated()
    cold_prefills = engine.prefill_calls

    # full depth against plain attention: one cold prefill's last logits
    toks = torch.zeros((1, llama.pages_for(200, 16) * 16), dtype=torch.long,
                       device="cuda")
    toks[0, :200] = torch.as_tensor(prompts["p200"], device="cuda")
    with torch.inference_mode():
        kern = llama.prefill_with_cache(cfg, engine.params, toks)[0][0, 199]
        with mock.patch.object(
                llama, "flash_attention",
                lambda q, k, v, causal: flash_attention_reference(
                    q, k, v, causal)[0]):
            plain = llama.prefill_with_cache(cfg, engine.params, toks)[0][
                0, 199]
    full_diff = (kern - plain).abs().max().item()
    full_scale = plain.abs().max().item()
    check(full_diff <= LOGITS_REL_TOL * full_scale,
          f"full-depth prefill logits differ from plain: {full_diff} vs "
          f"max |logit| {full_scale}")

    # where the time goes: one cold 1000-token prefill and 8 decode steps
    # under the profiler (device kernel time by name, busy share)
    prompt = prompts["p1000"][:-1] + [0]  # not in the prefix cache
    pages = engine.prefix_cache.alloc_with_evict(
        llama.pages_for(len(prompt) + 8, 16))
    check(pages is not None, "no pages for the profiled sequence")
    profile_ms(torch, torch.cuda.synchronize)  # profiler start-up
    prof_prefill = profile_ms(torch, lambda: prefill(prompt, pages))
    prof_decode = profile_ms(torch, lambda: [
        decode(len(prompt) + i, 1, pages) for i in range(8)])
    # the steady-state cost of observing one decode step: the fingerprint
    # and the lookup on a real step's arguments, without the step
    args = engine.decode_inputs(len(prompt) + 7, 1, pages)
    check(engine._decode_fn.probe(*args),
          "the profiled decode step's fingerprint was not seen")
    t = time.perf_counter()
    for _ in range(OBSERVATION_CALLS):
        engine._decode_fn.probe(*args)
    observation_s = (time.perf_counter() - t) / OBSERVATION_CALLS
    del args
    engine.pool.release(pages)
    emit({"phase": "profile", "card": smi, "prefill_T1000": prof_prefill,
          "decode_8_steps": prof_decode})

    ttft = {c: (first[c] - submitted[c]) * 1e3 for c in prompts}
    emit({"phase": "serving", "model": "llama3_8b", "n_layers": cfg.n_layers,
          "page_size": 16, "n_pages": 512, "requests": len(prompts),
          "prompt_lengths": {c: len(p) for c, p in prompts.items()},
          "max_tokens": max_tokens, "card": smi,
          "engine_init_s": init_s, "wall_s": wall_s,
          "ttft_ms": ttft,
          "decode_ms_per_token": 1e3 * sum(stats["decode_s"])
          / len(stats["decode_s"]),
          "decode_calls": len(stats["decode_s"]),
          "prefill_tokens_per_s": stats["prefill_tokens"]
          / sum(stats["prefill_s"]),
          "cold_prefills": cold_prefills,
          "kernel_launches": launches,
          "cached_prefix_identity": True,
          "full_depth_rel_diff_vs_plain": full_diff / full_scale,
          "max_memory_allocated_bytes": peak_bytes})
    served = {"cfg": cfg, "buckets": engine.buckets(),
              "tpads_in_order": stats["tpads"],
              "tokens_emitted": emitted["chunks"],
              "tokens_generated": sum(f["n_generated"]
                                      for f in finals.values()),
              "decode_iterations": emitted["decode_iterations"],
              "admissions": sched.admitted, "kv_truth": kv_truth,
              "decode_calls": len(stats["decode_s"]),
              "decode_s": sum(stats["decode_s"]),
              "observation_s": observation_s,
              # for the serve_plane phase: the same prompts, and the
              # tokens each must give again through the control plane
              "prompts": prompts, "max_tokens": max_tokens,
              "tokens": {c: f["tokens"] for c, f in finals.items()}}
    return launches, served


SERVE_PLANE_DEPLOYMENT = "llama3_8b_replica"
SERVE_PLANE_BURST = 16
SERVE_PLANE_TIMEOUT_S = 600.0


class LlamaReplica:
    """The ``serve_plane`` phase's deployment: Llama-3-8B decode built in
    the replica, on the card the runtime bound it to, with the serving
    phase's engine arguments (so the same weights), plus the readings
    the phase takes from the replica's process."""

    def __init__(self, seed: int):
        self.seed = seed
        self.engine = None
        self.engine_init_s = None

    def create_decode_engine(self):
        import torch

        from ray_tpu_torch.models import llama

        t0 = time.perf_counter()
        self.engine = llama.LlamaDecodeEngine(
            llama.LlamaConfig.llama3_8b(), n_pages=512, page_size=16,
            seed=self.seed)
        torch.cuda.synchronize()
        self.engine_init_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return self.engine

    def reset_counts(self) -> int:
        """Set the forward kernel's launch count and the card's peak
        memory to 0; the engine's cold prefills so far."""
        import torch

        from ray_tpu_torch.ops.flash_attention import flash_attention_forward

        flash_attention_forward.launches = 0
        torch.cuda.reset_peak_memory_stats()
        return self.engine.prefill_calls

    def evict_prefixes(self) -> dict:
        """Drop every idle prefix-cache entry, so the next prompts
        prefill cold; the entries dropped and the pages still held."""
        cache, pool = self.engine.prefix_cache, self.engine.pool
        before = len(cache)
        cache.evict_lru(pool.n_pages)
        return {"evicted": before - len(cache), "pages_used": pool.used}

    def readings(self) -> dict:
        import os

        import torch

        from ray_tpu_torch.ops.flash_attention import flash_attention_forward

        return {
            "launches": flash_attention_forward.launches,
            "prefill_calls": self.engine.prefill_calls,
            "engine_device": str(self.engine.k_store.device),
            "engine_init_s": self.engine_init_s,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0),
            "forbidden_modules": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))}


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on right now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sse_request(port: int, path: str, payload: dict) -> dict:
    """POST ``payload`` as JSON and read the server-sent events as they
    arrive: the status, content type, records and each record's arrival
    time on the host clock, beside the time the request was sent."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=SERVE_PLANE_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(payload).encode(),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        out = {"status": resp.status, "t0": t0, "records": [], "times": [],
               "content_type": resp.getheader("content-type")}
        if resp.status != 200:
            out["error"] = resp.read().decode(errors="replace")
            return out
        while True:
            line = resp.readline()
            if not line:
                return out
            if line.startswith(b"data: "):
                out["times"].append(time.perf_counter())
                out["records"].append(json.loads(line[len(b"data: "):]))
    finally:
        conn.close()


def stream_final(name: str, got: dict) -> dict:
    """The final record of one SSE stream, after its gates: HTTP 200,
    ``text/event-stream``, a final record, and the records' tokens equal
    to the final record's."""
    check(got["status"] == 200,
          f"{name}: HTTP {got['status']} {got.get('error')}")
    check(got["content_type"] == "text/event-stream",
          f"{name}: content-type {got['content_type']!r}")
    recs = got["records"]
    check(bool(recs) and recs[-1].get("done") is True,
          f"{name}: no final record ({recs[-1:]})")
    check([r.get("token") for r in recs[:-1]] == recs[-1]["tokens"],
          f"{name}: the SSE records' tokens are not the final record's")
    return recs[-1]


def stream_timing(got: dict) -> tuple:
    """(TTFT ms, [ms between token records]) of one stream; the final
    record comes with the last token and is left out."""
    times = got["times"][:-1]
    return ((times[0] - got["t0"]) * 1e3,
            [(b - a) * 1e3 for a, b in zip(times, times[1:])])


def percentiles(np, values) -> dict:
    return {"p50": float(np.percentile(values, 50)),
            "p99": float(np.percentile(values, 99))}


def burst_streams(corrs, run_one) -> dict:
    """Run ``run_one(corr)`` for every corr at once, all threads released
    together; each corr's result, or ``{"status": None, "error": ...}``."""
    import threading

    start = threading.Barrier(len(corrs))
    results = {}

    def one(corr):
        start.wait()
        try:
            results[corr] = run_one(corr)
        except Exception as e:  # noqa: BLE001 — a gate below
            results[corr] = {"status": None, "error": repr(e)}

    threads = [threading.Thread(target=one, args=(c,)) for c in corrs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(SERVE_PLANE_TIMEOUT_S)
    check(set(results) == set(corrs),
          f"burst streams unfinished: {sorted(set(corrs) - set(results))}")
    return results


def handle_stream(stream, payload) -> dict:
    """One decode stream through the handle, in the shape of
    :func:`sse_request`'s result: the items and each one's arrival time
    on the host clock, beside the time the request was sent."""
    out = {"status": 200, "t0": time.perf_counter(), "records": [],
           "times": [], "content_type": "text/event-stream"}
    for item in stream.remote(payload):
        out["times"].append(time.perf_counter())
        out["records"].append(item)
    return out


def burst_readings(np, results, alone, name) -> dict:
    """Gates and readings of one plane's burst: every stream's tokens
    equal to its run alone, none a cache hit; TTFT and ms/token p50/p99,
    tokens/s over the burst's wall time."""
    ttfts, gaps, n_tokens = [], [], 0
    for corr, got in results.items():
        fin = stream_final(f"{name} burst {corr}", got)
        check(not fin["cached_prefix"], f"{name} burst {corr} was a cache hit")
        check(fin["tokens"] == alone[corr],
              f"{name} burst {corr}: tokens differ from its run alone")
        ttft, g = stream_timing(got)
        ttfts.append(ttft)
        gaps += g
        n_tokens += fin["n_generated"]
    wall = (max(g["times"][-1] for g in results.values())
            - min(g["t0"] for g in results.values()))
    return {"streams": len(results), "ttft_ms": percentiles(np, ttfts),
            "ms_per_token": percentiles(np, gaps),
            "tokens_per_s": n_tokens / wall, "wall_s": wall,
            "tokens_equal_alone": True}


def phase_serve_plane(torch, np, seed, smi, served):
    """``serve_plane``: the serving phase's Llama-3-8B behind the serve
    control plane, ``serve.run`` -> controller -> one replica actor
    holding one card, on two dispatch planes: the HTTP proxy's SSE
    streams (the proxy runs in a worker, ``proxy_location="EveryNode"``,
    so they ride the eager actor path) and the driver's
    ``DeploymentHandle`` streams (the compiled decode lane, plane
    ``compiled_stream``). The serving phase's six prompts one after
    another over HTTP, then through the handle: the same tokens,
    bitwise. Then 16 prompts of the same lengths, each alone over HTTP;
    the replica's prefix cache emptied and all 16 at once over HTTP;
    emptied again and all 16 at once through the handle: every burst
    stream the same tokens as alone. Last, the prefix cache emptied
    again, the six prompts one after another over HTTP from the default
    driver-resident proxy (``proxy_location="HeadOnly"``), whose SSE
    streams ride the compiled decode lane too: the same tokens, bitwise.
    Each run is read on its own (the replica's launch count and peak
    memory set to 0 just before it): TTFT and ms/token p50 / p99 at the
    client, tokens/s, the forward kernel's launches against the engine's
    cold prefills, the replica's peak memory; and its card and modules.
    Returns the forward launches of the eager run and of the two runs on
    the lane."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.config import global_config
    from ray_tpu_torch.serve import api as serve_api

    t_phase = time.perf_counter()
    cfg, page = served["cfg"], 16
    max_tokens = served["max_tokens"]
    order = list(served["prompts"])
    rng = np.random.RandomState(seed + 1)
    warm_prompt = rng.randint(0, cfg.vocab_size, 7).tolist()
    lengths = sorted({len(p) for p in served["prompts"].values()})
    burst = {}
    for i in range(SERVE_PLANE_BURST):
        n = lengths[i % len(lengths)]
        burst[f"b{i}_{n}"] = rng.randint(0, cfg.vocab_size, n).tolist()
    heads = [tuple(p[:page]) for c, p in served["prompts"].items()
             if c != "p200_repeat"] + [tuple(p[:page])
                                       for p in burst.values()]
    check(len(set(heads)) == len(heads),
          "two of the phase's prompts share their first page")
    # the card's free memory before the replica: its process must give
    # it back when serve shuts down
    free_before = torch.cuda.mem_get_info()[0]

    # the proxy worker's dispatch counts reach serve.status() with its
    # metrics reports
    knobs = global_config()
    report_ms = knobs.metrics_report_interval_ms
    knobs.metrics_report_interval_ms = 500
    rt.init()
    try:
        serve.start(serve.HTTPOptions(proxy_location="EveryNode"))
        (proxy,) = serve_api.get_proxy_addresses()
        port = proxy["port"]
        # and the default proxy (HeadOnly: in the driver) on a port found
        # free, which serve.run would otherwise start on port 8000
        head_port = free_port()
        serve.start(serve.HTTPOptions(port=head_port))
        # the lane's admission window holds the whole burst: no stream
        # overflows to the eager plane
        app = serve.deployment(
            LlamaReplica, name=SERVE_PLANE_DEPLOYMENT, decode=True,
            ray_actor_options={"num_gpus": 1},
            max_inflight=SERVE_PLANE_BURST,
            request_timeout_s=SERVE_PLANE_TIMEOUT_S)
        handle = serve.run(app.bind(seed), route_prefix="/llama")
        stream = handle.options(stream=True,
                                stream_item_timeout_s=SERVE_PLANE_TIMEOUT_S)

        def call(method):
            return getattr(handle, method).remote().result(
                timeout=SERVE_PLANE_TIMEOUT_S)

        def planes(total=0):
            """The deployment's dispatch counts, once ``total`` of them
            have reached the head (the proxy reports a moment later)."""
            from ray_tpu_torch.serve import observability as obs

            deadline = time.monotonic() + 60
            while True:
                obs.drain_deferred()
                got = serve.status()[SERVE_PLANE_DEPLOYMENT].get(
                    "dispatch_planes", {})
                if sum(got.values()) >= total \
                        or time.monotonic() > deadline:
                    return got
                time.sleep(0.25)

        # the first request builds the engine on the replica's card and
        # the replica's compiled decode lane, and its prefill and decode
        # pay the programs' one analysed first call
        t0 = time.perf_counter()
        warm = list(stream.remote({"prompt": warm_prompt, "max_tokens": 2}))
        first_request_s = time.perf_counter() - t0
        check(warm[-1].get("done") is True, f"warm-up gave {warm[-1:]}")
        before = planes()

        # the eager plane (HTTP SSE from the proxy worker)
        prefills0 = call("reset_counts")
        cold_http = 0
        seq_http = {}
        for corr in order:
            payload = {"prompt": served["prompts"][corr],
                       "max_tokens": max_tokens}
            got = sse_request(port, "/llama", payload)
            fin = stream_final(f"http {corr}", got)
            check(fin["tokens"] == served["tokens"][corr],
                  f"http {corr}: tokens differ from the serving phase's")
            cold_http += not fin["cached_prefix"]
            seq_http[corr] = stream_timing(got)
        alone = {}
        for corr, prompt in burst.items():
            fin = stream_final(f"alone {corr}", sse_request(
                port, "/llama", {"prompt": prompt,
                                 "max_tokens": max_tokens}))
            check(not fin["cached_prefix"], f"alone {corr} was a cache hit")
            alone[corr] = fin["tokens"]
        cold_http += len(burst)
        cleared = call("evict_prefixes")
        check(cleared["pages_used"] == 0,
              f"{cleared['pages_used']} KV pages held with no request "
              f"running")
        http_burst = burst_readings(np, burst_streams(
            list(burst), lambda c: sse_request(
                port, "/llama", {"prompt": burst[c],
                                 "max_tokens": max_tokens})), alone, "http")
        cold_http += len(burst)
        rep_http = call("readings")

        # the compiled plane (the handle's decode lane)
        prefills1 = call("reset_counts")
        cold_lane = 0
        seq_handle = {}
        for corr in order:
            got = handle_stream(stream, {"prompt": served["prompts"][corr],
                                         "max_tokens": max_tokens})
            fin = stream_final(f"handle {corr}", got)
            check(fin["tokens"] == served["tokens"][corr],
                  f"handle {corr}: tokens differ from the serving phase's")
            cold_lane += not fin["cached_prefix"]
            seq_handle[corr] = stream_timing(got)
        cleared = call("evict_prefixes")
        check(cleared["pages_used"] == 0,
              f"{cleared['pages_used']} KV pages held with no request "
              f"running")
        lane_burst = burst_readings(np, burst_streams(
            list(burst), lambda c: handle_stream(
                stream, {"prompt": burst[c], "max_tokens": max_tokens})),
            alone, "handle")
        cold_lane += len(burst)
        rep_lane = call("readings")

        # the driver's default proxy: its SSE streams ride the compiled
        # decode lane
        cleared = call("evict_prefixes")
        check(cleared["pages_used"] == 0,
              f"{cleared['pages_used']} KV pages held with no request "
              f"running")
        prefills2 = call("reset_counts")
        cold_head = 0
        seq_head = {}
        for corr in order:
            payload = {"prompt": served["prompts"][corr],
                       "max_tokens": max_tokens}
            got = sse_request(head_port, "/llama", payload)
            fin = stream_final(f"head http {corr}", got)
            check(fin["tokens"] == served["tokens"][corr],
                  f"head http {corr}: tokens differ from the serving "
                  f"phase's")
            cold_head += not fin["cached_prefix"]
            seq_head[corr] = stream_timing(got)
        rep_head = call("readings")

        runs = {"http": (rep_http, rep_http["prefill_calls"] - prefills0,
                         cold_http),
                "handle": (rep_lane, rep_lane["prefill_calls"] - prefills1,
                           cold_lane),
                "head_http": (rep_head,
                              rep_head["prefill_calls"] - prefills2,
                              cold_head)}
        for name, (rep, prefills, cold) in runs.items():
            check(prefills == cold,
                  f"{name}: the engine ran {prefills} cold prefills, the "
                  f"streams say {cold}")
            check(rep["launches"] == cfg.n_layers * prefills,
                  f"{name}: {rep['launches']} forward launches for "
                  f"{prefills} cold prefills of {cfg.n_layers} layers")
            check(not rep["forbidden_modules"],
                  f"the replica loaded {rep['forbidden_modules']}")
            check(bool(rep["cuda_visible_devices"])
                  and rep["device_count"] == 1
                  and rep["engine_device"].startswith("cuda"),
                  f"the replica saw CUDA_VISIBLE_DEVICES="
                  f"{rep['cuda_visible_devices']!r}, "
                  f"{rep['device_count']} cards, engine on "
                  f"{rep['engine_device']}")
        n_http = len(order) + 2 * len(burst)
        n_lane = 2 * len(order) + len(burst)
        after = planes(sum(before.values()) + n_http + n_lane)
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in set(after) | set(before)}
        # every stream from the proxy workers eager, every handle stream
        # and every stream from the driver's proxy on the lane, and
        # nothing else but the handle's unary calls (the readings)
        check(delta.get("eager", 0) == n_http
              and delta.get("compiled_stream", 0) == n_lane
              and set(k for k, v in delta.items() if v)
              <= {"eager", "compiled_stream", "compiled"},
              f"dispatch planes {before} -> {after}")
    finally:
        serve.shutdown()
        rt.shutdown()
        knobs.metrics_report_interval_ms = report_ms
    # the replica's process is gone once the card's memory is back
    deadline = time.monotonic() + 60
    while (torch.cuda.mem_get_info()[0] < free_before - (1 << 30)
           and time.monotonic() < deadline):
        time.sleep(0.5)
    free_after = torch.cuda.mem_get_info()[0]
    check(free_after >= free_before - (1 << 30),
          f"the card's free memory stayed at {free_after} bytes after "
          f"serve shut down ({free_before} before)")

    def sequential(timings):
        return {"ttft_ms": {c: timings[c][0] for c in order},
                "ms_per_token": percentiles(
                    np, [g for c in order for g in timings[c][1]])}

    emit({"phase": "serve_plane", "model": "llama3_8b",
          "n_layers": cfg.n_layers, "page_size": page, "n_pages": 512,
          "card": smi, "replica_card": rep_lane["device_name"],
          "replica_cuda_visible_devices": rep_lane["cuda_visible_devices"],
          "path": "serve.run -> controller -> ServeReplica (one card) -> "
                  "HTTP proxy worker SSE (eager) / DeploymentHandle "
                  "stream and driver proxy SSE (compiled decode lane) -> "
                  "DecodeScheduler",
          "engine_init_s": rep_lane["engine_init_s"],
          "first_request_s": first_request_s,
          "max_tokens": max_tokens, "burst_prompt_lengths":
              {c: len(p) for c, p in burst.items()},
          "planes": {
              "eager_http": {
                  "sequential": sequential(seq_http),
                  "burst": http_burst, "cold_prefills": cold_http,
                  "kernel_launches": rep_http["launches"],
                  "replica_max_memory_allocated_bytes":
                      rep_http["max_memory_allocated_bytes"]},
              "compiled_stream_handle": {
                  "sequential": sequential(seq_handle),
                  "burst": lane_burst, "cold_prefills": cold_lane,
                  "kernel_launches": rep_lane["launches"],
                  "replica_max_memory_allocated_bytes":
                      rep_lane["max_memory_allocated_bytes"]},
              "compiled_stream_head_http": {
                  "sequential": sequential(seq_head),
                  "cold_prefills": cold_head,
                  "kernel_launches": rep_head["launches"],
                  "replica_max_memory_allocated_bytes":
                      rep_head["max_memory_allocated_bytes"]}},
          "tokens_equal_serving_phase": True,
          "dispatch_planes": {"before": before, "after": after},
          "phase_s": time.perf_counter() - t_phase})
    return rep_http["launches"], rep_lane["launches"], rep_head["launches"]


# the dag phase: one bf16 activation of an 8B prefill (B 1, T 2048,
# width 4096: 16 MiB) through a compiled chain of two actors on the card
DAG_SHAPE = (1, 2048, 4096)
DAG_BUFFER_BYTES = 32 << 20
DAG_MAX_INFLIGHT = 4
DAG_PIPELINED = 50
# the scalar chain of the reference's test_compiled_beats_eager: calls a
# round, rounds (min of rounds, eager and compiled interleaved)
DAG_SCALAR_CALLS = 60
DAG_SCALAR_ROUNDS = 3


def dag_stage_a(x):
    """The chain's first stage: elementwise in bf16 on the card."""
    return x * 1.5 + 0.25


def dag_stage_b(y):
    """The chain's second stage: elementwise through float32."""
    import torch

    return torch.tanh(y.float()).to(y.dtype)


class DagStage:
    """An actor of the ``dag`` phase: one stage function on its card, its
    channel accounting and where it runs."""

    def __init__(self, which: str):
        self.fn = dag_stage_a if which == "a" else dag_stage_b

    def run(self, x):
        return self.fn(x)

    def step(self, x):
        return x + 1

    def where(self) -> dict:
        import os

        import torch

        return {"cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count(),
                "device_name": torch.cuda.get_device_name(0),
                "forbidden_modules": sorted(
                    m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))}

    def chan_stats(self) -> dict:
        from ray_tpu_torch.experimental.channel import STATS

        return dict(STATS)


def phase_dag(torch, smi):
    """``dag``: a compiled graph on the card. Two actors (half a card each
    on one card, a card each given more) chained with
    ``device_channels=True``: each execution carries a bf16 CUDA tensor
    of one 8B prefill's hidden states across the driver -> A -> B ->
    driver edges, each a device-to-host copy into a ring slot and a
    host-to-device copy out of it. Gates: the result bitwise the two
    stage functions run in the driver, no serialized bytes on either
    actor, the tensor bytes of every execution on each, every actor on
    one card and free of JAX. Readings: ms per execution and the edges'
    GB/s pipelined over 50 executions (4 in flight), and the per-call
    time of a 3-actor scalar chain, compiled against eager (min of
    rounds, interleaved)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    share = 1 if cards >= 2 else 0.5
    nbytes = math.prod(DAG_SHAPE) * 2
    rt.init()
    try:
        Stage = rt.remote(num_gpus=share)(DagStage)
        a, b = Stage.remote("a"), Stage.remote("b")
        where = rt.get([a.where.remote(), b.where.remote()], timeout=120)
        for w in where:
            check(w["device_count"] == 1 and w["cuda_visible_devices"],
                  f"a dag actor saw {w}")
            check(not w["forbidden_modules"],
                  f"a dag actor loaded {w['forbidden_modules']}")
        with InputNode() as inp:
            out = b.run.bind(a.run.bind(inp))
        dag = out.experimental_compile(buffer_size_bytes=DAG_BUFFER_BYTES,
                                       device_channels=True,
                                       max_inflight=DAG_MAX_INFLIGHT)
        try:
            gen = torch.Generator(device="cuda").manual_seed(7)
            x = torch.randn(DAG_SHAPE, device="cuda", generator=gen,
                            dtype=torch.float32).to(torch.bfloat16)
            want = dag_stage_b(dag_stage_a(x))
            got = dag.execute(x).get(timeout=120)
            check(isinstance(got, torch.Tensor) and got.is_cuda
                  and got.dtype == torch.bfloat16
                  and tuple(got.shape) == DAG_SHAPE,
                  f"the dag returned {type(got)} "
                  f"{getattr(got, 'device', None)}")
            check(torch.equal(got, want),
                  "the dag's result differs from its stages run in the "
                  "driver")
            # pipelined: DAG_MAX_INFLIGHT executions in flight
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refs = []
            for i in range(DAG_PIPELINED):
                if len(refs) >= DAG_MAX_INFLIGHT:
                    refs.pop(0).get(timeout=120)
                refs.append(dag.execute(x, timeout=120))
            last = None
            for r in refs:
                last = r.get(timeout=120)
            torch.cuda.synchronize()
            pipelined_s = time.perf_counter() - t0
            check(torch.equal(last, want), "a pipelined result differs")
            stats = rt.get([a.chan_stats.remote(), b.chan_stats.remote()],
                           timeout=120)
            executions = 1 + DAG_PIPELINED
            for name, st in zip("ab", stats):
                check(st["serialized_bytes"] == 0,
                      f"actor {name} serialized {st}")
                check(st["tensor_bytes"] >= executions * nbytes,
                      f"actor {name} moved {st['tensor_bytes']} tensor "
                      f"bytes for {executions} executions of {nbytes}")
        finally:
            dag.teardown()

        # the reference's 3-actor scalar chain, compiled against eager
        chain = [rt.remote(num_gpus=0)(DagStage).remote("a")
                 for _ in range(3)]
        rt.get([c.step.remote(0) for c in chain], timeout=120)
        with InputNode() as inp:
            out = chain[2].step.bind(chain[1].step.bind(chain[0].step.bind(
                inp)))
        scalar = out.experimental_compile()

        def eager_round():
            t = time.perf_counter()
            for i in range(DAG_SCALAR_CALLS):
                v = rt.get(chain[2].step.remote(rt.get(chain[1].step.remote(
                    rt.get(chain[0].step.remote(i))))))
                check(v == i + 3, f"eager chain gave {v}")
            return (time.perf_counter() - t) / DAG_SCALAR_CALLS

        def compiled_round():
            t = time.perf_counter()
            for i in range(DAG_SCALAR_CALLS):
                v = scalar.execute(i).get(timeout=60)
                check(v == i + 3, f"compiled chain gave {v}")
            return (time.perf_counter() - t) / DAG_SCALAR_CALLS

        try:
            scalar.execute(0).get(timeout=60)
            eager_round()
            eager_s, comp_s = [], []
            for r in range(DAG_SCALAR_ROUNDS):
                pair = (eager_round, compiled_round) if r % 2 == 0 \
                    else (compiled_round, eager_round)
                for fn in pair:
                    (eager_s if fn is eager_round else comp_s).append(fn())
        finally:
            scalar.teardown()
    finally:
        rt.shutdown()
    ms_per_exec = pipelined_s / DAG_PIPELINED * 1e3
    edges = 3  # driver -> a -> b -> driver
    emit({"phase": "dag", "card": smi, "cards": cards,
          "gpus_per_actor": share, "actor_cards": where,
          "shape": list(DAG_SHAPE), "dtype": "bfloat16",
          "tensor_bytes": nbytes, "buffer_size_bytes": DAG_BUFFER_BYTES,
          "max_inflight": DAG_MAX_INFLIGHT, "bitwise_equal": True,
          "actor_channel_stats": dict(zip("ab", stats)),
          "pipelined_executions": DAG_PIPELINED,
          "ms_per_execution": ms_per_exec,
          "edges": edges,
          "edge_GBps": edges * nbytes / (ms_per_exec / 1e3) / 1e9,
          "scalar_chain": {
              "calls_per_round": DAG_SCALAR_CALLS,
              "eager_ms_per_call": [s * 1e3 for s in eager_s],
              "compiled_ms_per_call": [s * 1e3 for s in comp_s],
              "speedup_min_of_rounds": min(eager_s) / min(comp_s)},
          "phase_s": time.perf_counter() - t_phase})


# the MPMD pipeline cell: Llama-3-1B, a global batch of 8 rows of 2048
# tokens (+1 target) as 8 one-row microbatches, SGD
MPMD_ROWS = 8
MPMD_MICROBATCHES = 8
MPMD_T = 2048
MPMD_LR = 0.1
MPMD_WARMUP, MPMD_TIMED = 3, 5
# one [1, 2048, 2048] bf16 activation is 8 MiB, the trainer's default slot
# with no room for its header: the phase passes a larger one
MPMD_SLOT_BYTES = 16 << 20
MPMD_HOPS = 20  # sequential executions of the hop probe
# the param gate: each leaf's update (final minus initial) within this of
# the reference's, by norm: the per-leaf grad bound (an SGD update is lr
# times the mean grad)
MPMD_LEAF_RTOL = ATTN_GRAD_RTOL
FORBIDDEN_TOP = ("jax", "jaxlib", "ray_tpu")


def mpmd_stage_layers(cfg, stages: int) -> list:
    """Layers of each stage under ``split_llama_stages``'s bounds."""
    bounds = [round(s * cfg.n_layers / stages) for s in range(stages + 1)]
    return [b - a for a, b in zip(bounds, bounds[1:])]


def mpmd_launches(cfg, stages: int, microbatches: int, steps: int) -> list:
    """Each stage's kernel launches over ``steps``: a stage before the last
    runs its layers' forward twice a microbatch (the forward, then again
    in the backward, which rematerializes from the stashed input), the
    last stage once (its forward is fused into the loss's backward); dQ
    and dK/dV once a layer a microbatch."""
    layers = mpmd_stage_layers(cfg, stages)
    n = microbatches * steps
    return [{"fwd": (1 if s == stages - 1 else 2) * L * n, "dq": L * n,
             "dkv": L * n} for s, L in enumerate(layers)]


def mpmd_run(rt, cfg, tokens, stages: int, share, schedule: str,
             seed: int) -> dict:
    """One ``MPMDPipelineTrainer`` run: the stages' probes before it,
    3 warm-up and 5 timed steps (the kernels' counts and peak memory set
    to 0 between them), the timed window's pipeline stats, channel stats
    and the final params; the trainer is shut down before returning."""
    from ray_tpu_torch.train import MPMDPipelineTrainer

    t_build = time.perf_counter()
    trainer = MPMDPipelineTrainer(
        num_stages=stages, lr=MPMD_LR, seed=seed, model="llama",
        llama_cfg=cfg, buffer_size_bytes=MPMD_SLOT_BYTES,
        schedule=schedule, stage_resources=[{"GPU": share}] * stages)
    try:
        build_s = time.perf_counter() - t_build
        where = rt.get([s.probe.remote() for s in trainer.stages],
                       timeout=300)
        t0 = time.perf_counter()
        losses = trainer.fit(tokens, steps=MPMD_WARMUP,
                             num_microbatches=MPMD_MICROBATCHES)
        warm_s = time.perf_counter() - t0
        before = trainer.pipeline_stats()
        rt.get([s.probe.remote(reset=True) for s in trainer.stages],
               timeout=120)
        step_s = []
        for _ in range(MPMD_TIMED):
            t = time.perf_counter()
            losses.append(trainer.train_step(
                tokens, num_microbatches=MPMD_MICROBATCHES))
            step_s.append(time.perf_counter() - t)
        after = trainer.pipeline_stats()
        probes = rt.get([s.probe.remote() for s in trainer.stages],
                        timeout=120)
        channels = trainer.channel_stats()
        t = time.perf_counter()
        params = trainer.get_params()
        params_s = time.perf_counter() - t
    finally:
        trainer.shutdown()
    busy = [b - a for a, b in zip(before["stage_busy_s"],
                                  after["stage_busy_s"])]
    wall = after["pipeline_wall_s"] - before["pipeline_wall_s"]
    return {"schedule": schedule, "build_s": build_s, "warm_s": warm_s,
            "params_s": params_s,
            "where": where, "losses": losses, "step_s": step_s,
            "busy_s": busy, "wall_s": wall,
            "efficiency": sum(busy) / (stages * wall),
            "stats": after, "probes": probes, "channels": channels,
            "params": params}


def hop_ms(rt, torch, share, slot_bytes: int) -> dict:
    """The stage hop alone: a 2-actor ``device_channels`` chain
    (``DagStage``, the ``dag`` phase's actors, at the stages' card share)
    carrying one microbatch's activation, a bf16 [1, 2048, 2048] CUDA
    tensor, one execution at a time: ms an execution over its 3 edges
    (driver -> A -> B -> driver)."""
    from ray_tpu_torch.dag import InputNode

    Stage = rt.remote(num_gpus=share)(DagStage)
    a, b = Stage.remote("a"), Stage.remote("b")
    rt.get([a.step.remote(0), b.step.remote(0)], timeout=120)
    with InputNode() as inp:
        out = b.run.bind(a.run.bind(inp))
    dag = out.experimental_compile(buffer_size_bytes=slot_bytes,
                                   device_channels=True, max_inflight=2)
    try:
        x = torch.randn((1, MPMD_T, 2048), device="cuda").to(torch.bfloat16)
        want = dag_stage_b(dag_stage_a(x))
        check(torch.equal(dag.execute(x).get(timeout=120), want),
              "the hop probe's result differs")
        t0 = time.perf_counter()
        for _ in range(MPMD_HOPS):
            dag.execute(x).get(timeout=120)
        per_exec = (time.perf_counter() - t0) / MPMD_HOPS
    finally:
        dag.teardown()
        for actor in (a, b):
            rt.kill(actor)
    return {"executions": MPMD_HOPS, "edges": 3,
            "bytes": x.numel() * x.element_size(),
            "ms_per_execution": per_exec * 1e3,
            "ms_per_hop": per_exec * 1e3 / 3}


def leaf_gate(torch, np, got: dict, want: dict, start) -> dict:
    """Per leaf of one stage: bitwise (compared on the host), and the
    update's error ||got - want|| over the reference update's norm
    ||want - start|| (0 when bitwise; else on the card, float64 norms,
    ``start()`` giving the stage's initial leaves)."""
    out = {}
    for path, g in got.items():
        if np.array_equal(g, want[path]):
            out[path] = {"bitwise": True, "update_rel_err": 0.0}
            continue
        gt = torch.tensor(g, device="cuda")
        wt = torch.tensor(want[path], device="cuda")
        st = start()[path]
        out[path] = {
            "bitwise": False,
            "update_rel_err": float((gt - wt).double().norm()
                                    / (wt - st).double().norm().clamp_min(
                                        1e-30))}
    return out


def flat_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat_paths(v, path) if isinstance(v, dict)
                   else {path: v})
    return out


def phase_mpmd(torch, np, seed, smi, peak_flops, trained):
    """``mpmd``: the MPMD pipeline trainer (``train/pipeline.py``) at
    Llama-3-1B full width and depth, SGD, a global batch of 8 x 2049
    tokens as 8 one-row microbatches; K = 2 stage actors at half a card
    each on one card, K = 4 at a card each when four are visible; 1F1B
    and GPipe in turn, 3 warm-up and 5 timed steps each, activations and
    grads crossing stages on ``device_channels`` edges as CUDA tensors.
    Then, the stage actors gone, ``reference_llama_losses`` (the same
    stage math in this process on this card) from the same seeded init.
    Gates: losses within rtol 3e-3 of the reference's, each param leaf's
    update within 3e-2 of the reference's by norm (bitwise printed); no
    serialized bytes on any stage; stash at most K under 1F1B; each
    stage on one card (its own when four are visible) and free of JAX;
    the kernels' launches in the timed steps exact on every stage.
    Readings: step ms, tokens/s per card, MFU, the measured bubble
    against (K-1)/(M+K-1), the stages' peak memory, 1F1B against GPipe,
    the hop alone (a 2-actor chain at the activation's shape) and, on
    four cards, the launch path's ``pipe`` step. Returns each schedule's
    launches over all stages in the timed steps."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.pipeline import (reference_llama_losses,
                                              split_llama_stages)

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    K = 4 if cards >= 4 else 2
    share = 1 if cards >= K else 0.5
    cfg = llama.LlamaConfig.llama3_1b()
    M = MPMD_MICROBATCHES
    tokens = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (MPMD_ROWS, MPMD_T + 1)).astype(np.int32)
    steps = MPMD_WARMUP + MPMD_TIMED
    want_launches = mpmd_launches(cfg, K, M, MPMD_TIMED)
    # the stages' params come back through the object store at once (3.0
    # GB a stage at K = 2; the arena's allocator rounds each block up to a
    # power of two)
    rt.init(object_store_memory=16 << 30)
    try:
        runs = [mpmd_run(rt, cfg, tokens, K, share, schedule, seed)
                for schedule in ("1f1b", "gpipe")]
        hop = hop_ms(rt, torch, share, MPMD_SLOT_BYTES)
    finally:
        rt.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_ref = time.perf_counter()
    ref_losses, ref_params = reference_llama_losses(
        cfg, seed, tokens, steps=steps, num_microbatches=M, num_stages=K,
        lr=MPMD_LR, return_params=True, device="cuda")
    ref_s = time.perf_counter() - t_ref
    ref_peak = torch.cuda.max_memory_allocated()
    starts = []

    def start_of(c):
        """Stage ``c``'s initial leaves (the seeded init), made once and
        only for a leaf that is not bitwise."""
        if not starts:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            starts.extend(flat_paths(sp) for sp in split_llama_stages(
                cfg, llama.init_params(cfg, gen, "cuda"), K))
        return starts[c]

    n_params = cfg.num_params()
    out_runs = {}
    for run in runs:
        name = run["schedule"]
        for w in run["where"]:
            check(w["device_count"] == 1,
                  f"mpmd {name}: stage {w['stage']} sees "
                  f"{w['device_count']} cards")
            check(not [m for m in w["modules"] if m in FORBIDDEN_TOP],
                  f"mpmd {name}: stage {w['stage']} loaded "
                  f"{[m for m in w['modules'] if m in FORBIDDEN_TOP]}")
        uuids = [w["uuid"] for w in run["where"]]
        if share == 1:
            check(len(set(uuids)) == K,
                  f"mpmd {name}: stages share cards: {uuids}")
        got_launches = [p["launches"] for p in run["probes"]]
        check(got_launches == want_launches,
              f"mpmd {name}: stages launched {got_launches}, want "
              f"{want_launches}")
        for i, cs in enumerate(run["channels"]):
            check(cs["serialized_bytes"] == 0,
                  f"mpmd {name}: stage {i} serialized {cs}")
        if name == "1f1b":
            check(run["stats"]["stash_max"] <= K,
                  f"mpmd 1f1b: stash_max {run['stats']['stash_max']} > {K}")
        losses = run["losses"]
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0], f"mpmd {name}: losses {losses}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        check(len(losses) == steps and max(rel) <= TRAIN_RTOL,
              f"mpmd {name}: losses {losses} vs the reference's "
              f"{ref_losses}, rel {rel}")
        leaves = {}
        for c, (got, want) in enumerate(zip(run["params"], ref_params)):
            for path, v in leaf_gate(torch, np, flat_paths(got),
                                     flat_paths(want),
                                     lambda c=c: start_of(c)).items():
                leaves[f"stage{c}/{path}"] = v
        worst = max(v["update_rel_err"] for v in leaves.values())
        check(worst <= MPMD_LEAF_RTOL,
              f"mpmd {name}: a leaf's update is {worst} off the "
              f"reference's: {leaves}")
        step_s = sum(run["step_s"]) / MPMD_TIMED
        tokens_per_s = MPMD_ROWS * MPMD_T / step_s
        cards_used = K * share
        out_runs[name] = {
            "build_s": run["build_s"], "warmup_s": run["warm_s"],
            "get_params_s": run["params_s"],
            "step_ms": step_s * 1e3,
            "step_ms_each": [s * 1e3 for s in run["step_s"]],
            "tokens_per_s": tokens_per_s,
            "tokens_per_s_per_card": tokens_per_s / cards_used,
            "mfu": 6.0 * n_params * tokens_per_s / cards_used / peak_flops,
            "bubble_measured": 1.0 - run["efficiency"],
            "pipeline_efficiency": run["efficiency"],
            "stage_busy_s": run["busy_s"], "pipeline_wall_s": run["wall_s"],
            "stash_max": run["stats"]["stash_max"],
            "window": run["stats"]["window"],
            "peak_bytes_per_stage": [p["peak_bytes"] for p in run["probes"]],
            "launches_per_stage": got_launches,
            "serialized_bytes": [cs["serialized_bytes"]
                                 for cs in run["channels"]],
            "tensor_bytes": [cs["tensor_bytes"] for cs in run["channels"]],
            "losses": losses, "loss_rel_diff": rel,
            "losses_bitwise": losses == ref_losses,
            "params_bitwise": all(v["bitwise"] for v in leaves.values()),
            "leaf_update_rel_err_max": worst,
            "stages": [{"stage": w["stage"], "uuid": w["uuid"],
                        "cuda_visible_devices": w["cuda_visible_devices"]}
                       for w in run["where"]]}
    emit({"phase": "mpmd", "card": smi, "cards": cards,
          "model": "llama3_1b", "n_layers": cfg.n_layers, "dim": cfg.dim,
          "params": n_params, "stages": K, "gpus_per_stage": share,
          "stage_layers": mpmd_stage_layers(cfg, K),
          "global_batch": [MPMD_ROWS, MPMD_T + 1], "microbatches": M,
          "optimizer": f"SGD(lr={MPMD_LR})",
          "buffer_size_bytes": MPMD_SLOT_BYTES,
          "warmup_steps": MPMD_WARMUP, "timed_steps": MPMD_TIMED,
          "bubble_theory": (K - 1) / (M + K - 1),
          "rtol": TRAIN_RTOL, "leaf_update_rtol": MPMD_LEAF_RTOL,
          "schedules": out_runs,
          "gpipe_over_1f1b_step": out_runs["gpipe"]["step_ms"]
          / out_runs["1f1b"]["step_ms"],
          "reference": {"losses": ref_losses, "seconds": ref_s,
                        "peak_bytes": ref_peak},
          "hop": hop,
          "launch_path_pipe_step_ms": trained.get("pipe_step_ms"),
          "phase_s": time.perf_counter() - t_phase})
    return {f"mpmd_{name}": {k: sum(p["launches"][k] for p in run["probes"])
                             for k in ("fwd", "dq", "dkv")}
            for name, run in zip(out_runs, runs)}


TUNE_LRS = (3e-4, 1e-3)


def runtime_processes(own: int) -> dict:
    """pid -> (holds a card, has mapped a JAX library) for every process
    below ``own``: a card is held by a process with a ``/dev/nvidiaN``
    open (a CUDA context), JAX by one that mapped a ``jaxlib`` or ``jax``
    library."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
    out = {}
    for pid in parent:
        p = parent[pid]
        while p not in (own, 0, 1) and p in parent:
            p = parent[p]
        if p != own:
            continue
        try:
            fds = [os.readlink(f"/proc/{pid}/fd/{fd}")
                   for fd in os.listdir(f"/proc/{pid}/fd")]
            with open(f"/proc/{pid}/maps") as f:
                maps = f.read()
        except OSError:
            continue  # exited while read
        out[pid] = (any(re.fullmatch(r"/dev/nvidia\d+", x) for x in fds),
                    "jaxlib" in maps or "/jax/" in maps)
    return out


def phase_tune(torch, seed, smi):
    """``tune``: ``Tuner(TorchTrainer(...))`` on the default loop
    (``spmd_runs.tune_probe_loop``: the loop under the trainer phase's
    probe, its last row also carrying the loss) at Llama-3-1B widths and
    2 layers, T 2048, 3 steps, B 4 a worker, a grid of two learning
    rates: one trial at a time on one card, two at once on four. Gates:
    each trial's loss equals a direct ``TorchTrainer.fit`` of the same
    merged config (bitwise; rtol 3e-3 allowed and stated if not); the
    best result is the lower loss; each trial's worker on one card, its
    launches exact and free of JAX; concurrent trials' workers on
    different cards; no process of the runtime but the trainers' workers
    holds a card (sampled every 0.25 s through the sweep) and none has
    loaded JAX; ``experiment_state.json`` written. Readings: seconds a
    trial and over a direct fit's. Returns the trials' launches."""
    import shutil
    import tempfile
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.spmd_runs import tune_probe_loop

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    concurrent = 2 if cards >= 4 else 1
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_1b(), n_layers=2)
    steps = 3
    base = {"llama_config": cfg, "steps": steps, "seq": 2048, "seed": seed,
            "batch_per_device": 4, "distinct_batches": 1}
    scaling = ScalingConfig(num_workers=1, use_gpu=True)
    want = rank_launches(cfg, steps, {"mesh": {"data": 1}, "coords": {}})
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    seen: dict = {}
    gpus_in_use = []
    done = threading.Event()

    def sample():
        while not done.wait(0.25):
            for pid, v in runtime_processes(os.getpid()).items():
                old = seen.get(pid, (False, False))
                seen[pid] = (old[0] or v[0], old[1] or v[1])
            free = rt.available_resources().get("GPU", 0.0)
            gpus_in_use.append(rt.cluster_resources().get("GPU", 0.0)
                               - free)

    rt.init()
    try:
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t0 = time.perf_counter()
        try:
            grid = tune.Tuner(
                TorchTrainer(tune_probe_loop, train_loop_config=base,
                             scaling_config=scaling),
                param_space={"lr": tune.grid_search(list(TUNE_LRS))},
                tune_config=tune.TuneConfig(
                    metric="loss", mode="min",
                    max_concurrent_trials=concurrent),
                run_config=RunConfig(storage_path=storage,
                                     name="sweep")).fit()
        finally:
            sweep_s = time.perf_counter() - t0
            done.set()
            sampler.join(timeout=30)
        check(len(grid) == len(TUNE_LRS) and not grid.errors,
              f"tune: {len(grid)} trials, errors {grid.errors}")
        trials = {grid[i].config["lr"]: grid[i].metrics
                  for i in range(len(grid))}
        direct, direct_s = {}, {}
        for lr in TUNE_LRS:
            t = time.perf_counter()
            result = TorchTrainer(
                tune_probe_loop, train_loop_config={**base, "lr": lr},
                scaling_config=scaling,
                run_config=RunConfig(storage_path=storage,
                                     name=f"direct_{lr}")).fit()
            direct_s[lr] = time.perf_counter() - t
            check(result.error is None, f"tune direct fit: {result.error}")
            direct[lr] = result.metrics["loss"]
        state = os.path.exists(os.path.join(storage, "sweep",
                                            "experiment_state.json"))
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    workers = set()
    for lr, m in trials.items():
        hold_ranks(f"tune lr={lr}", m["ranks"], 1, want)
        workers.update(r["pid"] for r in m["ranks"])
    check(state, "tune: no experiment_state.json")
    uuids = [trials[lr]["ranks"][0]["uuid"] for lr in TUNE_LRS]
    if concurrent > 1:
        check(len(set(uuids)) == len(uuids),
              f"tune: concurrent trials' workers share a card: {uuids}")
    holders = sorted(p for p, (card, _) in seen.items() if card)
    check(set(holders) <= workers,
          f"tune: processes {sorted(set(holders) - workers)} other than "
          f"the trainers' workers {sorted(workers)} hold a card")
    check(len(set(seen) - workers) >= 1,
          "tune: the sampler saw no trial actor")
    check(not [p for p, (_, jax) in seen.items() if jax],
          f"tune: processes loaded JAX: "
          f"{[p for p, (_, jax) in seen.items() if jax]}")
    check(max(gpus_in_use, default=0.0) <= concurrent,
          f"tune: {max(gpus_in_use)} GPUs reserved at once, want at most "
          f"{concurrent} (a worker a trial)")
    got = {lr: trials[lr]["loss"] for lr in TUNE_LRS}
    bitwise = got == direct
    rel = {lr: abs(got[lr] - direct[lr]) / abs(direct[lr])
           for lr in TUNE_LRS}
    check(max(rel.values()) <= TRAIN_RTOL,
          f"tune: trials' losses {got} vs direct fits' {direct}")
    best = grid.get_best_result("loss", "min").config["lr"]
    check(best == min(direct, key=direct.get),
          f"tune: best lr {best}, direct fits {direct}")
    trial_s = sweep_s * concurrent / len(TUNE_LRS)
    emit({"phase": "tune", "card": smi, "cards": cards,
          "model": "llama3_1b", "n_layers": cfg.n_layers, "T": 2048,
          "steps": steps, "batch_per_worker": 4,
          "param_space": {"lr": list(TUNE_LRS)},
          "max_concurrent_trials": concurrent,
          "trial_losses": {str(k): v for k, v in got.items()},
          "direct_losses": {str(k): v for k, v in direct.items()},
          "bitwise": bitwise, "loss_rel_diff": {str(k): v
                                                for k, v in rel.items()},
          "best_lr": best,
          "workers": {str(lr): {"uuid": trials[lr]["ranks"][0]["uuid"],
                                "pid": trials[lr]["ranks"][0]["pid"]}
                      for lr in TUNE_LRS},
          "processes_seen": len(seen), "card_holders": holders,
          "gpus_in_use_max": max(gpus_in_use, default=0.0),
          "experiment_state": state, "sweep_s": sweep_s,
          "seconds_a_trial": trial_s,
          "direct_fit_s": {str(k): v for k, v in direct_s.items()},
          "trial_over_direct": trial_s / (sum(direct_s.values())
                                          / len(direct_s)),
          "phase_s": time.perf_counter() - t_phase})
    return {"tune_all_trials": {
        k: sum(r["launches"][k] for m in trials.values()
               for r in m["ranks"]) for k in ("fwd", "dq", "dkv")}}


RL_WARMUP_ITERS, RL_TIMED_ITERS = 2, 5
RL_UPDATE_REPS = 50          # updates timed on each device
RL_PROFILED = 10             # updates under one profile
RL_RTOL = 1e-5               # loss and stats, card against CPU (atol 1e-7)
RL_LEAF_RTOL = 1e-5          # a grad leaf, of the leaf's largest |value|
RL_STEP_RTOL = 1e-6          # a param leaf after a step on the same grads
RL_GATE_RETURN, RL_GATE_ITERS = 450.0, 120  # tests/test_rllib.py:103-119


def leaf_rel_err(torch, got, want) -> float:
    """Worst over leaves of max |got - want| / max |want| (both dicts or
    lists of tensors, on any device)."""
    worst = 0.0
    pairs = zip(got.values(), want.values()) if isinstance(want, dict) \
        else zip(got, want)
    for g, w in pairs:
        g = g.detach().double().cpu()
        w = w.detach().double().cpu()
        scale = max(float(w.abs().max()), 1e-30)
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def stats_close(got: dict, want: dict) -> dict:
    """Each stat's relative difference; a stat fails past rtol 1e-5 and
    atol 1e-7 (a clip fraction or a KL can be near 0)."""
    out = {}
    for k in want:
        g, w = float(got[k]), float(want[k])
        ok = abs(g - w) <= RL_RTOL * abs(w) + 1e-7
        out[k] = {"card": g, "cpu": w, "rel": abs(g - w) / max(abs(w), 1e-30),
                  "ok": ok}
    return out


def compute_apps() -> list:
    """PIDs nvidia-smi lists as holding a card (they may be another pid
    namespace's: read beside the /proc check, not instead of it)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def rl_twins(torch, make, state: bytes):
    """The same learner on the card and on the CPU, from one state."""
    card, cpu = make(1), make(0)
    card.set_state(state)
    cpu.set_state(state)
    return card, cpu


def rl_grad_gates(torch, name, card_out, cpu_out) -> dict:
    """Loss, stats and grads of one update, card against CPU."""
    (lc, sc, gc), (lp, sp, gp) = card_out, cpu_out
    stats = stats_close({"loss": lc, **sc}, {"loss": lp, **sp})
    grad_err = leaf_rel_err(torch, gc, gp)
    check(all(s["ok"] for s in stats.values()),
          f"rllib {name}: card stats off the CPU's: {stats}")
    check(grad_err <= RL_LEAF_RTOL,
          f"rllib {name}: a grad leaf {grad_err} of its max off the CPU's")
    return {"stats": stats, "grad_leaf_rel_err": grad_err}


def rl_step_gate(torch, name, card_params, cpu_params) -> float:
    """The params after a step on each device with the CPU's grads:
    within 1e-6 of each leaf's largest |value|."""
    err = leaf_rel_err(torch, card_params, cpu_params)
    check(err <= RL_STEP_RTOL,
          f"rllib {name}: the step on the same grads {err} apart")
    return err


def phase_rllib(torch, np, seed, smi):
    """``rllib``: PPO at ``PPOConfig``'s defaults on CartPole-v1
    (``envs.CartPoleEnv``): 2 remote CPU env runners x 8 envs x 64 steps,
    train batch 2048, minibatch 128, 10 epochs, 64x64 tanh towers, Adam
    3e-4 with a global-norm clip of 0.5, the learner on the card. (a) 2
    warm-up and 5 timed iterations: iteration s split into sampling and
    learning, env steps/s, ms a minibatch update on the card and the
    CPU, kernels an update (profiler), the learner's peak; gates: the
    learner's params on the card, no runner with a CUDA context, a card,
    JAX, or a module off the CPU. (b) one PPO update on the card against
    the CPU from one state and minibatch (TF32 off): loss and stats rtol
    1e-5, each grad leaf 1e-5 of its max, the Adam step on the same grads
    1e-6. (c) the same gates for an IMPALA V-trace sequence update and a
    SAC update (injected draws, a synthetic Pendulum-sized batch). (d)
    the reference's learning gate with the learner on the card: mean
    return >= 450 within 120 iterations (on a miss, the same seed with
    the learner on the CPU, both reported, and the phase fails). (e) two
    cards or more: ``num_learners=2`` over NCCL, a card each, against
    gloo learners on the CPU on the same batch and seed (params 1e-5 of
    each leaf's max) and against each other (equal)."""
    from ray_tpu_torch.rllib import PPOConfig, RLModuleSpec
    from ray_tpu_torch.rllib.envs import CartPoleEnv
    from ray_tpu_torch.rllib.learner import Learner
    from ray_tpu_torch.rllib.ppo import ppo_loss

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = torch.cuda.device_count()
    env = CartPoleEnv()
    obs_space, act_space = env.observation_space, env.action_space
    cfg = PPOConfig().environment(env_creator=CartPoleEnv).debugging(
        seed=seed)
    spec = RLModuleSpec()
    out = {"phase": "rllib", "card": smi, "cards": cards,
           "config": {"env": "CartPole-v1 (envs.CartPoleEnv)",
                      "num_env_runners": cfg.num_env_runners,
                      "num_envs_per_env_runner": cfg.num_envs_per_env_runner,
                      "rollout_fragment_length": cfg.rollout_fragment_length,
                      "train_batch_size": cfg.train_batch_size,
                      "minibatch_size": cfg.minibatch_size,
                      "num_epochs": cfg.num_epochs,
                      "hiddens": list(spec.hiddens), "lr": cfg.lr,
                      "grad_clip": cfg.grad_clip},
           "gymnasium": importlib.util.find_spec("gymnasium") is not None}

    def ppo_learner(gpus):
        c = cfg.copy().learners(num_gpus_per_learner=gpus)
        return Learner(spec.build(obs_space, act_space), c, ppo_loss(c))

    try:
        rl_readings(torch, np, seed, out, cfg, spec, obs_space, act_space,
                    cards, ppo_learner)
    finally:
        out["phase_s"] = time.perf_counter() - t_phase
        emit(out)
    gate = out["learning_gate"]["card"]
    check(gate["best"] >= RL_GATE_RETURN,
          f"rllib: PPO on the card reached {gate['best']} in "
          f"{gate['iterations']} iterations (CPU: "
          f"{out['learning_gate'].get('cpu')})")


def rl_readings(torch, np, seed, out, cfg, spec, obs_space, act_space,
                cards, ppo_learner) -> None:
    """(a)-(e) of :func:`phase_rllib`, their readings into ``out`` (the
    phase's line, printed even when a gate fails)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import IMPALAConfig, SACConfig
    from ray_tpu_torch.rllib import SingleAgentEnvRunner
    from ray_tpu_torch.rllib.continuous import ContinuousRLModule
    from ray_tpu_torch.rllib.env_runner import compute_gae
    from ray_tpu_torch.rllib.envs import Box, CartPoleEnv
    from ray_tpu_torch.rllib.impala import impala_loss
    from ray_tpu_torch.rllib.learner import (Learner, LearnerGroup, grads_of,
                                             to_tensors)
    from ray_tpu_torch.rllib.ppo import ppo_loss
    from ray_tpu_torch.rllib.sac import SACLearner

    # ---- (a) PPO at the defaults, learner on the card -------------------
    rt.init()
    try:
        algo = cfg.build()
        try:
            learner = algo.learner_group._local
            check(all(p.is_cuda for p in learner.params.values()),
                  "rllib: the learner's params are not on the card")
            learn_s = []
            update = algo.learner_group.update

            def timed_update(*a, **k):
                t = time.perf_counter()
                result = update(*a, **k)
                learn_s.append(time.perf_counter() - t)
                return result

            algo.learner_group.update = timed_update
            for _ in range(RL_WARMUP_ITERS):
                algo.train()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            learn_s.clear()
            steps0 = learner.optimizer.count
            iters = [algo.train() for _ in range(RL_TIMED_ITERS)]
            peak = torch.cuda.max_memory_allocated()
            updates = (learner.optimizer.count - steps0) / RL_TIMED_ITERS
            iter_s = [r["time_this_iter_s"] for r in iters]
            sample_s = [a - b for a, b in zip(iter_s, learn_s)]
            env_steps = [r["num_env_steps_sampled"] for r in iters]
            runners = algo.env_runner_group._runners
            probes = rt.get([r.probe.remote() for r in runners], timeout=60)
            procs = runtime_processes(os.getpid())
            smi_pids = compute_apps()
            for p in probes:
                check(p["module_device"] == "cpu",
                      f"rllib: a runner's module on {p['module_device']}")
                check(not p["cuda_initialized"] and not p["jax_loaded"],
                      f"rllib: runner {p}")
                check(not procs.get(p["pid"], (False, False))[0]
                      and p["pid"] not in smi_pids,
                      f"rllib: runner {p['pid']} holds a card")
            check(len({p["pid"] for p in probes}) == cfg.num_env_runners,
                  f"rllib: runners {probes}")
            state = learner.get_state()
            weights = learner.get_weights()
            batches, _ = algo.env_runner_group.sample(weights)
        finally:
            algo.cleanup()
        parts = [compute_gae(b, cfg.gamma, cfg.lambda_) for b in batches]
        flat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        mb = {k: v[:cfg.minibatch_size] for k, v in flat.items()}
        card, cpu = rl_twins(torch, ppo_learner, state)
        mb_card, mb_cpu = to_tensors(mb, card.device), to_tensors(mb, "cpu")
        card_ms = cuda_ms(lambda: card._step(mb_card), iters=RL_UPDATE_REPS,
                          warmup=5)
        for _ in range(5):
            cpu._step(mb_cpu)
        t = time.perf_counter()
        for _ in range(RL_UPDATE_REPS):
            cpu._step(mb_cpu)
        cpu_ms = (time.perf_counter() - t) * 1e3 / RL_UPDATE_REPS
        # ten updates under one profile: a single update's profile inside
        # the whole smoke (after the earlier phases' profiles) counted 112
        # kernels where the phase alone counted 171
        prof = profile_ms(torch, lambda: [card._step(mb_card)
                                          for _ in range(RL_PROFILED)])
        out["ppo"] = {
            "iteration_s": iter_s, "sampling_s": sample_s,
            "learning_s": learn_s, "env_steps": env_steps,
            "env_steps_per_s": sum(env_steps) / sum(iter_s),
            "env_steps_per_sampling_s": sum(env_steps) / sum(sample_s),
            "updates_per_iteration": updates,
            "learner_ms_per_update": {"card": card_ms, "cpu": cpu_ms,
                                      "cpu_over_card": cpu_ms / card_ms,
                                      "cpu_threads": torch.get_num_threads()},
            "learner_ms_in_iteration": sum(learn_s) * 1e3 / (
                updates * RL_TIMED_ITERS),
            "kernels_per_update": prof["device_kernels"] / RL_PROFILED
            if isinstance(prof["device_kernels"], int) else "not measured",
            "profiled_updates": RL_PROFILED,
            "update_profile": {k: prof[k] for k in (
                "wall_ms", "device_ms", "device_busy_share",
                "top_kernels")},
            "learner_peak_bytes": peak,
            "episode_return_mean": [r.get("episode_return_mean")
                                    for r in iters],
            "runners": probes, "compute_app_pids": smi_pids}

        # ---- (b) one PPO update, card against CPU ------------------------
        card, cpu = rl_twins(torch, ppo_learner, state)
        gates = rl_grad_gates(torch, "ppo", card.compute_gradients(mb_card),
                              cpu.compute_gradients(mb_cpu))
        _, _, grads = cpu.compute_gradients(mb_cpu)
        card.apply_gradients([g.to(card.device) for g in grads])
        cpu.apply_gradients(grads)
        gates["step_leaf_rel_err"] = rl_step_gate(
            torch, "ppo", card.params, cpu.params)
        out["ppo_update_parity"] = gates

        # ---- (e) two learners over NCCL, a card each ---------------------
        if cards >= 2:
            out["multi_learner"] = rl_multi_learner(
                torch, rt, cfg, spec, obs_space, act_space, flat, weights,
                LearnerGroup, ppo_loss)
        else:
            out["multi_learner"] = "needs two cards"
    finally:
        rt.shutdown()

    # ---- (c) IMPALA V-trace and SAC, card against CPU -------------------
    icfg = IMPALAConfig().environment(env_creator=CartPoleEnv).debugging(
        seed=seed)

    def impala_learner(gpus):
        c = icfg.copy().learners(num_gpus_per_learner=gpus)
        return Learner(spec.build(obs_space, act_space), c, impala_loss(c))

    runner = SingleAgentEnvRunner(CartPoleEnv, spec, 8, 64, seed=seed)
    batch, _ = runner.sample(weights)
    seq = {k: batch[k] for k in ("obs", "actions", "rewards", "dones",
                                 "valid", "logp", "last_obs")}
    card, cpu = rl_twins(torch, impala_learner, state)
    s_card, s_cpu = to_tensors(seq, card.device), to_tensors(seq, "cpu")
    gates = rl_grad_gates(torch, "impala", card.compute_gradients(s_card),
                          cpu.compute_gradients(s_cpu))
    _, _, grads = cpu.compute_gradients(s_cpu)
    card.apply_gradients([g.to(card.device) for g in grads])
    cpu.apply_gradients(grads)
    gates["step_leaf_rel_err"] = rl_step_gate(torch, "impala", card.params,
                                              cpu.params)
    gates["shape"] = list(seq["actions"].shape)
    out["impala_update_parity"] = gates
    out["sac_update_parity"] = rl_sac_parity(torch, np, seed, SACConfig,
                                             SACLearner, ContinuousRLModule,
                                             Box, to_tensors, grads_of)

    # ---- (d) the learning gate, learner on the card ---------------------
    out["learning_gate"] = {"card": rl_learning_gate(seed, 1)}
    if out["learning_gate"]["card"]["best"] < RL_GATE_RETURN:
        out["learning_gate"]["cpu"] = rl_learning_gate(seed, 0)


def rl_sac_parity(torch, np, seed, SACConfig, SACLearner, ContinuousRLModule,
                  Box, to_tensors, grads_of) -> dict:
    """One SAC update at Pendulum-v1's sizes (obs 3, action 1, 256 x 256
    relu, batch 256), card against CPU from one state, the draws given:
    critic and actor losses and grads, the critic's Adam step on the same
    grads, then a whole update's stats."""
    B, obs_dim, act_dim = 256, 3, 1
    rng = np.random.default_rng(seed)
    mb = {"obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
          "actions": rng.uniform(-1, 1, (B, act_dim)).astype(np.float32),
          "rewards": rng.normal(size=B).astype(np.float32),
          "next_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
          "dones": (rng.random(B) < 0.05).astype(np.float32)}
    draws = {k: rng.normal(size=(B, act_dim)).astype(np.float32)
             for k in ("next", "pi")}
    cfg = SACConfig().debugging(seed=seed)
    box = Box(-1.0, 1.0, (obs_dim,))
    act = Box(-2.0, 2.0, (act_dim,))

    def make(gpus):
        c = cfg.copy().learners(num_gpus_per_learner=gpus)
        return SACLearner(cfg.rl_module_spec.build(box, act), c)

    state = make(1).get_state()
    out = {"batch": B, "hiddens": list(cfg.rl_module_spec.hiddens)}
    card, cpu = rl_twins(torch, make, state)
    res = {}
    for name, lrn in (("card", card), ("cpu", cpu)):
        m = to_tensors(mb, lrn.device)
        d = to_tensors(draws, lrn.device)
        alpha = torch.exp(lrn.log_alpha.detach())
        c_loss, _, _ = lrn.critic_loss(m, d, alpha)
        a_loss, _ = lrn.actor_loss(m, d["pi"], alpha)
        res[name] = ((c_loss.detach(), {},
                      grads_of(c_loss, lrn.critic_params())),
                     (a_loss.detach(), {},
                      grads_of(a_loss, list(lrn.actor.values()))))
    out["critic"] = rl_grad_gates(torch, "sac critic", res["card"][0],
                                  res["cpu"][0])
    out["actor"] = rl_grad_gates(torch, "sac actor", res["card"][1],
                                 res["cpu"][1])
    grads = res["cpu"][0][2]
    card._opt_critic.step(card.critic_params(),
                          [g.to(card.device) for g in grads])
    cpu._opt_critic.step(cpu.critic_params(), grads)
    out["critic_step_leaf_rel_err"] = rl_step_gate(
        torch, "sac critic", card.critic_params(), cpu.critic_params())
    card, cpu = rl_twins(torch, make, state)
    got, got_td = card.update(mb, draws=draws)
    want, want_td = cpu.update(mb, draws=draws)
    out["update_stats"] = stats_close(got, want)
    check(all(s["ok"] for s in out["update_stats"].values()),
          f"rllib: a SAC update's stats off the CPU's: {out['update_stats']}")
    out["td_abs_rel_err"] = float(np.abs(got_td - want_td).max()
                                  / np.abs(want_td).max())
    return out


def rl_learning_gate(seed, gpus) -> dict:
    """tests/test_rllib.py:103-119's config (a local runner, 8 envs x 128
    steps, batch 1024, minibatch 256, 12 epochs, lr 3e-4, entropy 0.01),
    the learner on ``gpus`` cards (0: the CPU): iterations to a mean
    return of 450, at most 120."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.envs import CartPoleEnv

    config = (PPOConfig()
              .environment(env_creator=CartPoleEnv)
              .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                           rollout_fragment_length=128)
              .training(train_batch_size=1024, minibatch_size=256,
                        num_epochs=12, lr=3e-4, entropy_coeff=0.01)
              .learners(num_gpus_per_learner=gpus)
              .debugging(seed=seed))
    t = time.perf_counter()
    algo = config.build()
    best, returns = 0.0, []
    for _ in range(RL_GATE_ITERS):
        r = algo.train()
        returns.append(r.get("episode_return_mean"))
        best = max(best, r.get("episode_return_mean", 0.0))
        if best >= RL_GATE_RETURN:
            break
    algo.cleanup()
    return {"device": str(algo.learner_group._local.device),
            "best": best, "iterations": len(returns),
            "timesteps": algo._timesteps_total,
            "seconds": time.perf_counter() - t,
            "returns": returns}


def rl_multi_learner(torch, rt, cfg, spec, obs_space, act_space, flat,
                     weights, LearnerGroup, ppo_loss) -> dict:
    """``num_learners=2``: NCCL learners on a card each against gloo
    learners on the CPU, the same weights, batch (1,024 rows) and seed,
    one epoch of minibatch 128."""
    import numpy as np

    batch = {k: v[:1024] for k, v in flat.items()}
    out, final = {}, {}
    for name, gpus in (("nccl", 1), ("gloo", 0)):
        c = cfg.copy().learners(num_learners=2, num_gpus_per_learner=gpus)
        group = LearnerGroup(c, spec, obs_space, act_space, ppo_loss(c))
        try:
            devices = rt.get([a.device.remote() for a in group._actors],
                             timeout=120)
            group.set_weights(weights)
            t = time.perf_counter()
            stats = group.update(batch, num_epochs=1, minibatch_size=128,
                                 seed=7)
            seconds = time.perf_counter() - t
            w = rt.get([a.get_weights.remote() for a in group._actors],
                       timeout=120)
        finally:
            group.stop()
        check(all(np.array_equal(w[0][k], w[1][k]) for k in w[0]),
              f"rllib {name}: the two learners differ")
        final[name] = {k: torch.from_numpy(v) for k, v in w[0].items()}
        out[name] = {"devices": devices, "stats": stats,
                     "update_s": seconds}
    visible = [d["cuda_visible_devices"] for d in out["nccl"]["devices"]]
    check(all(d["device"].startswith("cuda") for d in out["nccl"]["devices"])
          and len(set(visible)) == 2,
          f"rllib: NCCL learners not on a card each: {out['nccl']}")
    out["param_leaf_rel_err"] = leaf_rel_err(torch, final["nccl"],
                                             final["gloo"])
    check(out["param_leaf_rel_err"] <= RL_LEAF_RTOL,
          f"rllib: NCCL learners {out['param_leaf_rel_err']} off gloo's")
    return out


def layer_matmul_params(cfg) -> int:
    """Weights one decoder layer multiplies by: wq, wk, wv, wo and the
    SwiGLU's gate, up and down."""
    hd = cfg.head_dim
    return (2 * cfg.dim * cfg.n_heads * hd
            + 2 * cfg.dim * cfg.n_kv_heads * hd + 3 * cfg.dim * cfg.mlp_dim)


def analytic_prefill_flops(cfg, tpad: int) -> int:
    """FLOPs the observatory counts for one prefill at padded length
    ``tpad`` on the card: each matmul weight twice a token (the layers
    and the head, logits at every position), plus the forward kernel's
    ``attention_work`` in each layer."""
    fwd = attention_work(1, tpad, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, True)[0]
    return 2 * tpad * (cfg.n_layers * layer_matmul_params(cfg)
                       + cfg.dim * cfg.vocab_size) + cfg.n_layers * fwd


def analytic_decode_flops(cfg, tpad: int) -> int:
    """FLOPs of one decode step over a page-padded view of ``tpad``
    positions: the weights twice, and in each layer the two attention
    products of the new token over ``tpad`` + 1 keys (plain torch)."""
    return 2 * (cfg.n_layers * layer_matmul_params(cfg)
                + cfg.dim * cfg.vocab_size) \
        + cfg.n_layers * 4 * cfg.n_heads * (tpad + 1) * cfg.head_dim


def analytic_train_step_flops(cfg, rows: int, T: int, schedule: str) -> dict:
    """FLOPs the observatory counts for one train step of ``rows`` x
    ``T`` tokens on one rank on the card (every layer's weights on the
    rank, as fsdp and the size-1 mesh give): the matmuls' forward (2 a
    weight a token) and backward (4); the layers' forward once more
    under remat: all of it under the streamed fsdp schedule (its backward
    recomputes the layer), all but the last matmul (w_down) under
    ``checkpoint``, whose recompute stops at the last tensor the backward
    saved; the head likewise, its forward recomputed whole when the loss
    is chunked (the log-softmax output is saved); and each attention
    kernel's ``attention_work``, the forward twice under remat."""
    n = rows * T
    L = cfg.n_layers
    weights = layer_matmul_params(cfg)
    if schedule == "streamed":
        layer_passes = 4 * weights
    elif cfg.remat:
        layer_passes = 4 * weights - cfg.dim * cfg.mlp_dim
    else:
        layer_passes = 3 * weights
    chunked = bool(cfg.loss_chunk) and T > cfg.loss_chunk
    head = 2 * n * cfg.dim * cfg.vocab_size * (4 if chunked else 3)
    remat = cfg.remat or schedule == "streamed"
    kernels = {k: L * (2 if remat and k == "fwd" else 1)
               * attention_work(rows, T, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, True, k)[0]
               for k in ("fwd", "dq", "dkv")}
    matmuls = 2 * n * L * layer_passes + head
    return {"matmuls": matmuls, "kernels": kernels,
            "total": matmuls + sum(kernels.values())}


def kernel_tally_ok(kernels: dict, launches: dict, work: dict) -> bool:
    """A program's kernel tally: the launches expected, and each launch's
    FLOPs the kernel's ``attention_work`` (``work[kernel]``)."""
    return {k: c["launches"] for k, c in kernels.items()} == {
        k: n for k, n in launches.items() if n} and all(
        c["flops"] == c["launches"] * work[k] for k, c in kernels.items())


def _close(got: float, want: float, rtol: float) -> bool:
    return abs(got - want) <= rtol * abs(want)


def _variants_match(by_variant: list, want: list, rtol: float) -> list:
    """Pair each bucket's analytic FLOPs (ascending) with the variants'
    counted FLOPs (ascending); returns the pairs, or raises when they
    differ in number or a pair misses ``rtol``."""
    got = sorted(v.get("flops", 0.0) for v in by_variant)
    pairs = list(zip(got, sorted(want)))
    check(len(got) == len(want) and all(_close(g, w, rtol)
                                        for g, w in pairs),
          f"counted FLOPs by variant {got} against analytic {sorted(want)}")
    return pairs


def check_engine_programs(cfg, variants: dict, tpads: dict) -> dict:
    """The analysed variants of a decode engine's two programs
    (``variants[program]``, the records' ``by_variant`` entries) against
    the analytic FLOPs at the padded lengths they were analysed at
    (``tpads[kind]``), and each analysed prefill's kernel tally against
    ``attention_work``. Returns the pairs and tallies; raises on a miss."""
    out = {}
    for program, kind, analytic in (
            ("llama.prefill", "prefill", analytic_prefill_flops),
            ("llama.decode", "decode", analytic_decode_flops)):
        analysed = [v for v in variants[program] if v["analysed"]]
        lengths = sorted(tpads[kind])
        out[program] = {"flops_counted_analytic": _variants_match(
            analysed, [analytic(cfg, t) for t in lengths],
            PROGRAM_FLOPS_RTOL)}
        if kind != "prefill":
            continue
        by_flops = sorted(analysed, key=lambda v: v["flops"])
        for tpad, v in zip(lengths, by_flops):
            work = attention_work(1, tpad, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, True)[0]
            check(kernel_tally_ok(v.get("kernels", {}),
                                  {"fwd": cfg.n_layers}, {"fwd": work}),
                  f"llama.prefill at {tpad}: kernel tally "
                  f"{v.get('kernels')}")
        out[program]["kernels_by_bucket"] = {
            tpad: v.get("kernels") for tpad, v in zip(lengths, by_flops)}
    return out


def serve_run(torch, np, seed, observe: bool, deployment: str):
    """A 2-layer Llama-3-8B engine under a DecodeScheduler, observation
    on or off: four requests (one a prefix hit) of 8 greedy tokens.
    Observed, the engine analyses the first call of every bucket.
    Returns (tokens by request, forward launches, max_memory_allocated
    over the run, the engine's programs checked against the analytic
    counts or None)."""
    from ray_tpu_torch.core.config import global_config
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import flash_attention_forward
    from ray_tpu_torch.serve.decode import DecodeScheduler
    from ray_tpu_torch.util import program_observatory as po

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    names = ("llama.prefill", "llama.decode")
    seen = {p: len((po.get_program(p) or {}).get("by_variant", ()))
            for p in names}
    knobs = global_config()
    observed = knobs.xla_observatory_enabled
    knobs.xla_observatory_enabled = observe
    try:
        engine = llama.LlamaDecodeEngine(cfg, n_pages=256, page_size=16,
                                         seed=seed)
        if observe:
            engine._prefill_fn.max_analysed = None
            engine._decode_fn.max_analysed = None
        rng = np.random.RandomState(seed)
        prompts = {f"p{n}": rng.randint(0, cfg.vocab_size, n).tolist()
                   for n in (7, 200, 1000)}
        prompts["p200_repeat"] = list(prompts["p200"])
        sched = DecodeScheduler(engine, deployment=deployment)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash_attention_forward.launches = 0
        for corr, prompt in prompts.items():
            check(sched.submit(corr, {"prompt": prompt, "max_tokens": 8})
                  is None, f"request {corr} refused")
        finals = {}
        active = True
        while active:
            replies, active = sched.step()
            for corr, kind, payload in replies:
                check(kind != "error", f"request {corr} failed: {payload}")
                if kind == "final":
                    finals[corr] = json.loads(payload)["tokens"]
        torch.cuda.synchronize()
        programs = None
        if observe:
            # the records are shared by name: this engine's variants are
            # the ones after those seen before the run
            buckets = engine.buckets()
            variants = {p: po.get_program(p)["by_variant"][seen[p]:]
                        for p in names}
            for p, kind in zip(names, ("prefill", "decode")):
                check(len(variants[p]) == len(buckets[kind])
                      and all(v["analysed"] for v in variants[p]),
                      f"{p}: {len(variants[p])} variants for "
                      f"{len(buckets[kind])} buckets, every one analysed")
            programs = check_engine_programs(cfg, variants, buckets)
        out = (finals, flash_attention_forward.launches,
               torch.cuda.max_memory_allocated(), programs)
    finally:
        knobs.xla_observatory_enabled = observed
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    return out


def span_counts(deployment: str) -> dict:
    """This process's recorded spans by name, those tagged with
    ``deployment`` or untagged."""
    from ray_tpu_torch.util import flight_recorder as fr

    counts: dict = {}
    for ev in fr.build_span_events([fr.snapshot_payload()]):
        if ev["args"].get("deployment", deployment) == deployment:
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


def phase_observability(torch, np, seed, smi, peaks, served, trained,
                        timeout=600.0):
    """The observation on the serving and ``spmd`` phases' paths, read
    from what those phases left: the program registry, the KV and token
    metrics and the spans of the serving phase (this process), and rank
    0's program report of the first ``spmd`` layout; then a 2-layer run
    of each path with observation off and on (the same tokens, loss,
    grad norm and launches, the same peak memory), and the device
    telemetry gauges against the allocator."""
    from ray_tpu_torch.core.config import global_config
    from ray_tpu_torch.train.launch import launch
    from ray_tpu_torch.train.spmd_runs import train_jobs
    from ray_tpu_torch.util import device_telemetry, metrics
    from ray_tpu_torch.util import program_observatory as po

    snap = metrics.registry().snapshot()

    def value(metric, **tags):
        return snap.get(metric, {}).get("values", {}).get(
            tuple(sorted(tags.items())))

    # serving: the engine's two programs count every bucket as a variant
    # and analyse the first ANALYSED_FIRST_CALLS of them, in the order
    # served
    cfg = served["cfg"]
    buckets = served["buckets"]
    programs, variants, analysed_at = {}, {}, {}
    for program, kind in (("llama.prefill", "prefill"),
                          ("llama.decode", "decode")):
        rec = po.get_program(program)
        check(rec is not None, f"{program} was not observed")
        n = len(buckets[kind])
        k = min(n, po.ANALYSED_FIRST_CALLS)
        check(rec["variants"] == n and rec["compiles"] == n
              and rec["recompiles"] == n - 1 and rec["analysed"] == k,
              f"{program}: {rec['variants']} variants, {rec['compiles']} "
              f"compiles, {rec['recompiles']} recompiles, "
              f"{rec['analysed']} analysed for {n} buckets")
        check([v["analysed"] for v in rec["by_variant"]]
              == [True] * k + [False] * (n - k),
              f"{program}: analysed other variants than the first {k}")
        check(value("port_serve_decode_buckets", kind=kind) == n,
              f"decode-bucket gauge {kind} is not {n}")
        variants[program] = rec["by_variant"]
        analysed_at[kind] = served["tpads_in_order"][kind][:k]
        programs[program] = {
            "variants": rec["variants"], "recompiles": rec["recompiles"],
            "analysed": rec["analysed"], "analysed_at": analysed_at[kind],
            "compile_seconds": rec["compile_seconds"],
            "peak_bytes": rec.get("peak_bytes"),
            "bytes_accessed": rec.get("bytes_accessed")}
    for program, checked in check_engine_programs(cfg, variants,
                                                  analysed_at).items():
        programs[program].update(checked)

    # serving: metrics and spans against the scheduler's ground truth
    dep = SERVE_DEPLOYMENT
    truth = served["kv_truth"]
    gauges = {"pages_used": value("port_serve_kv_pages_used", deployment=dep),
              "pages_capacity": value("port_serve_kv_pages_capacity",
                                      deployment=dep),
              "prefix_hit_rate": value("port_serve_kv_prefix_hit_rate",
                                       deployment=dep)}
    check(gauges == {k: float(v) for k, v in truth.items()},
          f"KV gauges {gauges} against the pool's {truth}")
    tokens = value("port_serve_tokens_generated_total", deployment=dep)
    check(tokens == served["tokens_emitted"] == served["tokens_generated"],
          f"tokens generated {tokens}, emitted {served['tokens_emitted']}, "
          f"in the final frames {served['tokens_generated']}")
    itl = value("port_serve_itl_seconds", deployment=dep) or {}
    spans = span_counts(dep)
    check(spans.get("serve.decode_step") == served["decode_iterations"],
          f"{spans.get('serve.decode_step')} serve.decode_step spans for "
          f"{served['decode_iterations']} decode iterations")
    check(spans.get("serve.prefill") == served["admissions"],
          f"{spans.get('serve.prefill')} serve.prefill spans for "
          f"{served['admissions']} admissions")
    report = po.program_report()
    decode_ms = served["decode_s"] / served["decode_calls"] * 1e3
    decode_row = report["programs"]["llama.decode"]
    n_params = cfg.num_params()
    serving = {
        "kv_gauges": gauges, "tokens_generated": tokens,
        "itl_samples": itl.get("count"),
        "spans": {k: spans.get(k) for k in ("serve.prefill",
                                            "serve.decode_step")},
        "decode_iterations": served["decode_iterations"],
        "decode_ms_per_token": decode_ms,
        # the report's decode MFU is per scheduler iteration: one
        # serve.decode_step span covers an engine decode per running
        # sequence, over the FLOPs of one analysed decode
        "decode_mfu_report": decode_row.get("mfu"),
        "decode_mfu_report_basis": "per serve.decode_step iteration",
        "decode_mfu_own": 2.0 * n_params * served["decode_calls"]
        / served["decode_s"] / peaks[0],
        "decode_report_mean_step_ms": decode_row.get("mean_step_s", 0) * 1e3,
        "prefill_mfu_report": report["programs"]["llama.prefill"].get("mfu"),
        "observation_us_per_call": served["observation_s"] * 1e6,
        "observation_share_of_decode": served["observation_s"] * 1e3
        / decode_ms}
    check(serving["observation_share_of_decode"] <= OBSERVATION_COST_MAX,
          f"observing a decode step costs "
          f"{serving['observation_share_of_decode']} of its time")

    # training: rank 0's observed spmd.train_step in the first layout
    tcfg, T = trained["cfg"], trained["T"]
    rep = trained["reps"][0]
    rows = rep["local_batch"]
    row = rep["programs"]["spmd.train_step"]
    want = analytic_train_step_flops(tcfg, rows, T, rep["gather"])
    work = {k: attention_work(rows, T, tcfg.n_heads, tcfg.n_kv_heads,
                              tcfg.head_dim, True, k)[0]
            for k in ("fwd", "dq", "dkv")}
    check(_close(row["flops"], want["total"], TRAIN_STEP_FLOPS_RTOL),
          f"spmd.train_step counted {row['flops']} FLOPs, analytic "
          f"{want['total']}")
    check(kernel_tally_ok(row.get("kernels", {}),
                          rank_launches(tcfg, 1, rep), work),
          f"spmd.train_step kernel tally {row.get('kernels')}")
    model_flops = 6 * tcfg.num_params() + 6 * tcfg.n_layers \
        * tcfg.n_heads * T * tcfg.head_dim
    own_mfu = model_flops * trained["tokens_per_s"] / len(trained["reps"]) \
        / peaks[0]
    ratio = row["mfu"] / own_mfu
    want_ratio = row["flops"] / (model_flops * rows * T)
    step_ms = trained["step_ms"]
    train_cost = rep["observation_cost_s"] * 1e3 / step_ms
    training = {
        "layout": trained["layout"], "rows": rows, "T": T,
        "flops_counted": row["flops"], "flops_analytic": want,
        "flops_by_op": row.get("flops_by_op"), "kernels": row.get("kernels"),
        "bytes_accessed": row.get("bytes_accessed"),
        "peak_bytes": row.get("peak_bytes"), "memory": row.get("memory"),
        "compile_seconds": row["compile_seconds"],
        "arithmetic_intensity": row.get("arithmetic_intensity"),
        "verdict": row.get("verdict"),
        "mfu_report": row["mfu"], "mean_step_ms_report":
        row["mean_step_s"] * 1e3, "measured_steps": row["measured_steps"],
        "mfu_own_6N_attn": own_mfu, "step_ms_own": step_ms,
        "mfu_ratio": ratio, "mfu_ratio_expected": want_ratio,
        "observation_us_per_call": rep["observation_cost_s"] * 1e6,
        "observation_share_of_step": train_cost}
    check(rep["observation_hits"] == OBSERVATION_CALLS,
          "the train step's fingerprint was not seen")
    check(_close(ratio, want_ratio, MFU_RATIO_RTOL),
          f"report MFU / own MFU {ratio}, want {want_ratio}")
    check(train_cost <= OBSERVATION_COST_MAX,
          f"observing a train step costs {train_cost} of its time")
    check(row["verdict_enforced"] is True and row["verdict"],
          f"no enforced roofline verdict for spmd.train_step: {row}")

    # observation off and on, 2 layers at full width
    serve_off = serve_run(torch, np, seed, False, "observe_off")
    serve_on = serve_run(torch, np, seed, True, "observe_on")
    full = trained["cfg"]
    two = dataclasses.replace(full, n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, full.vocab_size, (4, 2049), device="cuda",
                         generator=gen).cpu().numpy()
    jobs = [dict(cfg=two, mesh="", gather="upfront", step="spmd", init=seed,
                 tokens=toks, steps=1, observe=observe)
            for observe in (False, True)]
    train_off, train_on = launch(train_jobs, 1, (jobs,), timeout=timeout)[0]
    off_on = {
        "serving": {"tokens_equal": serve_off[0] == serve_on[0],
                    "launches": [serve_off[1], serve_on[1]],
                    "max_memory_allocated": [serve_off[2], serve_on[2]],
                    "programs_every_bucket_analysed": serve_on[3]},
        "training": {"loss": [train_off["losses"][0],
                              train_on["losses"][0]],
                     "grad_norm": [train_off["grad_norm"],
                                   train_on["grad_norm"]],
                     "launches": [train_off["launches"],
                                  train_on["launches"]],
                     "max_memory_allocated": [train_off["peak_bytes"],
                                              train_on["peak_bytes"]]}}
    check(serve_off[0] == serve_on[0] and len(serve_on[0]) == 4,
          "observation changed the greedy tokens")
    check(serve_off[1] == serve_on[1] == 2 * 3,
          f"serving launches off/on {serve_off[1]}/{serve_on[1]}")
    check(_close(serve_on[2], serve_off[2], OBSERVED_PEAK_RTOL),
          f"serving peak memory off/on {serve_off[2]}/{serve_on[2]}")
    check(train_off["losses"][0] == train_on["losses"][0]
          and train_off["grad_norm"] == train_on["grad_norm"],
          f"observation changed the first step: {off_on['training']}")
    check(train_off["launches"] == train_on["launches"]
          == rank_launches(two, 1, train_on),
          f"training launches off/on {off_on['training']['launches']}")
    check(_close(train_on["peak_bytes"], train_off["peak_bytes"],
                 OBSERVED_PEAK_RTOL),
          f"training peak memory off/on {off_on['training']}")
    check("spmd.train_step" in train_on["programs"]
          and "spmd.train_step" not in train_off["programs"],
          "the knob did not switch the train step's observation")

    # device telemetry against the allocator: the collector thread at
    # the knob's interval while nothing allocates, on every card this
    # process allocated on (and no other)
    knobs = global_config()
    interval_ms = knobs.device_telemetry_interval_ms
    knobs.device_telemetry_interval_ms = TELEMETRY_INTERVAL_MS
    torch.cuda.synchronize()
    stop = device_telemetry.start_device_telemetry()
    try:
        time.sleep(5 * TELEMETRY_INTERVAL_MS / 1e3)
    finally:
        stop.set()
        knobs.device_telemetry_interval_ms = interval_ms
    snap = metrics.registry().snapshot()
    cards = [i for i in range(torch.cuda.device_count())
             if torch.cuda.max_memory_allocated(i)]
    telemetry = {f"cuda:{i}": {
        "bytes_in_use": value("port_device_bytes_in_use",
                              device=f"cuda:{i}", node="local"),
        "peak_bytes_in_use": value("port_device_peak_bytes_in_use",
                                   device=f"cuda:{i}", node="local"),
        "memory_allocated": torch.cuda.memory_allocated(i),
        "max_memory_allocated": torch.cuda.max_memory_allocated(i)}
        for i in range(torch.cuda.device_count())}
    published = [d for d, t in telemetry.items()
                 if t["bytes_in_use"] is not None]
    check(published == [f"cuda:{i}" for i in cards] and all(
        t["bytes_in_use"] == t["memory_allocated"]
        and t["peak_bytes_in_use"] == t["max_memory_allocated"]
        for d, t in telemetry.items() if d in published),
        f"telemetry against the allocator: {telemetry}")
    check(device_telemetry.collect_once() == len(cards),
          f"collect_once published other cards than {cards}")
    events = {dict(k)["event"]: v for k, v in
              snap.get("port_compile_events_total", {}).get(
                  "values", {}).items()}
    emit({"phase": "observability", "card": smi,
          "peak_flops_per_chip": report["peak_flops_per_chip"],
          "peak_hbm_bytes_per_sec": report["peak_hbm_bytes_per_sec"],
          "programs": programs, "serving": serving, "training": training,
          "off_on_2_layers": off_on, "telemetry": telemetry,
          "compile_events": events,
          "report": po.format_programs(report).splitlines()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from ray_tpu_torch.ops import _build

    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "environment", "nvidia_smi": smi, "device": name,
          "capability": list(cap), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          # the serve proxy is on the standard library either way
          "aiohttp": importlib.util.find_spec("aiohttp") is not None,
          # the RL path steps its own envs either way
          "gymnasium": importlib.util.find_spec("gymnasium") is not None})
    check(cap == (9, 0), f"needs an sm_90 card, found sm_{cap[0]}{cap[1]}")

    phase_build(_build)
    peaks = peaks_for(name)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    err_o, err_lse, err_ratio, fwd_timing = phase_kernel(torch, gen,
                                                         peaks)
    bwd_err, bwd_ratio, bwd_block, bwd_delta, bwd_timing = phase_backward(
        torch, gen, peaks)
    torch.cuda.empty_cache()
    seq_ring_launches = phase_seq_ring(torch, gen, peaks, smi)
    torch.cuda.empty_cache()
    phase_reduced_depth(torch, args.seed)
    phase_reduced_depth_train(torch, args.seed)
    torch.cuda.empty_cache()
    serving_launches, served = phase_serving(torch, np, args.seed, smi)
    gc.collect()  # the serving engine holds reference cycles
    torch.cuda.empty_cache()
    serve_plane_launches = phase_serve_plane(torch, np, args.seed, smi,
                                             served)
    phase_dag(torch, smi)
    train_launches = phase_training(torch, args.seed, smi, peaks[0])
    gc.collect()
    torch.cuda.empty_cache()
    spmd_launches, trained = phase_spmd(torch, args.seed, smi, peaks[0])
    gc.collect()
    torch.cuda.empty_cache()
    trainer_launches = phase_trainer_paths(torch, args.seed, smi, peaks[0],
                                           trained)
    torch.cuda.empty_cache()
    mpmd_launches = phase_mpmd(torch, np, args.seed, smi, peaks[0], trained)
    gc.collect()
    torch.cuda.empty_cache()
    tune_launches = phase_tune(torch, args.seed, smi)
    torch.cuda.empty_cache()
    phase_rllib(torch, np, args.seed, smi)  # launches no attention kernel
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches = phase_moe(torch, args.seed, smi, peaks[0])
    gc.collect()
    torch.cuda.empty_cache()
    phase_observability(torch, np, args.seed, smi, peaks, served, trained)

    # each path's launches, read from its own run: the one-card ring, the
    # single-device step, the sharded steps, the pipeline (all ranks), the
    # trainer's paths, the MPMD pipeline's stages (timed steps), the Tune
    # trials' workers and the MoE decoder's steps (one card, and all ranks
    # across cards)
    by_path = {"seq_ring": seq_ring_launches, "training": train_launches,
               **spmd_launches, **trainer_launches, **mpmd_launches,
               **tune_launches, **moe_launches}
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "ratio_to_library", "achieved_tflops", "share_of_bound")
    shapes = {label: fwd_timing[label]["shape"] for label in fwd_timing}
    src = "ray_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": src + "flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:62",
        "design": "wgmma fed by TMA (flash_attention_sm90.cuh)",
        "launches": serving_launches + sum(serve_plane_launches) + sum(
            n["fwd"] for n in by_path.values()),
        "launches_by_path": {"serving": serving_launches,
                             "serve_plane": serve_plane_launches[0],
                             "serve_plane_compiled": serve_plane_launches[1],
                             "serve_plane_head_proxy":
                                 serve_plane_launches[2],
                             **{p: n["fwd"] for p, n in by_path.items()}},
        "max_abs_err": err_o, "max_abs_err_lse": err_lse,
        "tolerance": {"atol": KERNEL_ATOL, "rtol": KERNEL_RTOL},
        "ok": err_ratio <= 1.0,
        **{k: fwd_timing["table"][k] for k in timed},
        "shape": shapes["table"],
        "at_train_shape": {"shape": shapes["train"],
                           **{k: fwd_timing["train"][k] for k in timed}}}]
    for kern, replaces, errs, design in (
            ("dq", ":135", ("dq",),
             "wgmma fed by TMA (flash_attention_sm90.cuh), delta fused"),
            ("dkv", ":169", ("dk", "dv"),
             "wgmma fed by TMA (flash_attention_sm90.cuh)")):
        kernels.append({
            "name": f"flash_attention_bwd_{kern}", "route": "cuda",
            "source": src + "flash_attention_bwd.cu",
            "replaces": "ray_tpu/ops/flash_attention.py" + replaces,
            "design": design,
            "launches": sum(n[kern] for n in by_path.values()),
            "launches_by_path": {p: n[kern] for p, n in by_path.items()},
            "max_abs_err": max(bwd_err[e] for e in errs),
            "max_abs_err_each": {e: bwd_err[e] for e in errs},
            "block_rel_err_each": {e: bwd_block[e] for e in errs},
            **({"delta": bwd_delta} if kern == "dq" else {}),
            "tolerance": {"atol": GRAD_ATOL, "rtol": GRAD_RTOL,
                          "block_rtol": GRAD_BLOCK_RTOL},
            "ok": bwd_ratio[kern] <= 1.0
            and max(bwd_block[e] for e in errs) <= GRAD_BLOCK_RTOL,
            **{k: bwd_timing["train"][kern][k] for k in timed},
            "shape": shapes["train"],
            "at_table_shape": {"shape": shapes["table"],
                               **{k: bwd_timing["table"][kern][k]
                                  for k in timed}}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

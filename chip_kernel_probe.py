#!/usr/bin/env python3
"""Device time of the attention kernels of one tree of the port, by
kernel, on one card: ``python3 chip_kernel_probe.py <root> [--sweep]
[--trace] [--ptxas] [--sass-against <other root>] [--bits-save <file> |
--bits-against <file>]``, where ``<root>`` holds a ``ray_tpu_torch``
package (``.`` for this checkout).

``chip_kernel_ab.py`` times whole wrapper calls back to back with CUDA
events, which at 0.05–0.15 ms kernels also reads the host's launch path
(ctypes, TMA maps). This script reads what the card spent in each kernel
instead: ``torch.profiler``'s device time of each kernel over 60 calls
of each wrapper (forward, dQ, dK/dV) at ``chip_kernel_ab.py``'s shapes
(the head_dim-512 slab kernels at "d512 train" and, float32, "d512
f32"; float32 at "train f32", each wrapper with its split pass: the
forward's flash_fwd_split_kernel, dQ's and dK/dV's
flash_bwd_split_kernel), causal, beside the host's
time to enqueue a call (with the card kept busy, so the enqueue is not
waited on). With ``--sweep`` (a tree
with ``ops/flash_schedule.py``), it forces the head_dim-256 split counts
at the "d256" row instead, five rounds in turns, and reads each count's
device time (kernel and second pass): the forward's split q tiles and
the dK/dV chunks. With ``--trace`` (a tree whose backward source takes
``-DWIDE_TRACE=1``), it also builds the bf16 backward with the phase
counters of the cluster dK/dV kernel and the head_dim-256 dQ kernel and
reads, at "d512 train" and "d256", the clock64 cycles a step of each
consumer spends in each phase (thread 0 of each consumer warpgroup,
summed over blocks and steps, over the steps).
With ``--ptxas``, it reads each kernel's registers, spills and ptxas's
notes on its wgmma (C75xx) from the build logs
(``chip_smoke.ptxas_report``). With ``--sass-against``, it compares the
SASS of every
kernel instantiation the two trees' libraries share (``cuobjdump``,
register numbers aside). With ``--bits-save``, it writes the tree's
float32 o, lse, dq, delta, dk and dv at BITS_SHAPES and its bf16 and
fp16 dq and delta at BITS16_SHAPES (seed 0) to a file; with
``--bits-against``, it compares its own with that file's bitwise (each
tree in its own process, so each imports its own package). Prints one
JSON line. Exits 2 without a card.
"""

from __future__ import annotations

import glob
import json
import os
import re
import statistics
import subprocess
import sys
import time

# chip_kernel_ab.py's rows: (B, T, Hq, Hkv, D), dtype
SHAPES = (("table", (1, 2048, 32, 8, 128), "bfloat16"),
          ("train", (4, 2048, 32, 8, 64), "bfloat16"),
          ("d256", (1, 2048, 8, 1, 256), "bfloat16"),
          ("d512 train", (4, 2048, 4, 1, 512), "bfloat16"),
          ("train f32", (4, 2048, 32, 8, 64), "float32"),
          ("d512 f32", (4, 2048, 4, 1, 512), "float32"))
SHAPE = {label: shape for label, shape, _ in SHAPES}
CALLS = 60
# float32 shapes whose outputs two trees compare bitwise: "train f32",
# head_dim 128 at a ragged T, 256 (the columns-split dK/dV), 3 (parts)
BITS_SHAPES = (("train f32", (4, 2048, 32, 8, 64)),
               ("d128", (1, 257, 8, 2, 128)), ("d256", (1, 300, 8, 1, 256)),
               ("d3", (2, 65, 4, 2, 3)))
# 16-bit shapes whose dq and delta two trees compare bitwise: "d256" in
# bf16 and fp16, and head_dim 200 (read at 256) at a ragged T
BITS16_SHAPES = (("d256 bf16", (1, 2048, 8, 1, 256), "bfloat16"),
                 ("d256 f16", (1, 2048, 8, 1, 256), "float16"),
                 ("d200 bf16", (1, 300, 8, 2, 200), "bfloat16"))
FWD_SPLITS = (0, 2, 3, 4, 5, 6, 8, 10, 14)
DKV_CHUNKS = (1, 4, 6, 7, 8, 9, 12, 16)
ROUNDS = 5


def device_ms(torch, fn, calls: int = CALLS) -> dict:
    """Device ms a call of each kernel ``fn`` launches, from the
    profiler, after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0)
        if t and "flash" in ev.key:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", ev.key)
            out[name.split("(")[0]] = t / calls / 1e3
    return out


def host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds to enqueue a call while the card is busy."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    a @ a
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dt


def inputs(torch, fa, gen, B, T, Hq, Hkv, D, dtype="bfloat16"):
    q, k, v, do = (torch.randn(B, T, h, D, device="cuda", generator=gen)
                   .to(getattr(torch, dtype)) for h in (Hq, Hkv, Hkv, Hq))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    return {"fwd": lambda: fa.flash_attention_forward(q, k, v, True),
            "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, o, do, lse,
                                                    True),
            "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, True)}


def sweep(torch, fa, gen) -> dict:
    """The d256 forward and dK/dV at forced split counts: each count's
    device ms (kernel and second pass) in ROUNDS rounds, and the median."""
    from ray_tpu_torch.ops import flash_schedule as fs

    calls = inputs(torch, fa, gen, *SHAPE["d256"])
    real = fs.forward_split_tiles, fs.dkv_split
    runs = {"fwd_split_tiles": {}, "dkv_chunks": {}}
    try:
        for _ in range(ROUNDS):
            for n in FWD_SPLITS:
                fs.forward_split_tiles = lambda *a, n=n: n
                runs["fwd_split_tiles"].setdefault(n, []).append(
                    sum(device_ms(torch, calls["fwd"]).values()))
            for n in DKV_CHUNKS:
                fs.dkv_split = lambda *a, n=n: n
                runs["dkv_chunks"].setdefault(n, []).append(
                    sum(device_ms(torch, calls["dkv"]).values()))
    finally:
        fs.forward_split_tiles, fs.dkv_split = real
    return {kind: {n: {"median_ms": statistics.median(r), "ms_each": r}
                   for n, r in by.items()} for kind, by in runs.items()}


# the traced kernels' phases, by their index in their TRACE points: the
# cluster dK/dV kernel's at "d512 train", the head_dim-256 dQ kernel's at
# "d256" (each consumer: its product's wait, its elementwise step, P or
# dS, the wait for the other's hand-off, issuing dS K, the wait for the
# next tile's K or V before its product, the wait for dS K)
TRACE_PHASES = {
    "dkv": ("d512 train", ("stage wait", "partial", "sent slot free", "send",
                           "receive wait", "sum", "P/dS and hand-off",
                           "slab product")),
    "dq": ("d256", ("product wait", "P or dS", "hand-off wait",
                    "dS K issue", "stage wait", "dS K wait"))}


def trace_steps(kernel: str, B, T, Hq, Hkv, D) -> int:
    """A call's (block, step) pairs of a traced kernel, causal."""
    from ray_tpu_torch.ops import flash_schedule as fs

    if kernel == "dq":
        return sum(blk[3] for blk in fs.dq256_blocks(B, T, Hq, True))
    rep = Hq // Hkv
    return B * Hkv * _cdiv(D, fs.WIDE_SLAB) * sum(
        rep * _cdiv(T - 64 * t, 64) for t in range(_cdiv(T, 64)))


def trace(torch, fa, gen) -> dict:
    """Cycles a step of each consumer of each traced kernel spends in each
    phase (bf16, causal), from a build with -DWIDE_TRACE=1, over 5 calls;
    beside both builds' device ms."""
    import ctypes

    from ray_tpu_torch.ops import _build

    calls = {kernel: inputs(torch, fa, gen, *SHAPE[row])[kernel]
             for kernel, (row, _) in TRACE_PHASES.items()}
    sound_ms = {kernel: sum(device_ms(torch, fn).values())
                for kernel, fn in calls.items()}
    out = _build.BUILD_DIR / "trace" / "libflash_attention_bwd_bf16.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DWIDE_TRACE=1",
                    "-DFLASH_DTYPE=0", "-o", str(out),
                    str(_build.CSRC / "flash_attention_bwd.cu")],
                   check=True, capture_output=True)
    sound = _build._loaded.get("flash_attention_bwd_bf16")
    lib = _build._loaded["flash_attention_bwd_bf16"] = ctypes.CDLL(str(out))
    result = {}
    try:
        counts = (ctypes.c_ulonglong * 32)()
        for kernel, (row, phases) in TRACE_PHASES.items():
            calls[kernel]()
            torch.cuda.synchronize()
            lib.flash_wide_trace(counts)  # read and zeroed
            n_calls = 5
            for _ in range(n_calls):
                calls[kernel]()
            torch.cuda.synchronize()
            lib.flash_wide_trace(counts)
            steps = n_calls * trace_steps(kernel, *SHAPE[row])
            result[kernel] = {
                "at": row, "device_ms": sound_ms[kernel],
                "traced_device_ms": sum(device_ms(torch,
                                                  calls[kernel]).values()),
                "steps": steps, "cycles_a_step": {
                    f"consumer {c}": {name: counts[16 * c + i] / steps
                                      for i, name in enumerate(phases)}
                    for c in (0, 1)}}
    finally:
        _build._loaded["flash_attention_bwd_bf16"] = sound
    return result


def bits_outputs(torch, fa) -> dict:
    """The float32 forward, dQ and dK/dV wrappers' outputs at BITS_SHAPES
    and the 16-bit dQ wrapper's at BITS16_SHAPES, causal, on the CPU."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, (B, T, Hq, Hkv, D) in BITS_SHAPES:
        q, k, v, do = (torch.randn(B, T, h, D, device="cuda", generator=gen)
                       for h in (Hq, Hkv, Hkv, Hq))
        o, lse = fa.flash_attention_forward(q, k, v, True)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
        out[label] = {name: t.cpu() for name, t in zip(
            ("o", "lse", "dq", "delta", "dk", "dv"),
            (o, lse, dq, delta, dk, dv))}
    for label, (B, T, Hq, Hkv, D), dtype in BITS16_SHAPES:
        q, k, v, do = (torch.randn(B, T, h, D, device="cuda", generator=gen)
                       .to(getattr(torch, dtype)) for h in (Hq, Hkv, Hkv, Hq))
        o, lse = fa.flash_attention_forward(q, k, v, True)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
        out[label] = {"dq": dq.cpu(), "delta": delta.cpu()}
    return out


def bits_against(torch, mine: dict, theirs: dict) -> dict:
    """Per shape and output, whether the two trees' bits are equal, and
    the largest |difference| of each shape."""
    return {label: {**{name: torch.equal(t, theirs[label][name])
                       for name, t in outs.items()},
                    "max_abs_diff": max((t - theirs[label][name]).abs()
                                        .max().item()
                                        for name, t in outs.items())}
            for label, outs in mine.items()}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sass(lib: str) -> dict:
    """Each kernel function's SASS instructions, register numbers and
    immediates blanked, from ``cuobjdump -sass``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    text = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            k = re.search(r"\d(flash_(?:fwd|bwd)\w*?_kernel"
                          r"(?:ILi\d+E(?:Li\d+E)*)?)", m.group(1))
            key = k.group(1) if k else m.group(1)
            # a narrow head_dim's instantiation: A operands in two parts
            parts = re.search(r"(?:__nv_bfloat16|__half|f)Li(\d)EE",
                              m.group(1))
            if parts and parts.group(1) != "1":
                key += f"<{parts.group(1)} parts>"
            cur = out.setdefault(key, [])
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append(re.sub(r"\bU?R\d+\b|\bU?P\d\b|0x[0-9a-f]+|\.reuse",
                              "_", m.group(1)))
    return out


def sass_against(root: str, other: str) -> dict:
    """"same" or the instruction counts, per library and kernel both
    trees' built libraries have."""
    out = {}
    for lib in sorted(glob.glob(os.path.join(
            root, "ray_tpu_torch/_build/libflash_attention_*.so"))):
        name = os.path.basename(lib).rsplit("-", 1)[0]
        theirs = glob.glob(os.path.join(
            other, f"ray_tpu_torch/_build/{name}-*.so"))
        if not theirs:
            continue
        a, b = sass(theirs[0]), sass(lib)
        for kernel in sorted(set(a) & set(b)):
            out[f"{name}:{kernel}"] = ("same" if a[kernel] == b[kernel] else
                                       f"{len(a[kernel])} -> "
                                       f"{len(b[kernel])} instructions")
    return out


def main(argv) -> int:
    if not argv or argv[0].startswith("-"):
        print(__doc__.splitlines()[0], file=sys.stderr)
        return 2
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {root}")
    _build.build(list(getattr(_build, "LIBRARIES", _build.SOURCES)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": argv[0]}
    if "--sweep" in argv:
        out["sweep_d256"] = sweep(torch, fa, gen)
    elif "--trace" in argv:
        out["trace"] = trace(torch, fa, gen)
    else:
        for label, shape, dtype in SHAPES:
            out[label] = {name: {"device_ms": device_ms(torch, fn),
                                 "host_us": host_us(torch, fn)}
                          for name, fn in inputs(torch, fa, gen, *shape,
                                                 dtype).items()}
            torch.cuda.empty_cache()
    if "--ptxas" in argv:
        import chip_smoke

        out["ptxas"] = {
            name: chip_smoke.ptxas_report(
                _build.library_path(name).with_suffix(".log").read_text())
            for name in _build.LIBRARIES}
    if "--bits-save" in argv:
        torch.save(bits_outputs(torch, fa),
                   argv[argv.index("--bits-save") + 1])
    elif "--bits-against" in argv:
        out["bits_against"] = bits_against(
            torch, bits_outputs(torch, fa),
            torch.load(argv[argv.index("--bits-against") + 1]))
    if "--sass-against" in argv:
        out["sass_against"] = sass_against(
            root, os.path.abspath(argv[argv.index("--sass-against") + 1]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Times the attention kernels of one tree of the port on one card:
``python3 chip_kernel_ab.py <root>``, where ``<root>`` holds a
``ray_tpu_torch`` package (``.`` for this checkout).

At ``chip_smoke.py``'s two timed shapes (the Llama-3-8B heads at a 2k
prefill, "table"; the Llama-3-1B training step's attention, "train"),
its head_dim-256 row ("d256", Gemma-2B's 8/1 heads at a 2k prefill), its
"d512 train" row (the wide-head 1B's training step, B 4 x 2048, 4/1
heads of head_dim 512: the slab kernels), all bf16, its "train f32"
row ("train" in float32: the forward, dQ and dK/dV each with its split
pass, the whole backward with one for both) and "d512 f32" ("d512
train" in float32: the slab kernels' float32 instantiations), all causal,
each kernel (forward, dQ, dK/dV) and the whole backward
(dQ with delta, then dK/dV: ``flash_attention_backward``) is timed with
CUDA events in turns with SDPA on the same inputs (kernel, SDPA, SDPA,
kernel): SDPA's forward beside the kernels, its backward (dq, dk, dv
together) beside the whole backward; SDPA as the dispatcher picks its
backend for GQA inputs (``MATH`` past head_dim 256 and in float32), and
on its memory-efficient backend, the fastest that takes the function
where the dispatcher picks ``MATH`` (K/V expanded to the q heads outside
the timed region; ``chip_smoke.efficient_sdpa``, which prints a line
with the backend's reason where it refuses). 50 calls a reading after 5 to warm
up, once the shape's kernels and SDPA have run untimed for SETTLE_S (the
first readings of a fresh process came out up to 45 % slow without
it). Prints one JSON line: the tree, its build seconds, and per shape
and kernel the mean of its two readings, both readings and SDPA's mean,
the memory-efficient backend's forward and backward, each kernel's bound
(``chip_smoke.bound`` of ``attention_work``: the least time the card
could take for its FLOPs or bytes), the plain versions' times at the
rows of PLAIN_TIMED, and the split the tree's head_dim-256 kernels take
there (null for a tree from before the split).

To compare two commits on one card, unpack the other commit's package
under a directory that ``.gitignore`` lists (``git archive <commit>
ray_tpu_torch | tar -x -C _checkout/parent``) and run both trees in one
call, in turns: parent, change, change, parent. Each run is a process
of its own, so each imports its own tree. Exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import sys
import time

# chip_smoke.py's TIMED_SHAPES and its DTYPE_TIMED rows: (B, T, Hq, Hkv,
# D), dtype
SHAPES = (("table", (1, 2048, 32, 8, 128), "bfloat16"),
          ("train", (4, 2048, 32, 8, 64), "bfloat16"),
          ("d256", (1, 2048, 8, 1, 256), "bfloat16"),
          ("d512 train", (4, 2048, 4, 1, 512), "bfloat16"),
          ("train f32", (4, 2048, 32, 8, 64), "float32"),
          ("d512 f32", (4, 2048, 4, 1, 512), "float32"))
# rows whose plain versions (forward, dQ, dK/dV, whole backward) are timed
# too, once each: rows no chip_smoke phase times
PLAIN_TIMED = ("d512 f32",)
ITERS, WARMUP = 50, 5
SETTLE_S = 2.0


def mean_ms(torch, fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def split_of(fa, B, T, Hq, Hkv, D):
    """The split the tree's kernels take at this causal bf16 shape on
    this card, or None for a tree without flash_schedule."""
    try:
        from ray_tpu_torch.ops import flash_schedule as fs
    except ImportError:
        return None
    import torch

    sms = fa.sm_count(torch.device("cuda"))
    return {"fwd_split_tiles": fs.forward_split_tiles(B, T, Hq, D, True,
                                                      sms),
            "dkv_chunks": fs.dkv_split(B, T, Hq, Hkv, D, True, sms)}


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__.splitlines()[0], file=sys.stderr)
        return 2
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    import chip_smoke

    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {root}")
    t0 = time.perf_counter()
    # a tree from before the per-dtype libraries names its sources only
    _build.build(list(getattr(_build, "LIBRARIES", _build.SOURCES)))
    out = {"tree": argv[0], "build_s": time.perf_counter() - t0}
    peaks = chip_smoke.peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (B, T, Hq, Hkv, D), dtype in SHAPES:
        q, k, v, do = (torch.randn(B, T, h, D, device="cuda", generator=gen)
                       .to(getattr(torch, dtype)) for h in (Hq, Hkv, Hkv, Hq))
        o, lse = fa.flash_attention_forward(q, k, v, True)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            with torch.no_grad():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

        def sdpa_backward():
            return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        plain = {
            "fwd": lambda: fa.flash_attention_reference(q, k, v, True),
            "dq": lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, o, do, lse, True),
            "dkv": lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, True),
            "bwd": lambda: fa.flash_attention_backward_reference(
                q, k, v, o, lse, do, True)}
        kernels = {
            "fwd": lambda: fa.flash_attention_forward(q, k, v, True),
            "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, o, do, lse,
                                                    True),
            "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, True),
            "bwd": lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                       True)}
        t_settle = time.perf_counter()
        while time.perf_counter() - t_settle < SETTLE_S:
            for fn in (*kernels.values(), sdpa, sdpa_backward):
                fn()
            torch.cuda.synchronize()
        out[label] = {
            "split": split_of(fa, B, T, Hq, Hkv, D), "dtype": dtype,
            "sdpa_backend": chip_smoke.sdpa_backend(torch, qt, kt, vt),
            "sdpa_efficient_forward": chip_smoke.efficient_sdpa(
                torch, qt, kt, vt),
            "sdpa_efficient_backward": chip_smoke.efficient_sdpa(
                torch, qt, kt, vt, dot)}
        for name, fn in kernels.items():
            yardstick = sdpa_backward if name == "bwd" else sdpa
            first, s1, s2, second = (mean_ms(torch, f)
                                     for f in (fn, yardstick, yardstick, fn))
            out[label][name] = {
                "ms": (first + second) / 2, "ms_each": [first, second],
                ("sdpa_backward_ms" if name == "bwd" else "sdpa_forward_ms"):
                    (s1 + s2) / 2,
                "bound_ms": chip_smoke.bound(*fa.attention_work(
                    B, T, Hq, Hkv, D, True, kernel=name,
                    elem_bytes=q.element_size()), peaks)["bound_ms"]}
            if label in PLAIN_TIMED:
                out[label][name]["plain_ms"] = chip_smoke.cuda_ms(
                    plain[name], iters=3, warmup=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Planted-fault check of ``chip_smoke.py``'s backward gates, on one card:
``python3 chip_planted_faults.py [fault ...]`` (named faults: those
alone, beside the sound kernels' readings of the same gates). It is run
by hand, after a change to the kernels or to the gates, and by nothing
else; ``chip_smoke.py`` does not call it.

Builds the backward kernels from patched copies of
``ray_tpu_torch/ops/csrc`` (written under the gitignored
``ray_tpu_torch/_build/planted/``; the sources stay as they are), each
with one planted fault in the dQ kernel, and reads the gates that must
catch it, beside the same readings of the sound kernels:

- ``skip_last_stage``: the dQ kernel leaves its last K/V stage out of dQ
  (it still waits for the stage and frees it);
- ``delta_wrong_half``: the dQ kernel writes each row's delta to the row
  eight away, the other half of its accumulator rows (its own dQ stays
  right; the dK/dV kernel reads the misplaced delta).

and two planted in ring attention (``parallel/ring_attention.py``),
with the sound kernels:

- ``ring_local_lse``: the ring's backward runs each K/V block on that
  block's own o and lse (recomputed by the forward kernel), not on the
  merged o and the global lse: the classic ring flash-attention fault;
- ``ring_unweighted_merge``: the ring's forward folds each block's o
  into the running o with equal weights (their mean), not by their lse;
  the merged lse stays right.

Both are read by ``chip_smoke``'s ``seq_ring`` gates (o and grad element
bounds, the block gate of o and of each grad, the merged lse, against
the whole-T kernels and the fp32 plain version) at the Llama-3-1B heads,
T 8192 over 4 positions.

More are planted in the widened variants and read by ``chip_smoke``'s
``kernel_dtypes`` gates of one variant (its element and block bounds over
its lengths, causal and full, GQA groups), beside the sound kernels'
readings of the same variants:

- ``f32_dp_rounded_once``: the fp32 backward kernels form dP from dO and
  V rounded to bf16 once (without the products of what the rounding
  left), read at ``float32:64``;
- ``d256_second_half``: the 256-column RS product (O += P V; dQ's dS K
  at 256 is two 128-column products, one a consumer) reads its second 128
  columns from the tile's second column block, not its third, read at
  ``bfloat16:256``;
- ``split_delta_rounded_do``: the fp32 split pass takes delta from dO
  rounded to bf16 (the dQ kernel's tile) instead of dO as it lies in
  device memory, read at ``float32:64``;
- ``fwd_split_k_from_q``: the fp32 forward's split pass writes k's copy
  from q's rows (of the same batch, time and head index), so the forward
  kernel reads a wrong K by TMA, read at ``float32:64``;
- ``dkv_dp_drops_do_rest``: the fp32 dK/dV kernel, on its TMA tiles,
  leaves the product of dO's rest (V_hi dO_lo^T) out of dP^T (dV = P^T
  dO reads dO's rounded tile only), read at ``float32:64``;

and three in the slab kernels that take head_dim past 256:

- ``wide_s_last_slice``: the forward's S = Q K^T past 512 columns
  restarts at each 64-column slice instead of summing them, so S holds
  the last slice's product alone, read at ``bfloat16:576``;
- ``pair_missing_partial``: the forward up to 512 columns leaves the
  other consumer's partial S out, so each slab's S is the product of
  its own 256 columns of Q and K alone, read at ``bfloat16:512``;
- ``wide_dq_k_first_slab``: the dQ kernel's dQ += dS K reads the first
  slab's columns of K whatever slab the consumer owns, so every slab
  past the first gets the first slab's dQ, read at ``bfloat16:512``;

two in the head_dim-256 dQ kernel (``flash_bwd_dq256_kernel``), read at
``bfloat16:256``:

- ``dq256_k_other_half``: consumer 1's dQ += dS K reads consumer 0's half
  of K (its columns 0-127) for its own columns 128-255;
- ``dq256_ds_before_p``: consumer 1 forms dS from the exchange buffer
  before its named barrier on consumer 0's P (it meets the barrier
  after), so it reads the last key step's P, or, racing, part of this
  step's;

two in the slab backward kernels' exchanges, read at ``bfloat16:512``:

- ``wide_dq_stale_p``: the dQ kernel's consumer 1 reads the exchange
  buffer before its named barrier (it meets the barrier after), so it
  forms dS from what the buffer held before consumer 0's P of this key
  step arrived: the last key step's dS and P, or, racing, part of this
  step's P;
- ``cluster_own_partial``: each block of a dK/dV cluster sums its own
  partial S^T and dP^T in the place of every peer's, so S^T and dP^T
  are the cluster's size times the block's own;

and two in the second passes of the head_dim-256 split, read at
``bfloat16:256`` (whose cases take both splits on an H100):

- ``split_reduce_drops_last_chunk``: the dK/dV reduction adds every
  chunk's partial sums but the last;
- ``split_merge_part1_lse``: the forward's merge of a split tile's two
  halves weighs part 0 by part 1's lse as well as part 1, so both halves
  get equal weights.

Readings: the block gate (per (batch, 64-row block, head) rms(err) /
(rms(ref) + 1e-3) of dq, dk, dv against their plain versions, limit
``chip_smoke.GRAD_BLOCK_RTOL``) at the training shape, the 8B table shape
and a ragged shape; the delta gate; and ``chip_smoke``'s per-leaf train
gate (each wq, wk, wv grad of a 2-layer step at Llama-3-1B widths against
plain attention, limit ``chip_smoke.ATTN_GRAD_RTOL``). Prints one JSON
line per kernel build and, last, whether every fault was caught. Exits
non-zero without CUDA, or if a fault passes a gate that should catch it.
"""

from __future__ import annotations

import shutil
import sys

import chip_smoke as cs

FAULTS = {
    "skip_last_stage": (
        "    for (int j = 0; j < n_live; ++j) {\n",
        "    for (int j = 0; j < n_live - 1; ++j) {\n",
        "    for (int j = n_live; j < n_tiles; ++j) {\n",
        "    for (int j = max(n_live - 1, 0); j < n_tiles; ++j) {\n"),
    "delta_wrong_half": (
        "        if (tg == 0 && row < T) delta[((int64_t)b * Hq + h) * T + row] "
        "= sum;\n",
        "        if (tg == 0 && (row ^ 8) < T)\n"
        "          delta[((int64_t)b * Hq + h) * T + (row ^ 8)] = sum;\n"),
}

# faults in the widened variants: (file under csrc/, its edits (old, new,
# ...), the variant of chip_smoke.DTYPE_VARIANTS whose gates read it)
VARIANT_FAULTS = {
    "f32_dp_rounded_once": (
        "flash_attention_bwd.cu",
        ("      if constexpr (kLo) {\n"
         "        // fp32: dP += dO_lo V_hi^T + dO_hi V_lo^T (the tiles' "
         "rests)\n",
         "      if constexpr (false) {\n",
         "          if constexpr (kLo) {\n"
         "            // fp32: dP^T += V_hi dO_lo^T + V_lo dO_hi^T (the "
         "tiles' rests)\n",
         "          if constexpr (false) {\n"),
        ("float32", 64)),
    "fwd_split_k_from_q": (
        "flash_attention_fwd.cu",
        ("    const float *k_row = at(k, 1), *v_row = at(v, 2);\n",
         "    const float *k_row = at(q, 0), *v_row = at(v, 2);\n"),
        ("float32", 64)),
    "dkv_dp_drops_do_rest": (
        "flash_attention_bwd.cu",
        ("            sm90::wgmma_ss<64, Op>(\n"
         "                dpt, desc_sw128(v_addr + a_off, 16, 1024),\n"
         "                desc_sw128(do_addr + kTileBytes + b_off, 16, 1024), "
         "1);\n", ""),
        ("float32", 64)),
    "d256_second_half": (
        "flash_attention_sm90.cuh",
        ("desc_sw128(addr + 2 * half * lbo, lbo, 1024)",
         "desc_sw128(addr + half * lbo, lbo, 1024)"),
        ("bfloat16", 256)),
    "wide_s_last_slice": (
        "flash_attention_fwd.cu",
        ("cb > 0 || ks > 0);", "ks > 0);"),
        ("bfloat16", 576)),
    "pair_missing_partial": (
        "flash_attention_fwd.cu",
        ("        const float4 x = theirs[q * 128 + t];\n",
         "        const float4 x = make_float4(0.f, 0.f, 0.f, 0.f);\n"),
        ("bfloat16", 512)),
    "split_delta_rounded_do": (
        "flash_attention_bwd.cu",
        ("          if (8 * ch + e < d_true) sum += y[e] * x[e];\n",
         "          if (8 * ch + e < d_true)\n"
         "            sum += y[e] * __bfloat162float(__float2bfloat16(x[e]));"
         "\n"),
        ("float32", 64)),
    "wide_dq_k_first_slab": (
        "flash_attention_bwd.cu",
        ("k_addr + 4 * c * kTile + kk * 16 * 128,",
         "k_addr + kk * 16 * 128,"),
        ("bfloat16", 512)),
    "wide_dq_stale_p": (
        "flash_attention_bwd.cu",
        ("        named_barrier(kBarP, 256);  // P of this tile is in ex\n"
         "        // dS = P (dP - delta) scale, every P read before dS "
         "overwrites it\n"
         "#pragma unroll\n"
         "        for (int e = 0; e < 32; ++e) {\n"
         "          x[e] = ex[e * 128 + t] * (x[e] - rowv[(e >> 1) & 1]) * "
         "scale;\n"
         "        }\n",
         "#pragma unroll\n"
         "        for (int e = 0; e < 32; ++e) {\n"
         "          x[e] = ex[e * 128 + t] * (x[e] - rowv[(e >> 1) & 1]) * "
         "scale;\n"
         "        }\n"
         "        named_barrier(kBarP, 256);\n"),
        ("bfloat16", 512)),
    "dq256_k_other_half": (
        "flash_attention_bwd.cu",
        ("            acc, dsa[kk], k_addr + 2 * c * kColBytes + kk * 16 * 128,\n",
         "            acc, dsa[kk], k_addr + kk * 16 * 128,\n"),
        ("bfloat16", 256)),
    "dq256_ds_before_p": (
        "flash_attention_bwd.cu",
        ("        named_barrier(kBarP, 256);  // consumer 0's P of this tile\n",
         "",
         "        named_barrier_arrive(kBarDs, 256);\n"
         "      }\n"
         "      TRACE(1)\n",
         "        named_barrier(kBarP, 256);\n"
         "        named_barrier_arrive(kBarDs, 256);\n"
         "      }\n"
         "      TRACE(1)\n"),
        ("bfloat16", 256)),
    "cluster_own_partial": (
        "flash_attention_bwd.cu",
        ("          if (r != slab) v = from[q * 128];\n", ""),
        ("bfloat16", 512)),
    "split_reduce_drops_last_chunk": (
        "flash_attention_bwd.cu",
        ("    for (int c = 1; c < n_split; ++c) {\n",
         "    for (int c = 1; c < n_split - 1; ++c) {\n"),
        ("bfloat16", 256)),
    "split_merge_part1_lse": (
        "flash_attention_fwd.cu",
        ("  const float e0 = expf(l0 - mx);\n",
         "  const float e0 = expf(l1 - mx);\n"),
        ("bfloat16", 256)),
}

# (B, T, Hq, Hkv, D): the 1B training shape, the 8B table shape and a
# ragged one; all causal
SHAPES = ((4, 2048, 32, 8, 64), (1, 2048, 32, 8, 128), (2, 257, 8, 2, 128))


def gate_readings(torch, fa, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for B, T, Hq, Hkv, D in SHAPES:
        def r(h):
            return torch.randn(B, T, h, D, device="cuda", generator=gen,
                               dtype=torch.float32).to(torch.bfloat16)
        q, k, v, do = r(Hq), r(Hkv), r(Hkv), r(Hq)
        o, lse = fa.flash_attention_forward(q, k, v, True)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
        want = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     True)
        prod = o.float() * do.float()
        err = (delta - prod.sum(-1).transpose(1, 2)).abs()
        bound = cs.DELTA_RTOL * prod.abs().sum(-1).transpose(1, 2)
        out[f"{B}x{T}x{Hq}/{Hkv}x{D}"] = {
            **{name: cs.block_rel_err(torch, got, ref)
               for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                         want)},
            "delta_err_over_bound":
                (err / bound.clamp_min(1e-30)).max().item()}
    return out


def leaf_readings(torch, seed: int) -> dict:
    """chip_smoke's reduced-depth train phase, its line caught instead of
    printed (its own checks may raise: that is the reading)."""
    lines = []
    emit = cs.emit
    cs.emit = lines.append
    try:
        cs.phase_reduced_depth_train(torch, seed)
        caught = None
    except RuntimeError as e:
        caught = str(e)[:200]
    finally:
        cs.emit = emit
    line = lines[-1] if lines else {}
    leaves = line.get("attn_leaf_rel_diff", {})
    return {"worst_leaf": max(leaves, key=leaves.get) if leaves else None,
            "worst_leaf_rel_diff": max(leaves.values()) if leaves else None,
            "rel_diff": line.get("rel_diff"), "smoke_check": caught}


def variant_gate_readings(torch, seed: int, faults=VARIANT_FAULTS) -> dict:
    """chip_smoke's kernel_dtypes gates of the variants the variant faults
    ``faults`` are read at: each one's worst error over tolerance and
    failed cases."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for dtype, D in sorted({VARIANT_FAULTS[f][2] for f in faults}):
        r = cs.variant_readings(torch, gen, getattr(torch, dtype), D)
        out[f"{dtype}:{D}"] = {"worst": r["worst_err_over_tolerance"],
                               "failed_cases": len(r["failed"])}
    return out


def plant(root, name: str, sound_csrc, file: str, edits) -> "Path":
    """A copy of the kernel sources under ``root/name`` with ``edits``
    (old, new, ...) made in ``file``; its csrc directory."""
    csrc = root / name / "csrc"
    shutil.copytree(sound_csrc, csrc)
    src = csrc / file
    text = src.read_text()
    # the faults match exact lines of the kernels: an edit there needs the
    # anchors in FAULTS and VARIANT_FAULTS edited too
    for old, new in zip(edits[::2], edits[1::2]):
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the fault's anchor is not in "
                               f"{file} once: {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return csrc


def local_lse_backward_steps(q, k, v, o, lse, do, rank, size, causal):
    """``ring_attention._backward_steps`` with the planted fault: each
    visited block's dQ and dK/dV on the block's own o and lse."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import ring_attention as ra

    dq, dkb, dvb = (torch.zeros(x.shape, dtype=torch.float32,
                                device=x.device) for x in (q, k, v))
    kb, vb = k, v
    for i in range(size):
        c = ra._block_causal(rank, (rank - i) % size, causal)
        if c is not None:
            o_b, lse_b = fa.flash_attention_forward(q, kb, vb, c)
            dq_b, delta = fa.flash_attention_bwd_dq(q, kb, vb, o_b, do,
                                                    lse_b, c)
            dk_b, dv_b = fa.flash_attention_bwd_dkv(q, kb, vb, do, lse_b,
                                                    delta, c)
            dq += dq_b
            dkb += dk_b
            dvb += dv_b
        if i + 1 < size:
            kb, vb, dkb, dvb = yield kb, vb, dkb, dvb
        elif size > 1:
            dkb, dvb = yield dkb, dvb
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


def unweighted_merge(o, lse, o_b, lse_b):
    """``ring_attention._merge`` with the planted fault: the running o
    and the block's o averaged with equal weights, not by their lse; the
    merged lse is the right one."""
    import torch

    if o is None:
        return o_b.float(), lse_b
    return o.add_(o_b.float()).mul_(0.5), torch.logaddexp(lse, lse_b)


def ring_readings(torch) -> dict:
    """The seq_ring gates on the sound ring and on each planted ring
    fault; caught when a numeric gate (not only the launch count, which
    the planted recompute also changes) fails."""
    from unittest import mock

    from ray_tpu_torch.parallel import ring_attention as ra

    rings = {"sound_ring": ("_merge", ra._merge),
             "ring_local_lse": ("_backward_steps", local_lse_backward_steps),
             "ring_unweighted_merge": ("_merge", unweighted_merge)}
    out = {}
    for name, (attr, planted) in rings.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        with mock.patch.object(ra, attr, planted):
            readings = cs.seq_ring_readings(torch, gen,
                                            cs.SEQ_RING_CASES[:1])
        failed = [f for f in cs.seq_ring_failures(readings)
                  if "against" in f]
        out[name] = {"readings": readings, "numeric_gates_failed": failed}
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    unknown = [n for n in argv if n not in FAULTS and n not in VARIANT_FAULTS]
    if unknown:
        print(f"chip_planted_faults: no fault named {unknown}; the faults: "
              f"{[*FAULTS, *VARIANT_FAULTS]}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    print(cs.smi_line(), flush=True)
    sound_csrc, sound_build = _build.CSRC, _build.BUILD_DIR
    root = sound_build / "planted"
    shutil.rmtree(root, ignore_errors=True)
    caught = {}
    dq_faults = [n for n in FAULTS if not argv or n in argv]
    variant_faults = [n for n in VARIANT_FAULTS if not argv or n in argv]
    for name in ("sound", *dq_faults) if dq_faults else ():
        csrc = sound_csrc
        if name != "sound":
            csrc = plant(root, name, sound_csrc, "flash_attention_bwd.cu",
                         FAULTS[name])
        _build.CSRC = csrc
        _build.BUILD_DIR = sound_build if name == "sound" \
            else root / name / "build"
        _build._loaded.clear()
        gates = gate_readings(torch, fa, seed=0)
        leaves = leaf_readings(torch, seed=0)
        worst_block = max(max(g[n] for n in ("dq", "dk", "dv"))
                          for g in gates.values())
        result = {
            "kernels": name, "block_gate": gates,
            "worst_block_rel_err": worst_block,
            "block_gate_catches": worst_block > cs.GRAD_BLOCK_RTOL,
            "leaf_gate": leaves,
            "leaf_gate_catches": (leaves["worst_leaf_rel_diff"] or 0)
            > cs.ATTN_GRAD_RTOL,
            "limits": {"block": cs.GRAD_BLOCK_RTOL,
                       "leaf": cs.ATTN_GRAD_RTOL, "delta": cs.DELTA_RTOL}}
        cs.emit(result)
        if name != "sound":
            caught[name] = (result["block_gate_catches"]
                            and result["leaf_gate_catches"])
        else:
            caught["sound passes"] = not (result["block_gate_catches"]
                                          or result["leaf_gate_catches"])
        # back to the sound kernels: the libraries loaded from the
        # planted build go too
        _build.CSRC, _build.BUILD_DIR = sound_csrc, sound_build
        _build._loaded.clear()
        torch.cuda.empty_cache()
    for name in ("sound variants", *variant_faults) if variant_faults \
            else ():
        if name in VARIANT_FAULTS:
            file, edits, _ = VARIANT_FAULTS[name]
            _build.CSRC = plant(root, name, sound_csrc, file, edits)
            _build.BUILD_DIR = root / name / "build"
            _build._loaded.clear()
        readings = variant_gate_readings(torch, seed=0,
                                         faults=variant_faults)
        cs.emit({"kernels": name, "variant_gates": readings,
                 "limit": "err over tolerance at most 1, every case"})
        if name in VARIANT_FAULTS:
            variant = "{}:{}".format(*VARIANT_FAULTS[name][2])
            caught[name] = readings[variant]["failed_cases"] > 0
        else:
            caught["sound variants pass"] = not any(
                r["failed_cases"] for r in readings.values())
        _build.CSRC, _build.BUILD_DIR = sound_csrc, sound_build
        _build._loaded.clear()
        torch.cuda.empty_cache()
    if not argv:  # the ring's faults run with the whole set only
        ring = ring_readings(torch)
        for name, r in ring.items():
            cs.emit({"ring": name, **r})
        caught["sound ring passes"] = not ring["sound_ring"][
            "numeric_gates_failed"]
        for name in ("ring_local_lse", "ring_unweighted_merge"):
            caught[name] = bool(ring[name]["numeric_gates_failed"])
    cs.emit({"caught": caught, "ok": all(caught.values())})
    return 0 if all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

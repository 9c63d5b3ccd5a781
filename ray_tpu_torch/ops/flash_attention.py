"""Flash attention, forward and backward (port of
``ray_tpu/ops/flash_attention.py``).

Public layout [B, T, H, D], K/V passed unrepeated for GQA
(``Hq % Hkv == 0``). On CUDA tensors the hand-written Hopper kernels run,
or the call raises:

- ``csrc/flash_attention_fwd.cu`` replaces the TPU kernel ``_fwd_kernel``
  (wgmma fed by TMA, ``csrc/flash_attention_sm90.cuh``);
- ``csrc/flash_attention_bwd.cu`` replaces ``_dq_kernel`` (dQ, which
  also computes the row term ``delta = rowsum(o * do)`` that the JAX
  package takes in jnp) and ``_dkv_kernel`` (dK/dV, with the GQA
  group-sum inside the kernel), both wgmma fed by TMA.

On CPU tensors the plain versions (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_dq_reference`,
:func:`flash_attention_bwd_dkv_reference`) compute the same functions.
:class:`FlashAttention` is the ``torch.autograd.Function`` that ties the
two halves together, as the JAX package's ``custom_vjp`` does.

The kernels mask a ragged last tile themselves, so every T >= 1 runs on
them, where the JAX package falls back for T that does not block. A
query length other than the key length (Tq != Tk) is what the JAX
package's ``flash_attention`` sends to its plain ``_fallback`` on every
backend; :func:`flash_attention` does the same on every device
(:func:`plain_attention`), and the kernels themselves refuse it. They
take what the Pallas kernels take:

- bfloat16, float16 and float32 q/k/v (one dtype throughout); o and the
  grads come back in that dtype, lse and delta in float32. bf16 and fp16
  run the tensor cores in their own type; float32 inputs are rounded to
  bf16 and run the bf16 products, summed in float32
  (``csrc/flash_attention_sm90.cuh`` says why not TF32): up to head_dim
  256 a split pass writes bf16 copies once a call
  (:func:`flash_attention_fwd_split`, :func:`flash_attention_bwd_split`,
  one a forward and one a backward call, shared by dQ and dK/dV), which
  the kernels load by TMA; past 256 the slab kernels round each tile;
- any head_dim >= 1, as the JAX package's wrapper takes any. The kernels
  are built for 64, 128 and 256; a narrower head_dim is read through TMA
  maps of its true width, whose missing columns arrive as zeros: the
  counterpart of the JAX package's zero-padding of head_dim to 128
  lanes. Past 256 a consumer warpgroup owns a slab of 256 output
  columns. The forward up to 512 is a block of 64 q rows whose two
  consumers each sum a partial S over their own slab's columns and add
  the other's, so S is computed once (past 512 every slab's block sums S
  over 64-column slices itself); the backward's two consumers split S =
  Q K^T and dP = dO V^T by product, so each is computed once a block:
  dQ's blocks own two slabs;
  dK/dV's blocks of one kv tile form a thread-block cluster (up to four
  slabs, float32 two; past that each block sums S and dP itself) whose
  blocks sum partial S and dP over their own slab's columns and add the
  cluster's partials in rank order (:mod:`flash_schedule`). Where
  a row of head_dim elements is not a whole number of 16-byte units
  (TMA's rule for strides), the wrapper pads head_dim with zeros into a
  copy (:func:`pad_head_dim`) and slices the outputs back, as the JAX
  package pads. Zero columns add exact zeros to every product, the
  softmax scale is 1/sqrt(D) of the true head_dim, and only the true
  columns are used. Up to :data:`NARROW_WIDTH` columns the kernels take
  P and dS in two parts (the rounded value and what rounding left), and a
  float32 call passes its inputs as bf16 parts side by side
  (:func:`_parts`): one rounding of each operand is not averaged out
  over so few columns.

At head_dim 129–256, where a block fills an SM, a launch of few heads
that leaves the card under-filled is split (:mod:`flash_schedule`): the
dK/dV kernel cuts each kv tile's (q head, q stage) pairs into chunks
summed by a second pass in chunk order, the causal forward its longest q
tiles into two halves of their keys merged by lse in a second pass. The
partials are float32 in a workspace the wrapper allocates; the order of
each sum is fixed, so results stay bitwise repeatable. dQ at head_dim
129–256 runs on a kernel of its own (``flash_bwd_dq256_kernel``): a block
of 64 q rows whose two consumer warpgroups split S and dP between them
and each add dS K into their own 128 columns of dQ
(``flash_attention_bwd_dq.d256_launches`` counts its launches).

The kernels launch through ``ctypes``, where no dispatch mode sees them.
So each launch reports its exact work (:func:`attention_work`) to every
open :class:`KernelTally`; the program observatory opens one around a
program's first call. On CPU tensors nothing is reported: the plain
versions run, and a dispatch-level counter counts them as the ordinary
matmuls they are, over the full T x T even when causal. The same program
therefore counts other FLOPs on the CPU than on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, List, NamedTuple

import torch

from ray_tpu_torch.ops import flash_schedule

NEG_INF = -1e30
# the dtypes the CUDA kernels take, by their code in the C entry points
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _scores(q, k, causal):
    """Scaled, masked float32 scores [B, Hq, T, Tk] with k repeated to
    the q heads."""
    T, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        mask = torch.ones(T, Tk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def _repeat_kv(q, *kv):
    rep = q.shape[2] // kv[0].shape[2]
    return tuple(t.repeat_interleave(rep, dim=2) if rep > 1 else t
                 for t in kv)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True):
    """Exact attention with float32 scores: the forward kernel's plain
    version.

    q: [B, T, Hq, D]; k, v: [B, Tk, Hkv, D]. Returns ``(o, lse)``: o
    [B, T, Hq, D] in q's dtype, lse [B, Hq, T] float32 (the row
    logsumexp of the scaled, masked scores).
    """
    k, v = _repeat_kv(q, k, v)
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return o, lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(o * do)`` in float32, as [B, Hq, T] (contiguous,
    the layout of lse): the row term both backward kernels use, which
    the dQ kernel computes and the dK/dV kernel reads."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, causal):
    """P and dS [B, Hq, T, T] float32, with k repeated to the q heads."""
    k, v = _repeat_kv(q, k, v)
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    return p, ds, k


def flash_attention_bwd_dq_reference(q, k, v, o, do, lse,
                                     causal: bool = True):
    """``(dq, delta)``: dQ = dS K with P recomputed from lse, and the row
    term ``delta = rowsum(o * do)`` it uses: the dQ kernel's plain
    version. q, o, do: [B, T, Hq, D]; k, v: [B, T, Hkv, D]; lse: [B, Hq,
    T] float32. Returns dq in q's dtype and delta [B, Hq, T] float32."""
    delta = attention_delta(o, do)
    _, ds, k_rep = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k_rep.float()).to(q.dtype)
    return dq, delta


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                      causal: bool = True):
    """dV = P^T dO and dK = dS^T Q, summed over the q heads of each kv
    head: the dK/dV kernel's plain version. Returns ``(dk, dv)`` in k's
    and v's dtypes."""
    p, ds, _ = _probs_and_ds(q, k, v, do, lse, delta, causal)
    B, T, Hkv, D = k.shape
    rep = q.shape[2] // Hkv
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    # GQA group-sum: q heads [g*rep, (g+1)*rep) all attend kv head g
    dk = dk.reshape(B, T, Hkv, rep, D).sum(3)
    dv = dv.reshape(B, T, Hkv, rep, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


class SplitOperands(NamedTuple):
    """What the split pass makes of float32 backward inputs: bfloat16
    copies [B, T, H, W8] (W8 the head_dim rounded up to 8 columns, the
    rest zeros) of q, k, v and do rounded to nearest (``q``, ``k``,
    ``v``, ``do``), what that rounding left of v and do rounded in turn
    (``v_lo``, ``do_lo``), and ``delta = rowsum(o * do)`` [B, Hq, T]
    float32 (None where the pass was given no o: a dK/dV call, which is
    given delta)."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    v_lo: torch.Tensor
    do: torch.Tensor
    do_lo: torch.Tensor
    delta: torch.Tensor


def _split_width(D: int) -> int:
    return -(-D // 8) * 8


def _hi_lo(x: torch.Tensor):
    """float32 ``x`` rounded to bfloat16 (hi) and what that left, x - hi,
    rounded to bfloat16 in turn (lo), each padded with zero columns to a
    whole number of 16-byte rows: the split passes' copies."""
    W8 = _split_width(x.shape[3])
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return pad_head_dim(hi, W8), pad_head_dim(lo, W8)


def flash_attention_bwd_split_reference(q, k, v, o, do) -> SplitOperands:
    """The backward split pass's plain version: the hi copies of q and k,
    hi and lo of v and do (:func:`_hi_lo`), and delta in float32 (None
    without o). Inputs float32."""
    v_hi, v_lo = _hi_lo(v)
    do_hi, do_lo = _hi_lo(do)
    return SplitOperands(_hi_lo(q)[0], _hi_lo(k)[0], v_hi, v_lo, do_hi,
                         do_lo, None if o is None else attention_delta(o, do))


class ForwardCopies(NamedTuple):
    """What the forward's split pass makes of float32 inputs: bfloat16
    copies [B, T, H, W8] of q, k and v rounded to nearest, padded with
    zero columns as :class:`SplitOperands`' are."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor


def flash_attention_fwd_split_reference(q, k, v) -> ForwardCopies:
    """The forward split pass's plain version: hi = x rounded to
    bfloat16, padded with zero columns to a whole number of 16-byte rows
    (:func:`_hi_lo`'s hi). Inputs float32."""
    return ForwardCopies(*(_hi_lo(x)[0] for x in (q, k, v)))


def flash_attention_backward_reference(q, k, v, o, lse, do,
                                       causal: bool = True):
    """``(dq, dk, dv)`` of attention from the forward's ``o`` and ``lse``
    and the output gradient ``do``, in float32 with the formulas of the
    JAX package's ``_bwd``: the function the backward kernels compute
    (not autograd through the forward)."""
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, o, do, lse,
                                                 causal)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal)
    return dq, dk, dv


def _vector_loadable(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t``: TMA's rule for a tensor map
    (unit head_dim stride, other strides a multiple of 16 bytes, a
    16-byte aligned base), which also covers the 16-byte loads of the
    float32 producers and of the dQ kernel's o."""
    size = t.element_size()
    return t.stride(3) == 1 \
        and not any(s * size % 16 for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _check_vector_loads(name: str, t: torch.Tensor) -> None:
    if not _vector_loadable(t):
        raise ValueError(
            f"{name} must have a unit head_dim stride, other strides a "
            f"multiple of 16 bytes and a 16-byte aligned start; got "
            f"strides {t.stride()} of {t.element_size()}-byte elements")


def kernel_width(D: int, dtype: torch.dtype) -> int:
    """The head_dim the kernels read for a true head_dim ``D``: D itself
    where a row of D elements is a whole number of 16-byte units (TMA's
    rule for strides), else D rounded up to one (8 elements of 2 bytes,
    4 of 4), zero-padded by :func:`pad_head_dim`."""
    per = 16 // dtype.itemsize
    return -(-D // per) * per


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` [B, T, H, D] with head_dim zero-padded to ``width``: a fresh
    contiguous copy, or ``t`` itself where D is already ``width``. Zero
    columns add exact zeros to every product of the kernels."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


# Narrow head_dims: up to this many columns (the kernels' width) the
# kernels take their A operands (P, dS) in two parts, the bf16 or fp16
# value and what rounding it left (csrc/flash_attention_sm90.cuh,
# kNarrowWidth), and a float32 call passes each input as its bf16 parts
# side by side (:func:`_parts`): there a row of Q K^T sums too few
# products to average one rounding of each operand out (bf16 head_dim 1
# and float32 3 missed the 64-row block gates on the card).
NARROW_WIDTH = 16


def _takes_parts(dtype: torch.dtype, width: int) -> bool:
    """Whether a float32 call at kernel width ``width`` passes its inputs
    to the kernels as parts (:func:`_parts`)."""
    return dtype == torch.float32 and width <= NARROW_WIDTH


def _parts(x: torch.Tensor, lo_at: int) -> torch.Tensor:
    """float32 ``x`` [..., W] as four blocks of W columns holding values
    bf16 keeps exactly, its rounding to bf16 (hi) and what that left (lo,
    rounded in turn): 1, q and do, hi | lo | hi | lo; 2, k and v, hi | hi
    | lo | lo (lo first at block ``lo_at``). A product over the head_dim
    of a 1 operand and a 2 one sums hi hi + lo hi + hi lo + lo lo, (hi +
    lo)(hi + lo): the float32 product within about 2^-16, where the
    kernels' one rounding of each operand leaves 2^-9 (and dP - delta,
    which is 0 where a row has one key, stays at float32's rounding)."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return torch.cat((hi, lo, hi, lo) if lo_at == 1 else (hi, hi, lo, lo),
                     -1)


def _join(y: torch.Tensor, width: int, lo_at: int) -> torch.Tensor:
    """An output [..., 4 W] of a product whose columns ran over
    :func:`_parts` blocks: block 0 plus block ``lo_at`` (the hi and the lo
    part of the operand that was split into them)."""
    return y[..., :width] + y[..., lo_at * width:(lo_at + 1) * width]


def _widths(D: int, dtype: torch.dtype):
    """``(W, Wk, parts)`` for a true head_dim ``D``: the padded width
    :func:`kernel_width`, the width the kernels read (four blocks of W
    where a narrow float32 call passes :func:`_parts`) and whether it
    does."""
    W = kernel_width(D, dtype)
    parts = _takes_parts(dtype, W)
    return W, 4 * W if parts else W, parts


def _reads_copies(dtype: torch.dtype, width: int) -> bool:
    """Whether the kernels read a call's inputs, of kernel width
    ``width``, as a split pass's bf16 copies: float32 up to head_dim 256
    (past it the slab kernels round their own tiles)."""
    return dtype == torch.float32 and width <= flash_schedule.WIDE_SLAB


def _backward_operands(q, k, v, o, do):
    """``(q, k, v, o, do)`` as the backward kernels read them: head_dim
    zero-padded to :func:`kernel_width` and, for a narrow float32 call,
    as :func:`_parts` (q and do hi | lo | hi | lo, k and v hi | hi | lo
    | lo; o, if given, beside do's first hi and lo blocks, so that delta
    = rowsum(o (do_hi + do_lo)))."""
    W, _, parts = _widths(q.shape[3], q.dtype)
    q, k, v, do = (pad_head_dim(t, W) for t in (q, k, v, do))
    if o is not None:
        o = pad_head_dim(o, W)
    if parts:
        q, k, v, do = _parts(q, 1), _parts(k, 2), _parts(v, 2), _parts(do, 1)
        if o is not None:
            zero = torch.zeros_like(o)
            o = torch.cat((o, o, zero, zero), -1)
    return q, k, v, o, do


def _check_split(split: SplitOperands, B: int, T: int, Hq: int, Hkv: int,
                 width: int) -> None:
    """Raise unless ``split`` holds the copies a split pass writes for
    inputs [B, T, Hq | Hkv, width]."""
    W8 = _split_width(width)
    want = ((B, T, Hq, W8), (B, T, Hkv, W8), (B, T, Hkv, W8),
            (B, T, Hkv, W8), (B, T, Hq, W8), (B, T, Hq, W8))
    got = tuple(tuple(t.shape) for t in split[:6])
    if got != want or any(t.dtype != torch.bfloat16 for t in split[:6]):
        raise ValueError(f"split operands of shapes {got} (want {want}, "
                         f"bfloat16) do not belong to this call")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise on anything the CUDA kernels do not take, before a launch."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention wants q [B,T,Hq,D] and k, v [B,T,Hkv,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "differ in batch or head_dim")
    if k.shape[1] != T:
        raise ValueError(
            f"the flash-attention kernel takes Tq == Tk (self-attention "
            f"over the prompt); got Tq={T}, Tk={k.shape[1]}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if D < 1:
        raise ValueError(f"the flash-attention kernels take head_dim >= 1; "
                         f"got {D}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the flash-attention kernels take "
                        f"{', '.join(map(str, KERNEL_DTYPES))}; q is "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}: the "
                            f"flash-attention kernels take one dtype")
    if kernel_width(D, q.dtype) == D:  # else read through a padded copy
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_vector_loads(name, t)
    # a kernel's output has no grad_fn: a wrapper called on inputs that
    # need grad would drop their gradient without a word
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel wrappers are not differentiable: "
            "call flash_attention (FlashAttention.apply) on inputs that "
            "need grad")


def check_backward_inputs(q, k, v, do, lse, delta=None, o=None) -> None:
    """:func:`check_kernel_inputs` plus the backward kernels' own rules
    for the output gradient, the row terms given (the dQ kernel reads
    lse, the dK/dV kernel lse and delta) and the forward's output ``o``
    (which the dQ kernel reads)."""
    check_kernel_inputs(q, k, v)
    for name, t in (("do", do), ("o", o)):
        if t is None:
            continue
        if t.shape != q.shape or t.dtype != q.dtype:
            raise TypeError(f"{name} must be of q's dtype {q.dtype} and "
                            f"shape {tuple(q.shape)}; got {t.dtype} "
                            f"{tuple(t.shape)}")
        if kernel_width(q.shape[3], q.dtype) == q.shape[3]:
            _check_vector_loads(name, t)
    B, T, Hq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if t.shape != (B, Hq, T) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[B, Hq, T] = {(B, Hq, T)}; got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")


def attention_work(B, T, Hq, Hkv, D, causal, kernel="fwd", elem_bytes=2):
    """(flops, bytes) a kernel needs, counting each unmasked (query, key)
    pair: the forward does 2 products (S, P V), 4*D flops a pair, reads
    q, k, v and writes o and lse; dQ does 3 (S, dP, dS K), 6*D flops,
    reads q, k, v, o, do, lse and writes dq and delta; dK/dV does 4 (S^T,
    dP^T, P^T dO, dS^T Q), 8*D flops, reads q, k, v, do, lse, delta and
    writes dk, dv; the whole backward ("bwd"), the function SDPA's
    backward computes, needs 5 (S, dP, P^T dO, dS^T Q, dS K), 10*D flops,
    reads q, k, v, o, do, lse and writes dq, dk, dv: the S and dP that
    the dQ and dK/dV kernels both compute are counted once. Tensors of
    ``elem_bytes`` a value (2 for bf16 and fp16, 4 for fp32), fp32 row
    terms; each read once, each written once, at the true head_dim D.
    The products run on the bf16 or fp16 tensor cores for every dtype."""
    pairs = T * (T + 1) // 2 if causal else T * T
    products, q_sized, kv_sized, rows = {
        "fwd": (2, 2, 2, 1), "dq": (3, 4, 2, 2), "dkv": (4, 2, 4, 2),
        "bwd": (5, 4, 4, 1)}[kernel]
    flops = 2 * products * D * pairs * B * Hq
    nbytes = elem_bytes * B * T * D * (q_sized * Hq + kv_sized * Hkv) \
        + 4 * rows * B * Hq * T
    return flops, nbytes


# Open tallies. Process-wide under a lock, not thread-local: the backward
# kernels launch on autograd's device thread, not the caller's.
_open_tallies: List["KernelTally"] = []
_tally_lock = threading.Lock()


class KernelTally:
    """The attention kernels' launches, FLOPs and bytes reported while
    it is open (a context manager), from any thread: ``counts`` is
    ``{kernel: {"launches", "flops", "bytes"}}`` with kernel ``"fwd"``,
    ``"dq"`` or ``"dkv"``. Tallies nest; a launch counts in each one
    open."""

    def __init__(self):
        self.counts: Dict[str, Dict[str, int]] = {}

    def __enter__(self) -> "KernelTally":
        with _tally_lock:
            _open_tallies.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _tally_lock:
            _open_tallies.remove(self)

    def total(self, key: str) -> int:
        """``key`` (``"flops"``, ``"bytes"`` or ``"launches"``) summed
        over the kernels."""
        return sum(c[key] for c in self.counts.values())


def report_kernel_work(kernel: str, B, T, Hq, Hkv, D, causal,
                       elem_bytes=2) -> None:
    """Add one launch of ``kernel`` at these shapes (tensors of
    ``elem_bytes`` a value) to every open :class:`KernelTally`; with none
    open this is one read of a list."""
    if not _open_tallies:
        return
    flops, nbytes = attention_work(B, T, Hq, Hkv, D, causal, kernel,
                                   elem_bytes)
    with _tally_lock:
        for tally in _open_tallies:
            c = tally.counts.setdefault(
                kernel, {"launches": 0, "flops": 0, "bytes": 0})
            c["launches"] += 1
            c["flops"] += flops
            c["bytes"] += nbytes


def _same_device(*ts) -> torch.device:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"flash-attention inputs on different devices: "
                         f"{devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention path for device {dev}")
    return dev


def _launch(kernel: str, entry: str, device, pointers, ints, strided,
            causal: bool, code=None) -> None:
    """Call C entry point ``entry`` of ``kernel``'s library for the dtype
    of the first pointer, or of type code ``code`` (built at first use)
    on the current stream: the
    tensors' data pointers (None: a null pointer), the int arguments (the
    last the dtype's code), the (batch, time, head) strides of
    ``strided``, causal and the stream. Raise if the launch was refused
    (each library names a cudaError_t with its own
    ``flash_attention_error_string``)."""
    from ray_tpu_torch.ops._build import library_name, load

    if code is None:
        code = KERNEL_DTYPES[pointers[0].dtype]
    lib = load(library_name(kernel, code))
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * len(pointers)
                   + [ctypes.c_int] * len(ints)
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * (3 * len(strided)))(
        *(s for t in strided for s in t.stride()[:3]))
    with torch.cuda.device(device):
        err = fn(*(None if t is None else t.data_ptr() for t in pointers),
                 *ints, strides, int(causal),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        what = lib.flash_attention_error_string
        what.argtypes, what.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{entry} launch failed: {what(err).decode()}")


def sm_count(device: torch.device) -> int:
    """The SMs of CUDA device ``device``: what the head_dim-256 kernels
    split their launches by (:mod:`flash_schedule`)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True):
    """``(o, lse)`` of flash attention; see :func:`flash_attention_reference`
    for shapes. CUDA tensors go through the kernel (float32 up to head_dim
    256 on the bf16 copies of :func:`flash_attention_fwd_split`), CPU
    tensors through the plain version. At head_dim 129–256 a causal
    launch that leaves the card under-filled splits its longest q tiles in
    two over their keys (:func:`flash_schedule.forward_split_tiles`): the
    halves' float32 o and lse go to a workspace that the kernel's second
    pass merges."""
    if _same_device(q, k, v).type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    check_kernel_inputs(q, k, v)
    B, T, Hq, D = q.shape
    W = kernel_width(D, q.dtype)
    q, k, v = (pad_head_dim(t, W) for t in (q, k, v))
    parts = _takes_parts(q.dtype, W)
    if parts:  # O = P V runs over v's parts: o is block 0 plus block 2
        q, k, v = _parts(q, 1), _parts(k, 2), _parts(v, 2)
    Wk = q.shape[3]  # the width the kernel reads
    o = torch.empty((B, T, Hq, Wk), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    n_split = flash_schedule.forward_split_tiles(B, T, Hq, Wk, causal,
                                                 sm_count(q.device))
    part = None
    if n_split:
        # the halves' fp32 o rows, then their lse
        rows = 2 * B * Hq * n_split * flash_schedule.FWD_Q_ROWS
        part = torch.empty(rows * (flash_schedule.PARTIAL_WIDTH + 1),
                           dtype=torch.float32, device=q.device)
    ints = (B, T, Hq, k.shape[2], Wk, D, n_split, KERNEL_DTYPES[q.dtype])
    if _reads_copies(q.dtype, Wk):
        # the split pass's bf16 copies, then the kernel on them by TMA
        copies = flash_attention_fwd_split(q, k, v)
        _launch("flash_attention_fwd", "flash_attention_fwd_from_split",
                q.device, (*copies, o, lse, part), ints, (o,), causal,
                code=KERNEL_DTYPES[q.dtype])
    else:
        _launch("flash_attention_fwd", "flash_attention_fwd", q.device,
                (q, k, v, o, lse, part), ints, (q, k, v, o), causal)
    flash_attention_forward.launches += 1
    flash_attention_forward.split_launches += bool(n_split)
    report_kernel_work("fwd", B, T, Hq, k.shape[2], D, causal,
                       q.element_size())
    if parts:
        o = _join(o, W, 2)
    return (o if W == D else o[..., :D]), lse


flash_attention_forward.launches = 0  # kernel launches, for run reports
flash_attention_forward.split_launches = 0  # of them split over keys


def flash_attention_fwd_split(q, k, v) -> ForwardCopies:
    """The forward split pass of float32 inputs (:class:`ForwardCopies`;
    plain version :func:`flash_attention_fwd_split_reference`): on CUDA
    tensors one kernel reads q, k and v once and writes their bfloat16
    copies, which the forward kernel then loads by TMA (the rounding its
    producer threads did once a tile, done once a call); CPU tensors go
    through the plain version. q [B, T, Hq, D], k and v [B, T, Hkv, D],
    all float32."""
    if _same_device(q, k, v).type == "cpu":
        return flash_attention_fwd_split_reference(q, k, v)
    check_kernel_inputs(q, k, v)
    if q.dtype != torch.float32:
        raise TypeError(f"the split pass takes float32 inputs; got {q.dtype}")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    W = kernel_width(D, q.dtype)
    q, k, v = (pad_head_dim(t, W) for t in (q, k, v))
    W8 = _split_width(W)
    out = ForwardCopies(*(torch.empty((B, T, H, W8), dtype=torch.bfloat16,
                                      device=q.device)
                          for H in (Hq, Hkv, Hkv)))
    _launch("flash_attention_fwd", "flash_attention_fwd_split", q.device,
            (q, k, v, *out), (B, T, Hq, Hkv, W, KERNEL_DTYPES[q.dtype]),
            (q, k, v), False)
    flash_attention_fwd_split.launches += 1
    return out


flash_attention_fwd_split.launches = 0


def flash_attention_bwd_dq(q, k, v, o, do, lse, causal: bool = True,
                           split: SplitOperands = None):
    """``(dq, delta)`` of flash attention (see
    :func:`flash_attention_bwd_dq_reference`). CUDA tensors go through the
    dQ kernel, which computes delta too (float32 up to head_dim 256: the
    split pass, :func:`flash_attention_bwd_split`, computes delta and the
    bf16 copies the dQ kernel reads; ``split``, that pass's output for
    these inputs, saves running it again), CPU tensors through the plain
    version."""
    if _same_device(q, k, v, o, do, lse).type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, o, do, lse, causal)
    check_backward_inputs(q, k, v, do, lse, o=o)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    W, Wk, parts = _widths(D, q.dtype)  # Wk: the width the kernels read
    dq = torch.empty((B, T, Hq, Wk), dtype=q.dtype, device=q.device)
    if _reads_copies(q.dtype, Wk):
        # the split pass's bf16 copies and delta, then dQ on them by TMA
        if split is None:
            split = flash_attention_bwd_split(
                *_backward_operands(q, k, v, o, do))
        _check_split(split, B, T, Hq, Hkv, Wk)
        if split.delta is None:
            raise ValueError("dQ reads delta from its split pass: this "
                             "split was made without o")
        delta = split.delta
        _launch("flash_attention_bwd", "flash_attention_bwd_dq_split",
                q.device, (split.q, split.k, split.v, split.v_lo, split.do,
                           split.do_lo, lse, delta, dq),
                (B, T, Hq, Hkv, Wk, D, KERNEL_DTYPES[q.dtype]),
                (dq,), causal, code=KERNEL_DTYPES[q.dtype])
    else:
        q, k, v, o, do = _backward_operands(q, k, v, o, do)
        delta = torch.empty((B, Hq, T), dtype=torch.float32,
                            device=q.device)
        _launch("flash_attention_bwd", "flash_attention_bwd_dq", q.device,
                (q, k, v, o, do, lse, delta, dq),
                (B, T, Hq, Hkv, Wk, D, KERNEL_DTYPES[q.dtype]),
                (q, k, v, o, do, dq), causal)
    if parts:  # dQ = dS K ran over k's parts
        dq = _join(dq, W, 2)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.d256_launches += (
        flash_schedule.dq_kernel(Wk) == "flash_bwd_dq256_kernel")
    report_kernel_work("dq", B, T, Hq, Hkv, D, causal, q.element_size())
    return (dq if W == D else dq[..., :D]), delta


flash_attention_bwd_dq.launches = 0
# of them on the head_dim-256 kernel (head_dim 129-256)
flash_attention_bwd_dq.d256_launches = 0


def flash_attention_bwd_split(q, k, v, o, do) -> SplitOperands:
    """The split pass of float32 backward inputs
    (:class:`SplitOperands`; plain version
    :func:`flash_attention_bwd_split_reference`): on CUDA tensors one
    kernel reads q, k, v, o and do once and writes the bfloat16 copies
    and delta, which the dQ and dK/dV kernels then load by TMA (the
    rounding the producer threads did once a tile, done once a call);
    given no o (None), the copies alone, for a dK/dV call, which is given
    delta. CPU tensors go through the plain version. q and o [B, T, Hq,
    D], k and v [B, T, Hkv, D], all float32."""
    if _same_device(*(t for t in (q, k, v, o, do)
                      if t is not None)).type == "cpu":
        return flash_attention_bwd_split_reference(q, k, v, o, do)
    check_backward_inputs(q, k, v, do, None, o=o)
    if q.dtype != torch.float32:
        raise TypeError(f"the split pass takes float32 inputs; got {q.dtype}")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    W = kernel_width(D, q.dtype)
    q, k, v, do = (pad_head_dim(t, W) for t in (q, k, v, do))
    if o is not None:
        o = pad_head_dim(o, W)
    W8 = _split_width(W)

    def copy(H):
        return torch.empty((B, T, H, W8), dtype=torch.bfloat16,
                           device=q.device)

    out = SplitOperands(copy(Hq), copy(Hkv), copy(Hkv), copy(Hkv), copy(Hq),
                        copy(Hq), None if o is None else torch.empty(
                            (B, Hq, T), dtype=torch.float32,
                            device=q.device))
    # without o its strides are not read: q's stand in
    _launch("flash_attention_bwd", "flash_attention_bwd_split", q.device,
            (q, k, v, o, do, *out), (B, T, Hq, Hkv, W, KERNEL_DTYPES[q.dtype]),
            (q, k, v, q if o is None else o, do), False)
    flash_attention_bwd_split.launches += 1
    return out


flash_attention_bwd_split.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            split: SplitOperands = None):
    """``(dk, dv)`` of flash attention (see
    :func:`flash_attention_bwd_dkv_reference`). CUDA tensors go through
    the dK/dV kernel (float32 up to head_dim 256 on the bf16 copies of the
    split pass, :func:`flash_attention_bwd_split`, run here without delta
    unless ``split`` gives that pass's output for these inputs), CPU
    tensors through the plain version. At head_dim 129–256 a launch that
    leaves the card under-filled cuts each kv tile's (q head, q stage)
    pairs into chunks (:func:`flash_schedule.dkv_split`), whose float32
    partial sums the kernel's second pass adds in chunk order."""
    if _same_device(q, k, v, do, lse, delta).type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal)
    check_backward_inputs(q, k, v, do, lse, delta)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    W, Wk, parts = _widths(D, q.dtype)  # Wk: the width the kernel reads
    dk = torch.empty((B, T, Hkv, Wk), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, T, Hkv, Wk), dtype=v.dtype, device=v.device)
    n_split = flash_schedule.dkv_split(B, T, Hq, Hkv, Wk, causal,
                                       sm_count(q.device))
    part = None
    if n_split > 1:
        part = torch.empty((2 * n_split * B * T * Hkv,
                            flash_schedule.PARTIAL_WIDTH),
                           dtype=torch.float32, device=q.device)
    ints = (B, T, Hq, Hkv, Wk, D, n_split, KERNEL_DTYPES[q.dtype])
    if _reads_copies(q.dtype, Wk):
        # the split pass's bf16 copies, then dK/dV on them by TMA
        if split is None:
            split = flash_attention_bwd_split(
                *_backward_operands(q, k, v, None, do))
        _check_split(split, B, T, Hq, Hkv, Wk)
        _launch("flash_attention_bwd", "flash_attention_bwd_dkv_split",
                q.device, (*split[:6], lse, delta, dk, dv, part), ints,
                (dk, dv), causal, code=KERNEL_DTYPES[q.dtype])
    else:
        q, k, v, _, do = _backward_operands(q, k, v, None, do)
        _launch("flash_attention_bwd", "flash_attention_bwd_dkv", q.device,
                (q, k, v, do, lse, delta, dk, dv, part), ints,
                (q, k, v, do, dk, dv), causal)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.split_launches += n_split > 1
    report_kernel_work("dkv", B, T, Hq, Hkv, D, causal, q.element_size())
    if parts:  # dK = dS^T Q, dV = P^T dO ran over q's and do's parts
        dk, dv = _join(dk, W, 1), _join(dv, W, 1)
    if W != D:
        dk, dv = dk[..., :D], dv[..., :D]
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.split_launches = 0  # of them split, with the sum


def kernel_readable(do: torch.Tensor) -> torch.Tensor:
    """An output gradient the backward kernels can read: ``do`` itself,
    or on CUDA a fresh aligned copy where autograd laid it out otherwise
    (a head_dim the kernels read padded is copied by the padding)."""
    if do.is_cuda and kernel_width(do.shape[3], do.dtype) == do.shape[3] \
            and not _vector_loadable(do):
        return do.clone(memory_format=torch.contiguous_format)
    return do


def flash_attention_backward(q, k, v, o, lse, do, causal: bool = True):
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse`` and the
    output gradient ``do``; see :func:`flash_attention_backward_reference`.
    CUDA tensors go through the dQ kernel (which also computes
    ``delta``) and then the dK/dV kernel, float32 up to head_dim 256 both
    on one split pass's copies and delta, CPU tensors through their plain
    versions."""
    device = _same_device(q, k, v, o, lse, do)
    do = kernel_readable(do)
    split = None
    if device.type == "cuda" and _reads_copies(
            q.dtype, _widths(q.shape[3], q.dtype)[1]):
        split = flash_attention_bwd_split(*_backward_operands(q, k, v, o, do))
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, causal, split)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, split)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel saves
    ``(q, k, v, o, lse)`` and the backward kernels take them, as the JAX
    package's ``_flash_fwd_rule`` / ``_flash_bwd_rule``. ``causal`` is
    not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              ctx.causal)
        return dq, dk, dv, None


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Exact attention on the tensors' own device, differentiable by
    autograd: k, v repeated to the q heads, float32 softmax, a top-left
    causal mask (row i sees keys 0 .. i) when q and k differ in length;
    o in q's dtype. The port of the JAX package's ``_fallback``
    (``ray_tpu/ops/flash_attention.py:333``, which calls
    ``ray_tpu/parallel/ring_attention.py:plain_attention``)."""
    return flash_attention_reference(q, k, v, causal)[0]


# JAX's _pick_block: the row blocks its kernels take, the smallest last
JAX_BLOCKS = (512, 256, 128, 64)


def sends_to_plain(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether :func:`flash_attention` sends q [B, Tq, Hq, D] and k [B,
    Tk, Hkv, D] to :func:`plain_attention`: where the JAX package's
    ``_supported`` (``ray_tpu/ops/flash_attention.py:46``, with
    ``_pick_block``) refuses them, so that it runs its exact
    ``_fallback``, and the port's kernels would not compute the same
    numbers. Tq != Tk on every dtype (the kernels take Tq == Tk only); a T
    that no block of ``JAX_BLOCKS`` divides for float32, whose kernels run
    bf16 operands where the fallback is exact (the JAX suite holds that
    case at 1e-5). bfloat16 and float16 run the kernels at every T; the
    kernel wrappers themselves take every T."""
    T = q.shape[1]
    if T != k.shape[1]:
        return True
    return q.dtype == torch.float32 and not any(T % b == 0
                                                for b in JAX_BLOCKS)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Blockwise (flash) attention, GQA-aware: pass k/v unrepeated.

    q: [B, Tq, Hq, D]; k, v: [B, Tk, Hkv, D] with Hq % Hkv == 0. Returns
    [B, Tq, Hq, D] in q's dtype. Differentiable through
    :class:`FlashAttention` when grad is on and an input needs it;
    otherwise (serving, ``inference_mode``) the forward alone runs.

    What :func:`sends_to_plain` names returns :func:`plain_attention` on
    every device (counted in ``flash_attention.plain_calls``), as the JAX
    package's ``flash_attention`` sends such shapes to its ``_fallback``.
    The check is on shapes and the dtype, made before any launch.
    """
    if sends_to_plain(q, k):
        flash_attention.plain_calls += 1
        return plain_attention(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_forward(q, k, v, causal)[0]


flash_attention.plain_calls = 0  # calls sent to plain_attention

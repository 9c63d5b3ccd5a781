"""Port parity: ray_tpu_torch.ops.flash_attention against the JAX package.

The plain versions (what the port runs on CPU tensors, and what the CUDA
kernels are held against on the card) are compared with JAX's
``flash_attention`` run through the Pallas kernels in interpret mode, as
tests/test_flash_attention.py runs it, and the backward also with the
exact gradients of JAX's ``plain_attention``. The CUDA kernels themselves
are checked on the card by chip_smoke.py and tests/test_torch_cuda.py.

Tolerances:
- forward, float32 atol = rtol = 1e-4 on o and lse. Both sides compute
  exact float32 attention; the Pallas kernel's online softmax sums blocks
  in another order than one softmax over the row, a few float32 ulps.
  The JAX suite's own bound for the kernel is 2e-2.
- backward against the Pallas grads: atol = rtol = 5e-2, the JAX suite's
  grad bound for its kernels (tests/test_flash_attention.py).
- backward against exact JAX grads: float32 atol = rtol = 1e-4 (the same
  float32 formulas, summed in another order).
- the autograd.Function on the CPU against torch autograd through the
  plain forward: 1e-5 (two float32 routes to the same gradient).
- the dQ plain version's ``delta`` against ``jnp.sum(o * do, -1)``:
  |err| <= 1e-5 * rowsum(|o * do|), the float32 bound of one row sum
  taken in another order (a bound relative to delta itself fails where
  the row sum cancels).
- the head_dims and dtypes the kernels took on in the widening (head_dim
  256, 72, and past 256 320, 384, 512; float16, bfloat16) against JAX's
  ``flash_attention`` through the Pallas kernels in interpret mode: the
  JAX suite's own bounds, atol = rtol = 2e-2 forward and 5e-2 grads, in
  every dtype alike (16-bit inputs, both sides computing in float32 and
  rounding o and the grads to the input dtype once, well inside them).
- head_dim padding (the wrapper's copy of an unaligned head_dim): the
  padded plain version against the unpadded one, 1e-5 (the same float32
  arithmetic with exact zero columns added).
- a head_dim-256 and a head_dim-512 debug-width Llama step, float32,
  against the JAX model: loss and global grad norm rtol 3e-3,
  chip_smoke's train-step bound (TRAIN_RTOL).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops.flash_attention import _bwd, _fwd
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu.parallel.ring_attention import plain_attention
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=1e-4, rtol=1e-4)
PALLAS_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)

CASES = [
    # (B, T, Hq, Hkv, D, causal): the JAX suite's CASES
    # (tests/test_flash_attention.py), a GQA case with rep 4 at D=128, and
    # a ragged T=100 (JAX takes its exact path there)
    (1, 128, 2, 1, 64, True),
    (1, 128, 2, 2, 128, False),
    (1, 128, 8, 2, 128, True),
    (1, 100, 2, 2, 32, True),
]


def _inputs(B, T, Hq, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, Hq, D).astype(np.float32),
            rng.randn(B, T, Hkv, D).astype(np.float32),
            rng.randn(B, T, Hkv, D).astype(np.float32))


def _torch(*xs):
    # bfloat16 arrays (ml_dtypes', as JAX makes them) go through float32,
    # which holds each of their values exactly
    return tuple(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
                 if x.dtype == jnp.bfloat16 else torch.from_numpy(x)
                 for x in xs)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", CASES)
def test_reference_output_matches_pallas(B, T, Hq, Hkv, D, causal):
    q, k, v = _inputs(B, T, Hq, Hkv, D)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, interpret=True)
    o, lse = fa.flash_attention_reference(*_torch(q, k, v), causal)
    assert o.shape == (B, T, Hq, D) and lse.shape == (B, Hq, T)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal",
                         [c for c in CASES if c[1] % 64 == 0])
def test_reference_lse_matches_pallas(B, T, Hq, Hkv, D, causal):
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed=1)
    # _fwd takes [B, H, T, D] and block-aligned T
    o_j, lse_j = _fwd(*(jnp.swapaxes(jnp.asarray(x), 1, 2)
                        for x in (q, k, v)),
                      causal=causal, blk=64, interpret=True)
    o, lse = fa.flash_attention_reference(*_torch(q, k, v), causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0], **TOL)
    np.testing.assert_allclose(o.numpy(),
                               np.swapaxes(np.asarray(o_j), 1, 2), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_the_plain_version(dtype):
    q, k, v = (t.to(dtype) for t in _torch(*_inputs(1, 40, 4, 2, 16)))
    before = fa.flash_attention_forward.launches
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention_forward.launches == before  # no kernel
    assert out.dtype == dtype
    assert torch.equal(out, fa.flash_attention_reference(q, k, v, True)[0])


def _bf16(shape_q, shape_k):
    return (torch.zeros(shape_q, dtype=torch.bfloat16),
            torch.zeros(shape_k, dtype=torch.bfloat16),
            torch.zeros(shape_k, dtype=torch.bfloat16))


@pytest.mark.parametrize("shape_q,shape_k,dtype,exc", [
    ((1, 64, 4, 64), (1, 32, 2, 64), torch.bfloat16, ValueError),  # Tq!=Tk
    ((1, 64, 2, 0), (1, 64, 2, 0), torch.bfloat16, ValueError),  # D < 1
    ((1, 64, 2, 0), (1, 64, 2, 0), torch.float32, ValueError),  # D < 1
    ((1, 64, 3, 64), (1, 64, 2, 64), torch.bfloat16, ValueError),  # GQA
    ((1, 64, 4, 64), (1, 64, 2, 64), torch.float64, TypeError),
    ((1, 64, 4, 64), (1, 64, 2, 64), torch.int32, TypeError),
])
def test_kernel_guard_rejects_before_launch(shape_q, shape_k, dtype, exc):
    q, k, v = (t.to(dtype) for t in _bf16(shape_q, shape_k))
    with pytest.raises(exc):
        fa.check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("which,dtype", [
    ("k", torch.float32), ("v", torch.float16), ("k", torch.bfloat16)])
def test_kernel_guard_rejects_mixed_dtypes(which, dtype):
    """One dtype throughout: q's. A k or v in another raises before any
    launch (q is float16 where the other is bfloat16)."""
    q, k, v = _bf16((1, 64, 4, 64), (1, 64, 2, 64))
    if dtype == torch.bfloat16:
        q = q.half()
    inputs = {"q": q, "k": k, "v": v}
    inputs[which] = inputs[which].to(dtype)
    with pytest.raises(TypeError, match="one dtype"):
        fa.check_kernel_inputs(*inputs.values())


@pytest.mark.parametrize("D,dtype", [
    (256, torch.bfloat16),  # was refused as D > 128
    (72, torch.bfloat16),  # was refused as D % 16
    (64, torch.float32),  # was refused as not bfloat16
    (64, torch.float16),  # was refused as not bfloat16
    (256, torch.float32), (256, torch.float16), (200, torch.bfloat16),
    (1, torch.bfloat16), (100, torch.float16), (3, torch.float32),
    (264, torch.bfloat16),  # was refused as D > 256
    (264, torch.float32),  # was refused as D > 256
    (300, torch.bfloat16), (512, torch.bfloat16), (1024, torch.float32),
])
def test_kernel_guard_accepts(D, dtype):
    """bf16, fp16 and fp32 q/k/v of one dtype at any head_dim >= 1 (past
    256 on the slab kernels): a head_dim whose rows are not whole 16-byte
    units is read through a padded copy, so its strides are not held to
    TMA's rule."""
    q, k, v = (t.to(dtype) for t in _bf16((1, 64, 4, D), (1, 64, 2, D)))
    fa.check_kernel_inputs(q, k, v)
    fa.check_backward_inputs(q, k, v, torch.zeros_like(q),
                             torch.zeros(1, 4, 64), torch.zeros(1, 4, 64),
                             torch.zeros_like(q))


def test_kernel_guard_accepts_the_8b_prefill_shape():
    fa.check_kernel_inputs(*_bf16((1, 208, 32, 128), (1, 208, 8, 128)))


# Tq != Tk: JAX's flash_attention returns its _fallback (plain attention,
# top-left causal mask) on every backend, and so does the port's
# flash_attention, on every device; the kernels are never reached.
# Bounds: 1e-5 in float32 (the same float32 formulas; the port takes
# exp(s - logsumexp), JAX softmax), 2e-2 in bfloat16 (both round o to
# bf16 once); grads 5e-2, the JAX suite's grad bound.
TQ_TK_CASES = [(tq, tk, causal, rep, dtype)
               for tq, tk in ((48, 32), (32, 80))
               for causal in (True, False)
               for rep in (1, 4)
               for dtype in ("float32", "bfloat16")]


def _tq_tk_inputs(tq, tk, rep, dtype, seed):
    rng = np.random.RandomState(seed)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return tuple(rng.randn(2, t, h, 16).astype(np.float32).astype(jdtype)
                 for t, h in ((tq, 4), (tk, 4 // rep), (tk, 4 // rep),
                              (tq, 4)))


def _tq_tk_tol(dtype):
    return dict(atol=1e-5, rtol=1e-5) if dtype == "float32" \
        else dict(atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("tq,tk,causal,rep,dtype", TQ_TK_CASES)
def test_tq_ne_tk_returns_the_jax_fallback(tq, tk, causal, rep, dtype):
    q, k, v, _ = _tq_tk_inputs(tq, tk, rep, dtype, seed=30)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, interpret=True)
    launches = [f.launches for f in (fa.flash_attention_forward,
                                     fa.flash_attention_bwd_dq,
                                     fa.flash_attention_bwd_dkv)]
    plain = fa.flash_attention.plain_calls
    got = fa.flash_attention(*_torch(q, k, v), causal)
    assert fa.flash_attention.plain_calls == plain + 1
    assert [f.launches for f in (fa.flash_attention_forward,
                                 fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)] == launches
    assert got.shape == (2, tq, 4, 16) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_tq_tk_tol(dtype))


@pytest.mark.parametrize("tq,tk,causal,rep,dtype", TQ_TK_CASES)
def test_tq_ne_tk_grads_match_jax_vjp(tq, tk, causal, rep, dtype):
    q, k, v, do = _tq_tk_inputs(tq, tk, rep, dtype, seed=31)
    want = _jax_grads(lambda q, k, v: jax_flash(q, k, v, causal=causal,
                                                interpret=True), q, k, v, do)
    leaves = [x.requires_grad_(True) for x in _torch(q, k, v)]
    plain = fa.flash_attention.plain_calls
    fa.flash_attention(*leaves, causal).backward(_torch(do)[0])
    assert fa.flash_attention.plain_calls == plain + 1
    for x, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert x.grad.shape == w.shape, name
        np.testing.assert_allclose(x.grad.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **PALLAS_GRAD_TOL)


@pytest.mark.parametrize("D,dtype,width", [
    (64, torch.bfloat16, 64), (72, torch.bfloat16, 72),
    (100, torch.bfloat16, 104), (1, torch.float16, 8),
    (256, torch.float16, 256), (100, torch.float32, 100),
    (3, torch.float32, 4), (250, torch.float32, 252),
    (300, torch.bfloat16, 304), (514, torch.float32, 516)])
def test_kernel_width_is_whole_16_byte_rows(D, dtype, width):
    assert fa.kernel_width(D, dtype) == width
    t = torch.randn(2, 5, 3, D).to(dtype)
    padded = fa.pad_head_dim(t, width)
    assert padded.shape == (2, 5, 3, width) and padded.dtype == dtype
    if width == D:
        assert padded is t  # read in place
    else:
        assert padded.is_contiguous()
        assert torch.equal(padded[..., :D], t)
        assert not padded[..., D:].any()


@pytest.mark.parametrize("D,width", [(100, 104), (3, 8), (36, 40)])
def test_padded_head_dim_gives_the_unpadded_attention(D, width):
    """What the wrapper does for an unaligned head_dim, on the plain
    versions: zero columns up to ``width``, the softmax scale of the true
    head_dim (here by scaling q, as the JAX package does), outputs sliced
    back. o, dk and dv equal the unpadded ones; dq carries the scale
    factor of q; every padded column of every output is zero."""
    q, k, v, do = _torch(*_bwd_inputs(1, 40, 4, 2, D, seed=8))
    o, lse = fa.flash_attention_reference(q, k, v, True)
    grads = fa.flash_attention_backward_reference(q, k, v, o, lse, do, True)
    factor = (width / D) ** 0.5
    qp, kp, vp, dop = (fa.pad_head_dim(t, width) for t in (q, k, v, do))
    op, lsep = fa.flash_attention_reference(qp * factor, kp, vp, True)
    dqp, dkp, dvp = fa.flash_attention_backward_reference(
        qp * factor, kp, vp, op, lsep, dop, True)
    assert not op[..., D:].any() and not dkp[..., D:].any()
    assert not dvp[..., D:].any() and not dqp[..., D:].any()
    for got, want, name in ((op[..., :D], o, "o"), (lsep, lse, "lse"),
                            (dqp[..., :D] * factor, grads[0], "dq"),
                            (dkp[..., :D], grads[1], "dk"),
                            (dvp[..., :D], grads[2], "dv")):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                                   msg=name)


def test_kernel_guard_rejects_inputs_that_need_grad():
    """The kernel wrappers are not differentiable, so their guard refuses
    inputs that need grad under grad mode; ``flash_attention`` takes such
    inputs through the FlashAttention autograd.Function, whose forward
    runs without grad mode (and whose backward reaches the backward
    kernels on the card)."""
    q, k, v = _bf16((1, 64, 4, 64), (1, 64, 2, 64))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fa.check_kernel_inputs(q, k, v)
    with torch.inference_mode():  # the serving path: no grad wanted
        fa.check_kernel_inputs(q, k, v)
    with torch.no_grad():  # as inside FlashAttention.forward
        fa.check_kernel_inputs(q, k, v)
    out = fa.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert fa.flash_attention(q, k, v, causal=True).grad_fn is None


def test_kernel_guard_rejects_unaligned_strides():
    q, k, v = _bf16((1, 64, 4, 64), (1, 64, 2, 64))
    head_dim_strided = q.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match="stride"):
        fa.check_kernel_inputs(head_dim_strided, k, v)


# --------------------------------------------------------------------------- #
# Backward
# --------------------------------------------------------------------------- #

BWD_CASES = [
    # (B, T, Hq, Hkv, D, causal): the JAX suite's grad case, a full case
    # and a rep-4 GQA case
    (1, 128, 2, 1, 64, True),
    (1, 128, 2, 2, 128, False),
    (1, 128, 8, 2, 64, True),
]


def _bwd_inputs(B, T, Hq, Hkv, D, seed=3):
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed)
    do = np.random.RandomState(seed + 100).randn(B, T, Hq, D) \
        .astype(np.float32)
    return q, k, v, do


def _port_grads(q, k, v, do, causal):
    q, k, v, do = _torch(q, k, v, do)
    o, lse = fa.flash_attention_reference(q, k, v, causal)
    return fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal)


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", BWD_CASES)
def test_backward_reference_matches_pallas_grads(B, T, Hq, Hkv, D, causal):
    q, k, v, do = _bwd_inputs(B, T, Hq, Hkv, D)
    want = _jax_grads(lambda q, k, v: jax_flash(q, k, v, causal=causal,
                                                interpret=True), q, k, v, do)
    got = _port_grads(q, k, v, do, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=name, **PALLAS_GRAD_TOL)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", CASES + BWD_CASES[2:])
def test_backward_reference_matches_exact_jax_grads(B, T, Hq, Hkv, D,
                                                    causal):
    q, k, v, do = _bwd_inputs(B, T, Hq, Hkv, D, seed=4)
    rep = Hq // Hkv

    def exact(q, k, v):
        return plain_attention(q, jnp.repeat(k, rep, axis=2),
                               jnp.repeat(v, rep, axis=2), causal=causal)

    want = _jax_grads(exact, q, k, v, do)
    got = _port_grads(q, k, v, do, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    # P recomputed from lse is a distribution over the keys of each row
    qt, kt, vt, dot = _torch(q, k, v, do)
    o, lse = fa.flash_attention_reference(qt, kt, vt, causal)
    p, _, _ = fa._probs_and_ds(qt, kt, vt, dot, lse,
                               fa.attention_delta(o, dot), causal)
    torch.testing.assert_close(p.sum(-1), torch.ones_like(lse),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal",
                         BWD_CASES + [(2, 37, 4, 2, 16, True)])
def test_autograd_function_matches_autograd_through_the_plain_forward(
        B, T, Hq, Hkv, D, causal):
    q, k, v, do = _torch(*_bwd_inputs(B, T, Hq, Hkv, D, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=causal).backward(do)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_reference(*ref, causal)[0].backward(do)
    for a, b, name in zip(leaves, ref, ("dq", "dk", "dv")):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", BWD_CASES)
def test_plain_dq_matches_pallas_dq_and_delta(B, T, Hq, Hkv, D, causal):
    """The dQ kernel's plain version returns ``(dq, delta)``: dq against
    the dq of JAX's ``_bwd`` run through the Pallas kernels in interpret
    mode, from the same o and lse; delta against jnp's row sum."""
    q, k, v, do = _bwd_inputs(B, T, Hq, Hkv, D, seed=6)
    bhtd = [jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, do)]
    o_j, lse_j = _fwd(*bhtd[:3], causal=causal, blk=64, interpret=True)
    dq_j, _, _ = _bwd(*bhtd[:3], o_j, lse_j, bhtd[3], causal=causal, blk=64,
                      interpret=True)
    delta_j = jnp.sum(o_j * bhtd[3], axis=-1)  # [B, Hq, T]
    o = torch.from_numpy(np.swapaxes(np.asarray(o_j), 1, 2).copy())
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy())
    dq, delta = fa.flash_attention_bwd_dq_reference(
        *_torch(q, k, v), o, torch.from_numpy(do), lse, causal)
    assert dq.shape == (B, T, Hq, D)
    assert delta.shape == (B, Hq, T) and delta.dtype == torch.float32
    np.testing.assert_allclose(dq.numpy(),
                               np.swapaxes(np.asarray(dq_j), 1, 2),
                               **PALLAS_GRAD_TOL)
    bound = 1e-5 * np.sum(np.abs(np.asarray(o_j * bhtd[3])), axis=-1)
    assert np.all(np.abs(delta.numpy() - np.asarray(delta_j)) <= bound)


def test_cpu_backward_takes_the_plain_versions():
    q, k, v, do = _torch(*_bwd_inputs(1, 40, 4, 2, 16))
    o, lse = fa.flash_attention_reference(q, k, v, True)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before  # no kernel
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    assert torch.equal(dq, want[0])
    assert torch.equal(delta, fa.attention_delta(o, do))


@pytest.mark.parametrize("case", ["do_fp32", "do_shape", "lse_layout",
                                  "delta_dtype", "do_strides", "o_fp32",
                                  "o_strides", "do_bf16_q_fp32",
                                  "o_fp16_q_fp32", "do_fp16"])
def test_backward_guard_rejects_before_launch(case):
    """do and o take q's dtype, whichever it is: do_fp32 / o_fp32 (q
    bf16) and the cases below are each a dtype that differs from q's."""
    q, k, v = _bf16((1, 64, 4, 64), (1, 64, 2, 64))
    if case.endswith("q_fp32"):
        q, k, v = q.float(), k.float(), v.float()
    do = torch.zeros_like(q)
    o = torch.zeros_like(q)
    lse = torch.zeros(1, 4, 64)
    delta = torch.zeros(1, 4, 64)
    exc = ValueError
    if case == "do_fp32":
        do, exc = do.float(), TypeError
    elif case == "do_bf16_q_fp32":
        do, exc = do.bfloat16(), TypeError
    elif case == "o_fp16_q_fp32":
        o, exc = o.half(), TypeError
    elif case == "do_fp16":
        do, exc = do.half(), TypeError
    elif case == "do_shape":
        do, exc = do[:, :32], TypeError
    elif case == "lse_layout":
        lse = torch.zeros(1, 64, 4).transpose(1, 2)
    elif case == "delta_dtype":
        delta = delta.double()
    elif case == "do_strides":
        do = do.transpose(1, 3).contiguous().transpose(1, 3)
    elif case == "o_fp32":
        o, exc = o.float(), TypeError
    else:
        o = o.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(exc):
        fa.check_backward_inputs(q, k, v, do, lse, delta, o)


def test_backward_guard_accepts_what_each_kernel_reads():
    """The dQ kernel reads o and lse, the dK/dV kernel lse and delta: each
    wrapper's guard takes its own set."""
    q, k, v = _bf16((1, 64, 4, 64), (1, 64, 2, 64))
    lse = torch.zeros(1, 4, 64)
    fa.check_backward_inputs(q, k, v, torch.zeros_like(q), lse,
                             o=torch.zeros_like(q))
    fa.check_backward_inputs(q, k, v, torch.zeros_like(q), lse,
                             torch.zeros(1, 4, 64))


# --------------------------------------------------------------------------- #
# The widened inputs against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #

WIDE_TOL = dict(atol=2e-2, rtol=2e-2)  # the JAX suite's forward bound

WIDE_CASES = [
    # (B, T, Hq, Hkv, D, causal, dtype): head_dim 256 (the kernels' new
    # instantiation; JAX takes it without padding) with GQA 2/1, causal
    # and full; head_dim 72 (JAX pads it to 128 lanes); float16 at 64
    (1, 128, 2, 1, 256, True, "float32"),
    (1, 128, 2, 1, 256, False, "float32"),
    (1, 128, 2, 2, 72, True, "float32"),
    (1, 128, 2, 1, 72, False, "float32"),
    (1, 128, 2, 1, 64, True, "float16"),
    (1, 128, 2, 2, 64, False, "float16"),
    # head_dim past 256, the slab kernels' inputs (JAX pads 320 to 384),
    # bf16 and fp32, GQA 2/1 and 2/2, causal and full
    (1, 128, 2, 1, 320, True, "bfloat16"),
    (1, 128, 2, 2, 320, False, "float32"),
    (1, 128, 2, 1, 384, False, "float32"),
    (1, 128, 2, 2, 384, True, "bfloat16"),
    (1, 128, 2, 1, 512, True, "float32"),
    (1, 128, 2, 2, 512, False, "bfloat16"),
    (1, 128, 2, 1, 512, False, "bfloat16"),
    (1, 128, 2, 2, 512, True, "float32"),
]


def _wide_inputs(B, T, Hq, Hkv, D, dtype, seed):
    q, k, v, do = _bwd_inputs(B, T, Hq, Hkv, D, seed)
    dtype = jnp.bfloat16 if dtype == "bfloat16" else dtype
    return tuple(x.astype(dtype) for x in (q, k, v, do))


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal,dtype", WIDE_CASES)
def test_widened_forward_matches_pallas(B, T, Hq, Hkv, D, causal, dtype):
    q, k, v, _ = _wide_inputs(B, T, Hq, Hkv, D, dtype, seed=9)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, interpret=True)
    o, lse = fa.flash_attention_reference(*_torch(q, k, v), causal)
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(want, np.float32), **WIDE_TOL)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal,dtype", WIDE_CASES)
def test_widened_backward_matches_pallas_grads(B, T, Hq, Hkv, D, causal,
                                               dtype):
    q, k, v, do = _wide_inputs(B, T, Hq, Hkv, D, dtype, seed=10)
    want = _jax_grads(lambda q, k, v: jax_flash(q, k, v, causal=causal,
                                                interpret=True), q, k, v, do)
    got = _port_grads(q, k, v, do, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=name, **PALLAS_GRAD_TOL)


@pytest.mark.parametrize("n_kv_heads", [1, 2])
def test_head_dim_256_llama_step_matches_jax(n_kv_heads):
    """A debug-width Llama whose head_dim is 256 (dim 512 over 2 heads,
    one kv head or two, 2 layers, float32): the loss of one step's
    loss_fn and the global norm of its grads against the JAX model's,
    from the same params and tokens."""
    _wide_head_llama_step_matches_jax(256, n_kv_heads)


@pytest.mark.parametrize("n_kv_heads", [1, 2])
def test_head_dim_512_llama_step_matches_jax(n_kv_heads):
    """As above at head_dim 512 (dim 1024 over 2 heads), the width the
    slab kernels take on the card."""
    _wide_head_llama_step_matches_jax(512, n_kv_heads)


def _wide_head_llama_step_matches_jax(head_dim, n_kv_heads):
    kw = dict(dim=2 * head_dim, n_heads=2, n_kv_heads=n_kv_heads,
              n_layers=2)
    jcfg = dataclasses.replace(jl.LlamaConfig.debug(), dtype=jnp.float32,
                               **kw)
    tcfg = dataclasses.replace(tl.LlamaConfig.debug(), dtype=torch.float32,
                               **kw)
    assert tcfg.head_dim == jcfg.head_dim == head_dim
    tree = jax.tree.map(np.asarray,
                        jl.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.RandomState(11).randint(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jl.loss_fn(jcfg, p, jnp.asarray(toks)))(
            jax.tree.map(jnp.asarray, tree))
    model = tl.params_from_numpy(tcfg, tree, device="cpu")
    loss = tl.loss_fn(tcfg, model.tree(), torch.from_numpy(toks))
    loss.backward()
    norm = math.sqrt(sum(float(p.grad.double().pow(2).sum())
                         for p in model.parameters()))
    jnorm = math.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                          for g in jax.tree.leaves(jgrads)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=3e-3)
    np.testing.assert_allclose(norm, jnorm, rtol=3e-3)

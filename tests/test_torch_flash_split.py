"""float32 inputs in the port's flash attention, on the CPU: the split
pass that feeds the float32 dQ kernel, and the lengths that go to plain
attention (ray_tpu_torch/ops/flash_attention.py).

The CUDA split pass runs only on the card, where chip_smoke.py holds its
bf16 copies bitwise against the plain version tested here. Tolerances:

- the plain split: hi is x rounded to bfloat16 (torch's rounding to
  nearest even, as the kernel's), and hi + lo is within 2^-16 |x| of x
  (one rounding of what hi left, itself within 2^-9 |x|: 2^-18 |x|, with
  room); delta equals ``attention_delta`` exactly (the same function);
- a plain-torch model of the float32 dQ kernel's arithmetic on the split
  operands (S of the hi copies, dP as hi hi + lo hi + hi lo, P in
  float32, dS rounded to bfloat16 before dS K) and the port's float32
  plain backward, each against JAX's ``_bwd`` through its Pallas kernels
  in interpret mode at the JAX suite's grad bound 5e-2;
- a narrow float32 call's parts (q, do as hi | lo | hi | lo; k, v as hi |
  hi | lo | lo): bf16-exact values whose products over the head_dim sum to the
  float32 product within 2^-15 of its terms, and whose blocks give back a
  product over the keys within 2^-15 (one rounding of each operand: about
  2^-8);
- ``sends_to_plain`` against JAX's own rule (``_pick_block`` and
  ``_supported``) over a grid of lengths, dtypes and head counts: equal
  for float32, Tq != Tk alone for bfloat16 and float16;
- float32 ``flash_attention`` at a length JAX refuses: plain attention,
  counted, against JAX's ``flash_attention`` (its exact ``_fallback``) at
  1e-5, the JAX suite's bound for that case.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _bwd, _fwd, _pick_block, _supported
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops import flash_attention as fa

PALLAS_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)
EXACT_FALLBACK_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, T, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, h, D).astype(np.float32)
            for h in (Hq, Hkv, Hkv, Hq)]


@pytest.mark.parametrize("B,T,Hq,Hkv,D", [(1, 70, 4, 2, 64), (2, 33, 2, 1, 3),
                                          (1, 17, 4, 4, 36), (1, 9, 2, 1, 12)])
def test_split_reference_rounds_hi_and_keeps_the_rest(B, T, Hq, Hkv, D):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B, T, Hq, Hkv, D, 40))
    o, _ = fa.flash_attention_reference(q, k, v, True)
    split = fa.flash_attention_bwd_split_reference(q, k, v, o, do)
    w8 = -(-D // 8) * 8
    for name, x, hi, lo in (("q", q, split.q, None), ("k", k, split.k, None),
                            ("v", v, split.v, split.v_lo),
                            ("do", do, split.do, split.do_lo)):
        assert hi.dtype == torch.bfloat16 and hi.shape == (*x.shape[:3], w8)
        assert torch.equal(hi[..., :D], x.to(torch.bfloat16)), name
        assert not hi[..., D:].any(), name
        if lo is None:
            continue
        assert lo.dtype == torch.bfloat16 and not lo[..., D:].any(), name
        rest = (hi[..., :D].float() + lo[..., :D].float() - x).abs()
        assert bool((rest <= 2.0 ** -16 * x.abs()).all()), name
        # the rest carries what one rounding lost: without it, hi alone is
        # within 2^-9 |x| only
        assert (hi[..., :D].float() - x).abs().max() > rest.max()
    assert torch.equal(split.delta, fa.attention_delta(o, do))
    assert split.delta.shape == (B, Hq, T)


def _dq_model(q, k, v, do, lse, causal):
    """dq as the float32 dQ kernel computes it from the split operands:
    float32 sums of bf16-rounded operands, dP of three products."""
    split = fa.flash_attention_bwd_split_reference(
        q, k, v, fa.flash_attention_reference(q, k, v, causal)[0], do)
    D = q.shape[3]
    qh, kh, vh, vl, doh, dol = (x[..., :D].float() for x in split[:6])
    rep = q.shape[2] // k.shape[2]
    kh, vh, vl = (x.repeat_interleave(rep, dim=2) for x in (kh, vh, vl))
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(D)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * torch.ones(T, T).tril()
    dp = (torch.einsum("bqhd,bkhd->bhqk", doh, vh)
          + torch.einsum("bqhd,bkhd->bhqk", dol, vh)
          + torch.einsum("bqhd,bkhd->bhqk", doh, vl))
    ds = (p * (dp - split.delta[..., None]) / math.sqrt(D)).bfloat16()
    return torch.einsum("bhqk,bkhd->bqhd", ds.float(), kh)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", [(1, 128, 2, 1, 64, True),
                                                 (1, 64, 4, 2, 32, False),
                                                 (2, 128, 2, 2, 128, True)])
def test_float32_dq_on_split_operands_matches_pallas(B, T, Hq, Hkv, D,
                                                     causal):
    q, k, v, do = _inputs(B, T, Hq, Hkv, D, 41)
    bhtd = [jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, do)]
    o_j, lse_j = _fwd(*bhtd[:3], causal=causal, blk=64, interpret=True)
    dq_j, _, _ = _bwd(*bhtd[:3], o_j, lse_j, bhtd[3], causal=causal, blk=64,
                      interpret=True)
    want = np.swapaxes(np.asarray(dq_j), 1, 2)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_reference(qt, kt, vt, causal)
    np.testing.assert_allclose(_dq_model(qt, kt, vt, dot, lse, causal)
                               .numpy(), want, **PALLAS_GRAD_TOL)
    # the port's float32 plain backward, what the CPU runs
    dq, dk, dv = fa.flash_attention_backward(qt, kt, vt, o, lse, dot, causal)
    np.testing.assert_allclose(dq.numpy(), want, **PALLAS_GRAD_TOL)


@pytest.mark.parametrize("W", [4, 8, 12, 16])
def test_parts_carry_float32_products_through_bf16_operands(W):
    """A narrow float32 call passes q and do as hi | lo | hi | lo and k
    and v as hi | hi | lo | lo (values bf16 keeps exactly, so the kernels'
    rounding to bf16 changes nothing): a product over the head_dim sums
    (hi + lo)(hi + lo), within 2^-15 of the float32 product's terms, where
    rounding each operand once leaves about 2^-8; a product over the
    keys with a split operand as its columns gives back the float32
    product from its blocks (:func:`_join`)."""
    rng = np.random.RandomState(W)
    q, k, v = (torch.from_numpy(rng.randn(50, W).astype(np.float32) * 3)
               for _ in range(3))
    p = torch.from_numpy(rng.rand(40, 50).astype(np.float32))
    for x, lo_at in ((q, 1), (k, 2)):
        parts = fa._parts(x, lo_at)
        assert parts.shape == (50, 4 * W)
        assert torch.equal(parts.to(torch.bfloat16).float(), parts)
    exact = q.double() @ k.double().T
    scale = q.abs().double() @ k.abs().double().T
    got = (fa._parts(q, 1) @ fa._parts(k, 2).T).double()
    once = (q.bfloat16().double() @ k.bfloat16().double().T)
    assert ((got - exact).abs() <= 2.0 ** -15 * scale).all()
    assert ((once - exact).abs() / scale).max() > 2.0 ** -12
    for x, lo_at in ((v, 2), (q, 1)):
        joined = fa._join(p @ fa._parts(x, lo_at), W, lo_at).double()
        want = p.double() @ x.double()
        assert ((joined - want).abs() <= 2.0 ** -15
                * (p.double() @ x.abs().double())).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (4, 1)])
def test_sends_to_plain_follows_the_jax_rule(dtype, Hq, Hkv):
    lengths = (1, 16, 63, 64, 65, 100, 127, 128, 192, 200, 256, 320, 511,
               512, 1000, 1024, 2048)
    for T in lengths:
        for Tk in (T, T + 1, max(T // 2, 1)):
            q = torch.empty(1, T, Hq, 8, dtype=getattr(torch, dtype))
            k = torch.empty(1, Tk, Hkv, 8, dtype=q.dtype)
            jax_plain = not _supported(q, k, _pick_block(T))
            got = fa.sends_to_plain(q, k)
            if dtype == "float32":
                assert got == jax_plain, (T, Tk)
            else:
                assert got == (T != Tk), (T, Tk)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", [(1, 100, 2, 2, 32, True),
                                                 (2, 37, 4, 2, 16, False)])
def test_float32_off_the_jax_blocks_is_plain_attention(B, T, Hq, Hkv, D,
                                                       causal):
    q, k, v, do = _inputs(B, T, Hq, Hkv, D, 42)
    want = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                     interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=causal,
                                               interpret=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    plain = fa.flash_attention.plain_calls
    got = fa.flash_attention(*leaves, causal)
    assert fa.flash_attention.plain_calls == plain + 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **EXACT_FALLBACK_TOL)
    got.backward(torch.from_numpy(do))
    for x, w, name in zip(leaves, want_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   err_msg=name, **EXACT_FALLBACK_TOL)

"""float32 inputs in the port's flash attention, on the CPU: the split
passes that feed the float32 kernels (the forward's, and the backward's
that dQ and dK/dV share), and the lengths that go to plain attention
(ray_tpu_torch/ops/flash_attention.py).

The CUDA split passes run only on the card, where chip_smoke.py holds
their bf16 copies bitwise against the plain versions tested here.
Tolerances:

- the plain splits: hi is x rounded to bfloat16 (torch's rounding to
  nearest even, as the kernels'), padded with zero columns, bitwise; hi +
  lo is within 2^-16 |x| of x (one rounding of what hi left, itself
  within 2^-9 |x|: 2^-18 |x|, with room); delta equals
  ``attention_delta`` exactly (the same function), and a pass given no o
  writes the same copies and no delta;
- plain-torch models of the float32 kernels' arithmetic on the split
  copies, each against JAX's Pallas kernels in interpret mode: the
  forward (S of the hi copies, softmax in float32, P rounded to bfloat16
  before P V) against ``_fwd`` at the JAX suite's forward bound 2e-2, o
  and lse; dQ (dP as hi hi + lo hi + hi lo, P in float32, dS rounded to
  bfloat16 before dS K) and dK/dV (S^T and dP^T as dQ's, dV = P^T dO of P
  rounded to bfloat16, dK = dS^T Q of dS rounded, summed over the GQA
  group) against ``_bwd`` at its grad bound 5e-2; the port's float32
  plain backward too;
- the wrappers' own bookkeeping of a backward call's split (widths, the
  operands it is made from, the check that a given split belongs to the
  call), exactly;
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

PALLAS_FWD_TOL = dict(atol=2e-2, rtol=2e-2)
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


@pytest.mark.parametrize("B,T,Hq,Hkv,D", [(1, 70, 4, 2, 64), (2, 33, 2, 1, 3),
                                          (1, 17, 4, 4, 36), (1, 9, 2, 1, 12)])
def test_forward_split_reference_rounds_to_bf16_and_pads(B, T, Hq, Hkv, D):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(B, T, Hq, Hkv, D, 43))
    copies = fa.flash_attention_fwd_split_reference(q, k, v)
    w8 = -(-D // 8) * 8
    for name, x, hi in zip(copies._fields, (q, k, v), copies):
        assert hi.dtype == torch.bfloat16 and hi.shape == (*x.shape[:3], w8)
        assert torch.equal(hi[..., :D], x.to(torch.bfloat16)), name
        assert not hi[..., D:].any(), name
    # the backward's pass writes the same hi copies of q and k
    split = fa.flash_attention_bwd_split_reference(q, k, v, None, q)
    assert torch.equal(split.q, copies.q) and torch.equal(split.k, copies.k)
    assert torch.equal(split.v, copies.v)


def test_backward_split_without_o_writes_the_copies_alone():
    """A dK/dV call is given delta: its pass (o None) writes the copies a
    whole backward's pass writes, and no delta."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 40, 4, 2, 20, 44))
    o, _ = fa.flash_attention_reference(q, k, v, True)
    whole = fa.flash_attention_bwd_split_reference(q, k, v, o, do)
    alone = fa.flash_attention_bwd_split_reference(q, k, v, None, do)
    assert alone.delta is None
    for name, a, b in zip(whole._fields[:6], whole[:6], alone[:6]):
        assert torch.equal(a, b), name
    # on the CPU the wrapper is the plain version
    got = fa.flash_attention_bwd_split(q, k, v, None, do)
    assert got.delta is None and all(
        torch.equal(a, b) for a, b in zip(got[:6], alone[:6]))


def _fwd_model(q, k, v, causal):
    """o and lse as the float32 forward kernel computes them from its
    split pass's copies: float32 sums of bf16-rounded q and k, the
    softmax in float32, P rounded to bfloat16 before P V."""
    D = q.shape[3]
    qh, kh, vh = (x[..., :D].float() for x in
                  fa.flash_attention_fwd_split_reference(q, k, v))
    rep = q.shape[2] // k.shape[2]
    kh, vh = (x.repeat_interleave(rep, dim=2) for x in (kh, vh))
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                          -math.inf)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None]).bfloat16().float()
    return torch.einsum("bhqk,bkhd->bqhd", p, vh), lse


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", [(1, 128, 2, 1, 64, True),
                                                 (1, 64, 4, 2, 32, False),
                                                 (2, 128, 2, 2, 128, True)])
def test_float32_forward_on_split_copies_matches_pallas(B, T, Hq, Hkv, D,
                                                        causal):
    q, k, v, _ = _inputs(B, T, Hq, Hkv, D, 45)
    bhtd = [jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)]
    o_j, lse_j = _fwd(*bhtd, causal=causal, blk=64, interpret=True)
    want_o = np.swapaxes(np.asarray(o_j), 1, 2)
    want_lse = np.asarray(lse_j)[..., 0]
    o, lse = _fwd_model(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), want_o, **PALLAS_FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **PALLAS_FWD_TOL)


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


def _dkv_model(q, k, v, do, lse, delta, causal):
    """dk, dv as the float32 dK/dV kernel computes them from the split
    pass's copies (without delta: it is given): S^T of the hi copies, dP^T
    as hi hi + hi lo + lo hi, P in float32, P^T and dS^T rounded to
    bfloat16 before dV = P^T dO and dK = dS^T Q, summed over the q heads
    of each kv head in float32."""
    split = fa.flash_attention_bwd_split_reference(q, k, v, None, do)
    D = q.shape[3]
    qh, kh, vh, vl, doh, dol = (x[..., :D].float() for x in split[:6])
    B, T, Hkv, _ = k.shape
    rep = q.shape[2] // Hkv
    kh, vh, vl = (x.repeat_interleave(rep, dim=2) for x in (kh, vh, vl))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(D)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * torch.ones(T, T).tril()
    dp = (torch.einsum("bqhd,bkhd->bhqk", doh, vh)
          + torch.einsum("bqhd,bkhd->bhqk", dol, vh)
          + torch.einsum("bqhd,bkhd->bhqk", doh, vl))
    ds = (p * (dp - delta[..., None]) / math.sqrt(D)).bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), doh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return (dk.reshape(B, T, Hkv, rep, D).sum(3),
            dv.reshape(B, T, Hkv, rep, D).sum(3))


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", [(1, 128, 2, 1, 64, True),
                                                 (1, 64, 4, 2, 32, False),
                                                 (2, 128, 2, 2, 128, True)])
def test_float32_dkv_on_split_operands_matches_pallas(B, T, Hq, Hkv, D,
                                                      causal):
    q, k, v, do = _inputs(B, T, Hq, Hkv, D, 46)
    bhtd = [jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, do)]
    o_j, lse_j = _fwd(*bhtd[:3], causal=causal, blk=64, interpret=True)
    _, dk_j, dv_j = _bwd(*bhtd[:3], o_j, lse_j, bhtd[3], causal=causal,
                         blk=64, interpret=True)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_reference(qt, kt, vt, causal)
    delta = fa.attention_delta(o, dot)
    dk, dv = _dkv_model(qt, kt, vt, dot, lse, delta, causal)
    for got, want, name in ((dk, dk_j, "dk"), (dv, dv_j, "dv")):
        np.testing.assert_allclose(got.numpy(),
                                   np.swapaxes(np.asarray(want), 1, 2),
                                   err_msg=name, **PALLAS_GRAD_TOL)


@pytest.mark.parametrize("D,dtype,want", [
    (64, torch.float32, (64, 64, False)), (3, torch.float32, (4, 16, True)),
    (16, torch.float32, (16, 64, True)), (20, torch.float32, (20, 20, False)),
    (3, torch.bfloat16, (8, 8, False)),
    (256, torch.float32, (256, 256, False))])
def test_widths_name_what_the_kernels_read(D, dtype, want):
    assert fa._widths(D, dtype) == want
    # float32 reads split copies up to head_dim 256, no other dtype does
    assert fa._reads_copies(dtype, want[1]) == (dtype == torch.float32)
    assert not fa._reads_copies(torch.float32, 264)


@pytest.mark.parametrize("D", [3, 20, 64])
def test_a_backward_split_belongs_to_its_call(D):
    """The operands a backward call's split is made from are the kernels'
    (padded, narrow float32 as parts), the check passes that split and
    refuses one of another width or of other heads."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 24, 4, 2, D, 47))
    o, _ = fa.flash_attention_reference(q, k, v, True)
    W, Wk, parts = fa._widths(D, q.dtype)
    ops = fa._backward_operands(q, k, v, o, do)
    assert all(t.shape[3] == Wk for t in ops)
    if parts:  # o beside do's first hi and lo blocks: delta of o (hi + lo)
        assert torch.equal(ops[3][..., :W], ops[3][..., W:2 * W])
        assert not ops[3][..., 2 * W:].any()
    split = fa.flash_attention_bwd_split(*ops)
    fa._check_split(split, 2, 24, 4, 2, Wk)
    with pytest.raises(ValueError):
        fa._check_split(split, 2, 24, 4, 2, Wk + 8)
    with pytest.raises(ValueError):
        fa._check_split(split, 2, 24, 4, 4, Wk)


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

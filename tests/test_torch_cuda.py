"""The port on a CUDA device: the hand-written flash-attention kernels
(forward, dQ, dK/dV) and the serving and training paths through them.
Every test here is marked ``gpu`` and skips itself without a card.

This file imports only torch and the port, so it runs on a card machine
that has no JAX; ``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance of the bf16 kernel against its float32 plain version: atol =
rtol = 2e-2, the JAX suite's own bound for its forward kernel
(tests/test_flash_attention.py); lse, which the kernel keeps in float32,
at 1e-3. The backward kernels' dq, dk, dv against their float32 plain
versions: atol = rtol = 5e-2, the JAX suite's grad bound, element by
element; and per (batch, 64-row block, head) rms(err) / (rms(ref) +
1e-3) at most 2e-2, the block bound of ``chip_smoke.py``, which holds the
late causal rows (whose gradients are small) as tightly as the early ones.
The dQ kernel's delta = rowsum(o * do) against the plain torch row sum:
|err| <= 1e-5 * rowsum(|o * do|), the float32 bound of one row sum taken
in another order.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(T, Hq, Hkv, D, device, seed=0, B=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(B, T, h, D, device=device, generator=g)
                 .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))


# lengths one short of, at and past the kernels' 64- and 128-row tiles,
# and a long one: the edges of the TMA rings and of the tile schedules
RING_T = [65, 127, 128, 129, 257, 4096]


@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("T,causal", [(1, True), (70, True), (130, False),
                                      (200, True)])
def test_kernel_matches_plain_version(cuda, D, T, causal):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(T, 8, 2, D, cuda)
    before = fa.flash_attention_forward.launches
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.launches == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-3)
    o2, lse2 = fa.flash_attention_forward(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _strided_qkv(B, T, Hq, Hkv, D, device):
    """q, k, v as column slices of one fused [B, T, (Hq + 2 Hkv) D]
    projection output: views into a wider tensor."""
    g = torch.Generator(device=device).manual_seed(3)
    fused = torch.randn(B, T, (Hq + 2 * Hkv) * D, device=device,
                        generator=g).to(torch.bfloat16)
    q = fused[..., :Hq * D].view(B, T, Hq, D)
    k = fused[..., Hq * D:(Hq + Hkv) * D].view(B, T, Hkv, D)
    v = fused[..., (Hq + Hkv) * D:].view(B, T, Hkv, D)
    assert not q.is_contiguous()
    return q, k, v


@pytest.mark.parametrize("B,T,D", [(1, 96, 64), (2, 257, 64), (2, 257, 128)])
def test_kernel_reads_strided_inputs(cuda, B, T, D):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _strided_qkv(B, T, 4, 2, D, cuda)
    o, lse = fa.flash_attention_forward(q, k, v, True)
    ro, rlse = fa.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", RING_T)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_at_ring_edges(cuda, D, T, causal):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(T, 8, 2, D, cuda, B=2)
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-3)
    o2, lse2 = fa.flash_attention_forward(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("case", ["tq_ne_tk", "fp64", "d_zero",
                                  "mixed_dtypes", "grad", "wrapper_grad"])
def test_cuda_tensors_never_fall_back(cuda, case):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(64, 4, 2, 64, cuda)
    exc = ValueError
    call = fa.flash_attention
    if case == "tq_ne_tk":  # flash_attention sends it to plain attention;
        # the kernel wrapper itself refuses it before a launch
        k, v = k[:, :32], v[:, :32]
        call = fa.flash_attention_forward
    elif case == "fp64":
        q, k, v, exc = q.double(), k.double(), v.double(), TypeError
    elif case == "d_zero":  # every head_dim >= 1 runs on the kernels
        q, k, v = _qkv(64, 4, 2, 0, cuda)
    elif case == "mixed_dtypes":
        k, exc = k.float(), TypeError
    elif case == "grad":  # inputs that need grad take the autograd path
        q, k, v, exc = q.double(), k.double(), v.double(), TypeError
        q.requires_grad_(True)
    else:  # the kernel wrapper alone would drop their gradient: it refuses
        q.requires_grad_(True)
        call, exc = fa.flash_attention_forward, RuntimeError
    before = fa.flash_attention_forward.launches
    with pytest.raises(exc):
        call(q, k, v, causal=True)
    assert fa.flash_attention_forward.launches == before


@pytest.mark.parametrize("tq,tk,dtype,atol", [
    (64, 32, torch.bfloat16, 2e-2), (100, 100, torch.float32, 1e-5),
    (129, 200, torch.float32, 1e-5)])
def test_flash_attention_sends_jax_refused_shapes_to_plain(cuda, tq, tk,
                                                           dtype, atol):
    """Tq != Tk, and float32 at a length no JAX block divides: plain
    attention on the card, counted in ``plain_calls``, no kernel launched,
    equal to the plain version (float32 at the JAX suite's 1e-5)."""
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(tq + tk)
    q, k, v = (torch.randn(1, t, h, 32, device=cuda, generator=g).to(dtype)
               for t, h in ((tq, 4), (tk, 2), (tk, 2)))
    kernels = (fa.flash_attention_forward, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    before = [fn.launches for fn in kernels]
    plain = fa.flash_attention.plain_calls
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.plain_calls == plain + 1
    assert [fn.launches for fn in kernels] == before
    want = fa.flash_attention_reference(q, k, v, True)[0]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("D", [3, 64, 128, 256])
def test_float32_dq_runs_on_the_split_pass(cuda, D):
    """float32 dQ up to head_dim 256: one split pass a call, whose bf16
    copies equal the plain version's bitwise and whose delta is the dQ
    wrapper's (at a narrow head_dim the wrapper's pass runs on the inputs'
    parts, and its delta is held to the bound); dq within the bounds
    above, bitwise repeatable."""
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v, do = (torch.randn(2, 257, h, D, device=cuda, generator=g)
                   for h in (8, 2, 2, 8))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    before = fa.flash_attention_bwd_split.launches
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    again = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_split.launches == before + 2
    assert torch.equal(dq, again[0]) and torch.equal(delta, again[1])
    split = fa.flash_attention_bwd_split(q, k, v, o, do)
    want = fa.flash_attention_bwd_split_reference(q, k, v, o, do)
    for name, a, b in zip(want._fields[:6], split[:6], want[:6]):
        assert torch.equal(a, b), name
    if D > fa.NARROW_WIDTH:
        assert torch.equal(split.delta, delta)
    want_dq, want_delta = fa.flash_attention_bwd_dq_reference(
        q, k, v, o, do, lse, True)
    torch.testing.assert_close(dq, want_dq, atol=5e-2, rtol=5e-2)
    assert _block_rel_err(dq, want_dq) <= GRAD_BLOCK_RTOL
    bound = 1e-5 * (o * do).abs().sum(-1).transpose(1, 2)
    assert bool(((delta - want_delta).abs() <= bound).all())


@pytest.mark.parametrize("D", [3, 64, 128, 256])
def test_float32_forward_runs_on_its_split_pass(cuda, D):
    """float32 forward up to head_dim 256: one split pass a call
    (``flash_attention_fwd_split``), whose bf16 copies equal the plain
    version's bitwise; o and lse within the bounds above (lse at the
    float32 variants' 2e-2), bitwise repeatable."""
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(D + 1)
    q, k, v = (torch.randn(2, 257, h, D, device=cuda, generator=g)
               for h in (8, 2, 2))
    before = fa.flash_attention_fwd_split.launches
    o, lse = fa.flash_attention_forward(q, k, v, True)
    again = fa.flash_attention_forward(q, k, v, True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_split.launches == before + 2
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    copies = fa.flash_attention_fwd_split(q, k, v)
    want = fa.flash_attention_fwd_split_reference(q, k, v)
    for name, a, b in zip(want._fields, copies, want):
        assert torch.equal(a, b), name
    ro, rlse = fa.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(o, ro, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=2e-2, rtol=0)


@pytest.mark.parametrize("D", [3, 64, 128, 256])
def test_float32_backward_runs_one_split_pass(cuda, D):
    """float32 backward up to head_dim 256: ``flash_attention_backward``
    runs one split pass for dQ and dK/dV together, a standalone dK/dV call
    one of its own (without delta), and both give the same dk and dv
    bitwise (the same copies, the same delta), as standalone dQ gives the
    same dq; dq, dk, dv within the bounds above, bitwise repeatable."""
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(D + 2)
    q, k, v, do = (torch.randn(2, 257, h, D, device=cuda, generator=g)
                   for h in (8, 2, 2, 8))
    o, lse = fa.flash_attention_forward(q, k, v, True)
    before = fa.flash_attention_bwd_split.launches
    got = fa.flash_attention_backward(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_split.launches == before + 1
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_split.launches == before + 3
    assert all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv)))
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, True)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a, b, atol=5e-2, rtol=5e-2, msg=name)
        assert _block_rel_err(a, b) <= GRAD_BLOCK_RTOL, name
    again = fa.flash_attention_backward(q, k, v, o, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_engine_serves_on_the_card_through_the_kernel(cuda):
    import json

    from ray_tpu_torch.models.llama import LlamaDecodeEngine
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.decode import DecodeScheduler

    # debug config at head_dim 16, bf16; no device given: cuda by default
    engine = LlamaDecodeEngine(n_pages=32, page_size=8, seed=0)
    assert engine.k_store.is_cuda
    sched = DecodeScheduler(engine)
    fa.flash_attention_forward.launches = 0
    req = {"prompt": list(range(1, 20)), "max_tokens": 6}
    finals = {}
    for corr in ("cold", "warm"):
        sched.submit(corr, req)
        active = True
        while active:
            replies, active = sched.step()
            finals.update({c: json.loads(p) for c, kind, p in replies
                           if kind == "final"})
    assert finals["warm"]["cached_prefix"] is True
    assert finals["warm"]["tokens"] == finals["cold"]["tokens"]
    assert engine.prefill_calls == 1
    assert fa.flash_attention_forward.launches == engine.cfg.n_layers


GRAD_BLOCK_RTOL = 2e-2
GRAD_FLOOR = 1e-3


def _block_rel_err(got, ref, rows=64):
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


def _backward_case(T, Hq, Hkv, D, causal, device, seed=1):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(T, Hq, Hkv, D, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(q.shape, device=device, generator=g).to(torch.bfloat16)
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("D", [16, 64, 80, 128])
@pytest.mark.parametrize("T,Hq,Hkv,causal", [(1, 8, 2, True),
                                            (70, 8, 2, True),
                                            (130, 4, 4, False),
                                            (200, 8, 1, True)])
def test_backward_kernels_match_plain_versions(cuda, D, T, Hq, Hkv, causal):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v, o, lse, do = _backward_case(T, Hq, Hkv, D, causal, cuda)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2,
                                   rtol=5e-2, msg=name)
        assert _block_rel_err(a, b) <= GRAD_BLOCK_RTOL, name
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
    again = (dq, *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,D", [
    (torch.float16, 64), (torch.float16, 256), (torch.float32, 64),
    (torch.float32, 128), (torch.float32, 256), (torch.bfloat16, 256),
    (torch.bfloat16, 200), (torch.bfloat16, 100), (torch.float16, 36),
    (torch.bfloat16, 264), (torch.bfloat16, 300), (torch.bfloat16, 512),
    (torch.float16, 512), (torch.float32, 384), (torch.bfloat16, 1024),
    (torch.bfloat16, 576), (torch.bfloat16, 1280), (torch.float32, 768),
    (torch.bfloat16, 1), (torch.float16, 4), (torch.float32, 3)])
@pytest.mark.parametrize("T,Hq,Hkv,causal", [(1, 8, 8, True),
                                            (129, 8, 1, False),
                                            (257, 8, 2, True)])
def test_kernels_take_every_dtype_and_head_dim(cuda, dtype, D, T, Hq, Hkv,
                                               causal):
    """fp16 and fp32 inputs and head_dims to 256, and past it on the slab
    kernels (dK/dV in clusters of two, three and four blocks, and past
    them, bf16 1280 and fp32 768, in blocks alone; 100, 36 and 300 in bf16
    and fp16, and 1, 4 and 3, read through a zero-padded copy, rows not
    whole 16-byte units):
    each kernel launches once a call, its outputs come back in q's dtype,
    within the bounds above of the plain versions, bitwise repeatable."""
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(D + T)
    q, k, v, do = (torch.randn(1, T, h, D, device=cuda, generator=g)
                   .to(dtype) for h in (Hq, Hkv, Hkv, Hq))
    before = [fn.launches for fn in (fa.flash_attention_forward,
                                     fa.flash_attention_bwd_dq,
                                     fa.flash_attention_bwd_dkv)]
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (fa.flash_attention_forward,
                                   fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)] == [
        n + 1 for n in before]
    ro, rlse = fa.flash_attention_reference(q, k, v, causal)
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=2e-2, rtol=0)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2,
                                   rtol=5e-2, msg=name)
        assert _block_rel_err(a, b) <= GRAD_BLOCK_RTOL, name
    again = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,D", [
    (torch.bfloat16, 256), (torch.float16, 256), (torch.float32, 256),
    (torch.bfloat16, 200)])
@pytest.mark.parametrize("T", [1, 65, 129, 257, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_at_head_dim_256_runs_its_own_kernel(cuda, dtype, D, T, causal):
    """dQ at head_dim 129-256 on flash_bwd_dq256_kernel (its launches
    counted): dq within the element and 64-row block bounds of the plain
    version, delta within 1e-5 of rowsum(|o * do|), both bitwise
    repeatable, at GQA 4 (8 q heads over 2)."""
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(D + T)
    q, k, v, do = (torch.randn(1, T, h, D, device=cuda, generator=g)
                   .to(dtype) for h in (8, 2, 2, 8))
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dq.d256_launches)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
    again = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dq.d256_launches) == (before[0] + 2,
                                                         before[1] + 2)
    assert torch.equal(dq, again[0]) and torch.equal(delta, again[1])
    want, want_delta = fa.flash_attention_bwd_dq_reference(
        q, k, v, o, do, lse, causal)
    assert dq.dtype == dtype and dq.shape == q.shape
    torch.testing.assert_close(dq.float(), want.float(), atol=5e-2,
                               rtol=5e-2)
    assert _block_rel_err(dq, want) <= GRAD_BLOCK_RTOL
    bound = 1e-5 * (o.float() * do.float()).abs().sum(-1).transpose(1, 2)
    assert bool(((delta - want_delta).abs() <= bound).all())


def _check_dkv(q, k, v, do, causal):
    """dK/dV kernel against its plain version: allclose, the block gate
    and bitwise repeatability."""
    from ray_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_attention_forward(q, k, v, causal)
    delta = fa.attention_delta(o, do)
    got = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    want = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                causal)
    for a, b, name in zip(got, want, ("dk", "dv")):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2,
                                   rtol=5e-2, msg=name)
        assert _block_rel_err(a, b) <= GRAD_BLOCK_RTOL, name
    again = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _check_dq(q, k, v, do, causal):
    """dQ kernel against its plain version: dq by allclose, the block gate
    and bitwise repeatability; delta within 1e-5 of rowsum(|o * do|).
    Returns the forward's o and lse and the kernel's delta."""
    from ray_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_attention_forward(q, k, v, causal)
    before = fa.flash_attention_bwd_dq.launches
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dq.launches == before + 1
    want, want_delta = fa.flash_attention_bwd_dq_reference(q, k, v, o, do,
                                                           lse, causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    torch.testing.assert_close(dq.float(), want.float(), atol=5e-2,
                               rtol=5e-2)
    assert _block_rel_err(dq, want) <= GRAD_BLOCK_RTOL
    assert delta.dtype == torch.float32 and delta.is_contiguous()
    bound = 1e-5 * (o.float() * do.float()).abs().sum(-1).transpose(1, 2)
    assert bool(((delta - want_delta).abs() <= bound).all())
    dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    return o, lse, delta


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", RING_T)
@pytest.mark.parametrize("causal", [True, False])
def test_dq_kernel_at_ring_edges(cuda, D, T, causal):
    q, k, v = _qkv(T, 8, 2, D, cuda, seed=5, B=2)
    g = torch.Generator(device=cuda).manual_seed(6)
    do = torch.randn(q.shape, device=cuda, generator=g).to(torch.bfloat16)
    _check_dq(q, k, v, do, causal)


@pytest.mark.parametrize("D", [64, 128])
def test_dq_kernel_reads_a_strided_q(cuda, D):
    q, k, v = _strided_qkv(2, 257, 8, 2, D, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    do = torch.randn(q.shape, device=cuda, generator=g).to(torch.bfloat16)
    _check_dq(q, k, v, do, True)


@pytest.mark.parametrize("D", [16, 64, 80, 128])
@pytest.mark.parametrize("T,causal", [(1, True), (129, False), (257, True)])
def test_dkv_kernel_given_the_dq_kernels_delta(cuda, D, T, causal):
    """The dK/dV kernel reads the delta the dQ kernel wrote: its results
    pass the same gates as with the plain torch row sum, and differ from
    those by no more than bf16 rounding of the outputs."""
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(T, 8, 2, D, cuda, seed=8, B=2)
    g = torch.Generator(device=cuda).manual_seed(9)
    do = torch.randn(q.shape, device=cuda, generator=g).to(torch.bfloat16)
    o, lse, delta = _check_dq(q, k, v, do, causal)
    got = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    plain_delta = fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                             fa.attention_delta(o, do),
                                             causal)
    want = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                causal)
    for a, b, c, name in zip(got, want, plain_delta, ("dk", "dv")):
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2,
                                   rtol=5e-2, msg=name)
        assert _block_rel_err(a, b) <= GRAD_BLOCK_RTOL, name
        # the two deltas differ by float32 rounding: bf16 rounding apart
        torch.testing.assert_close(a.float(), c.float(), atol=1e-2,
                                   rtol=8e-3, msg=name)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", RING_T)
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_kernel_at_ring_edges(cuda, D, T, causal):
    q, k, v = _qkv(T, 8, 2, D, cuda, seed=1, B=2)
    g = torch.Generator(device=cuda).manual_seed(2)
    do = torch.randn(q.shape, device=cuda, generator=g).to(torch.bfloat16)
    _check_dkv(q, k, v, do, causal)


@pytest.mark.parametrize("D", [64, 128])
def test_dkv_kernel_reads_a_strided_q(cuda, D):
    q, k, v = _strided_qkv(2, 257, 8, 2, D, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    do = torch.randn(q.shape, device=cuda, generator=g).to(torch.bfloat16)
    _check_dkv(q, k, v, do, True)


def test_backward_copies_a_grad_the_kernels_cannot_read(cuda):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v, o, lse, do = _backward_case(96, 4, 2, 64, True, cuda)
    want = fa.flash_attention_backward(q, k, v, o, lse, do, True)
    strided = do.transpose(1, 3).contiguous().transpose(1, 3)  # D not unit
    flat = torch.empty(do.numel() + 1, dtype=do.dtype, device=cuda)
    misaligned = flat[1:].view(do.shape).copy_(do)  # contiguous, 2-byte off
    for odd in (strided, misaligned):
        got = fa.flash_attention_backward(q, k, v, o, lse, odd, True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_loss_backward_reaches_the_kernels_not_the_plain_version(
        cuda, monkeypatch):
    from ray_tpu_torch.ops import flash_attention as fa

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    for name in ("flash_attention_reference",
                 "flash_attention_bwd_dq_reference",
                 "flash_attention_bwd_dkv_reference"):
        monkeypatch.setattr(fa, name, plain)
    q, k, v = (t.requires_grad_(True) for t in _qkv(100, 8, 2, 64, cuda))
    counts = (fa.flash_attention_forward.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out = fa.flash_attention(q, k, v, causal=True)
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_attention_forward.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(
                c + 1 for c in counts)
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16
               and bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


@pytest.mark.parametrize("case", ["do_fp32", "lse_fp16", "o_fp32"])
def test_backward_kernel_guard_raises(cuda, case):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v, o, lse, do = _backward_case(64, 4, 2, 64, True, cuda)
    exc = TypeError
    if case == "do_fp32":
        do = do.float()
    elif case == "o_fp32":
        o = o.float()
    else:
        lse, exc = lse.half(), ValueError
    before = fa.flash_attention_bwd_dq.launches
    with pytest.raises(exc):
        fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    assert fa.flash_attention_bwd_dq.launches == before


def test_train_step_on_the_card_through_the_kernels(cuda):
    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.ops import flash_attention as fa

    # debug config at head_dim 16 with remat on; no device given: cuda
    cfg = dataclasses.replace(LlamaConfig.debug(), remat=True, loss_chunk=16)
    init, step = make_train_step(cfg)
    state = init(0)
    assert next(state["params"].parameters()).is_cuda
    tokens = torch.arange(41, device=cuda).repeat(2, 1) % cfg.vocab_size
    fa.flash_attention_forward.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkv.launches = 0
    losses = [float(step(state, tokens)) for _ in range(5)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]
    assert fa.flash_attention_forward.launches == 2 * cfg.n_layers * 5
    assert fa.flash_attention_bwd_dq.launches == cfg.n_layers * 5
    assert fa.flash_attention_bwd_dkv.launches == cfg.n_layers * 5


def test_moe_train_step_on_the_card_through_the_kernels(cuda, monkeypatch):
    """The MoE decoder's single-card step: every layer's attention on the
    three kernels (launches exact under remat), none of their plain
    versions and no plain delta on the card, the loss falling."""
    from ray_tpu_torch.models.moe_llama import MoEConfig, make_train_step
    from ray_tpu_torch.ops import flash_attention as fa

    def plain(*args, **kwargs):
        raise AssertionError("a plain attention function ran on the card")

    for name in ("flash_attention_reference",
                 "flash_attention_bwd_dq_reference",
                 "flash_attention_bwd_dkv_reference", "attention_delta"):
        monkeypatch.setattr(fa, name, plain)
    # debug widths (4 experts, top 2, head_dim 16), remat on; cuda default
    cfg = dataclasses.replace(MoEConfig.debug(), remat=True, loss_chunk=16)
    init, step = make_train_step(cfg)
    state = init(0)
    assert next(state["params"].parameters()).is_cuda
    tokens = torch.arange(41, device=cuda).repeat(2, 1) % cfg.vocab_size
    for fn in (fa.flash_attention_forward, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv):
        fn.launches = 0
    losses = [float(step(state, tokens)) for _ in range(5)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]
    assert fa.flash_attention_forward.launches == 2 * cfg.n_layers * 5
    assert fa.flash_attention_bwd_dq.launches == cfg.n_layers * 5
    assert fa.flash_attention_bwd_dkv.launches == cfg.n_layers * 5


@pytest.mark.parametrize("causal", [True, False])
def test_ring_runs_its_blocks_on_the_kernels(cuda, causal):
    """Ring attention's per-rank loops (4 positions in one process, a
    list for the transport) on the card: every block through the three
    kernels, R(R+1)/2 launches of each under causal and R^2 without, o,
    dq, dk, dv within the kernels' bounds of the whole-T kernels and the
    merged lse within 1e-3 of the whole-T kernel's."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.ring_attention import \
        ring_attention_simulated

    q, k, v = _qkv(512, 8, 2, 64, cuda)
    do = _qkv(512, 8, 8, 64, cuda, seed=1)[0]
    kernels = (fa.flash_attention_forward, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    before = [f.launches for f in kernels]
    o, lse, grads = ring_attention_simulated(q, k, v, 4, causal, do=do)
    torch.cuda.synchronize()
    want = 10 if causal else 16
    assert [f.launches - b for f, b in zip(kernels, before)] == [want] * 3
    wo, wlse = fa.flash_attention_forward(q, k, v, causal)
    torch.testing.assert_close(lse, wlse, atol=1e-3, rtol=0)
    ref = (wo, *fa.flash_attention_backward(q, k, v, wo, wlse, do, causal))
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, *grads), ref):
        tol = 2e-2 if name == "o" else 5e-2
        torch.testing.assert_close(got.float(), w.float(), atol=tol,
                                   rtol=tol, msg=name)
        if name != "o":
            assert _block_rel_err(got, w) <= 2e-2, name


def test_ring_attention_without_seq_runs_the_kernels(cuda):
    """ring_attention on a mesh with no seq axis (one rank, through the
    launcher) is whole attention on the kernels, as JAX's fallback is
    its plain attention: one launch of each kernel for the forward and
    backward, and o within the forward's bound of the plain version."""
    import numpy as np

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train.launch import launch
    from ray_tpu_torch.train.spmd_runs import ring_jobs

    rng = np.random.RandomState(0)
    job = {n: rng.randn(1, 256, h, 64).astype(np.float32)
           for n, h in (("q", 8), ("k", 2), ("v", 2), ("r", 8))}
    job.update(mesh="", causal=True, dtype=torch.bfloat16)
    [[rep]] = launch(ring_jobs, 1, ([job], "cuda"), device="cuda")
    assert rep["launches"] == {"fwd": 1, "dq": 1, "dkv": 1}
    q, k, v = (torch.from_numpy(job[n]).to(torch.bfloat16) for n in "qkv")
    ro, _ = fa.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(torch.from_numpy(rep["o"]), ro.float(),
                               atol=2e-2, rtol=2e-2)


def test_observed_step_tallies_each_kernels_attention_work(cuda):
    """The kernels launch through ctypes, so the observatory counts them
    from their own reports: under an observed forward and backward each
    launch adds its attention_work, the backward ones from autograd's
    device thread too, and the step counts the same as unobserved."""
    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.util import program_observatory as po

    cfg = dataclasses.replace(LlamaConfig.debug(), remat=True, loss_chunk=16)
    B, T = 2, 40
    tokens = torch.arange(T + 1, device=cuda).repeat(B, 1) % cfg.vocab_size
    losses = []
    for observe in (False, True):
        init, step = make_train_step(cfg)
        if observe:
            step = po.observe_program(step, "test.cuda_train_step")
        losses.append(float(step(init(0), tokens)))
    assert losses[0] == losses[1]
    rec = po.get_program("test.cuda_train_step")
    shape = (B, T, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True)
    launches = {"fwd": 2 * cfg.n_layers, "dq": cfg.n_layers,
                "dkv": cfg.n_layers}
    assert rec["kernels"] == {
        k: {"launches": n, "flops": n * fa.attention_work(*shape, k)[0],
            "bytes": n * fa.attention_work(*shape, k)[1]}
        for k, n in launches.items()}
    # the backward's matmuls (autograd's thread) are counted as well
    assert rec["flops_by_op"]["aten.mm"] > 0
    assert rec["flops"] == sum(rec["flops_by_op"].values()) + sum(
        c["flops"] for c in rec["kernels"].values())


def test_trainer_default_loop_on_the_card(cuda, tmp_path):
    """The port's runtime finds the cards itself (``init()`` with no
    ``num_gpus``), and ``TorchTrainer(use_gpu=True)`` runs its default
    loop in one NCCL worker a card: each worker sees one card, the debug
    model's losses on one repeated batch are finite and fall, and each
    worker launched the kernels: one dQ and one dK/dV a layer a step, and
    one forward (two on a live fsdp axis)."""
    import math

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.spmd_runs import trainer_probe_loop

    world = min(torch.cuda.device_count(), 2)
    rt.init()
    try:
        assert rt.cluster_resources()["GPU"] == torch.cuda.device_count()
        cfg = LlamaConfig.debug()
        result = TorchTrainer(
            trainer_probe_loop,
            train_loop_config={"llama_config": cfg, "steps": 3, "seq": 64,
                               "mesh": f"fsdp={world}",
                               "distinct_batches": 1},
            scaling_config=ScalingConfig(num_workers=world, use_gpu=True),
            run_config=RunConfig(name="cuda", storage_path=str(tmp_path)),
        ).fit()
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    losses = [r["loss"] for r in result.metrics_dataframe if "loss" in r]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    ranks = result.metrics_dataframe[-1]["ranks"]
    assert [r["device_count"] for r in ranks] == [1] * world
    assert len({r["uuid"] for r in ranks}) == world
    # the forward runs once a layer call with remat off, twice under a
    # live fsdp axis (the streamed schedule recomputes each layer)
    calls = 3 * cfg.n_layers
    want = {"fwd": (2 if world > 1 or cfg.remat else 1) * calls,
            "dq": calls, "dkv": calls}
    assert [r["launches"] for r in ranks] == [want] * world
    assert not any(r["foreign_modules"] for r in ranks)


def test_nccl_group_across_gpu_actors(cuda):
    """``create_collective_group(backend="nccl")`` over actors that hold
    one card each: an allreduce, an allgather and a send/recv of CUDA
    tensors, against numpy."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import collective as col

    world = min(torch.cuda.device_count(), 2)

    @rt.remote(num_gpus=1)
    class Rank:
        def __init__(self, rank):
            self.rank = rank

        def ops(self):
            x = torch.full((3,), float(self.rank + 1), device="cuda")
            out = {"sum": col.allreduce(x, "n").cpu().numpy(),
                   "gather": [t.cpu().numpy()
                              for t in col.allgather(x, "n")],
                   "device": str(col.get_group_handle("n").device)}
            if world > 1 and self.rank == 0:
                col.send(x * 10, 1, "n")
            if world > 1 and self.rank == 1:
                out["recv"] = col.recv(0, "n").cpu().numpy()
            return out

    rt.init()
    try:
        actors = [Rank.remote(r) for r in range(world)]
        col.create_collective_group(actors, world, list(range(world)),
                                    backend="nccl", group_name="n")
        outs = rt.get([a.ops.remote() for a in actors], timeout=120)
    finally:
        rt.shutdown()
    total = sum(range(1, world + 1))
    for out in outs:
        assert out["device"] == "cuda:0"
        np.testing.assert_array_equal(out["sum"], np.full(3, float(total)))
        np.testing.assert_array_equal(
            np.stack(out["gather"]),
            np.stack([np.full(3, r + 1.0) for r in range(world)]))
    if world > 1:
        np.testing.assert_array_equal(outs[1]["recv"], np.full(3, 10.0))


def test_to_device_places_every_batch_on_the_card(cuda):
    """``to_device`` on the card: each batch's rows (``rows_of``) copied
    through fresh pinned memory with ``non_blocking``, double-buffered,
    every batch of the dataset held on the card at once equal to the
    rows it was made from (a pinned buffer reused under its copy would
    show as another batch's rows)."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as td

    rows = np.arange(64 * 4096, dtype=np.int32).reshape(64, 4096)
    rt.init(num_cpus=2)
    try:
        got = list(td.from_numpy([rows[:40], rows[40:]], column="x")
                   .to_device(batch_size=4, rows_of=lambda b: b[1:3],
                              prefetch_batches=2))
    finally:
        rt.shutdown()
    assert all(b["x"].device.type == "cuda" for b in got)
    torch.cuda.synchronize()
    placed = torch.stack([b["x"] for b in got]).cpu().numpy()
    assert np.array_equal(placed, rows.reshape(16, 4, 4096)[:, 1:3])

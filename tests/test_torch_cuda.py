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


@pytest.mark.parametrize("case", ["tq_ne_tk", "fp32", "big_d", "grad",
                                  "wrapper_grad"])
def test_cuda_tensors_never_fall_back(cuda, case):
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(64, 4, 2, 64, cuda)
    exc = ValueError
    call = fa.flash_attention
    if case == "tq_ne_tk":
        k, v = k[:, :32], v[:, :32]
    elif case == "fp32":
        q, k, v, exc = q.float(), k.float(), v.float(), TypeError
    elif case == "big_d":
        q, k, v = _qkv(64, 4, 2, 256, cuda)
    elif case == "grad":  # inputs that need grad take the autograd path
        q, k, v, exc = q.float(), k.float(), v.float(), TypeError
        q.requires_grad_(True)
    else:  # the kernel wrapper alone would drop their gradient: it refuses
        q.requires_grad_(True)
        call, exc = fa.flash_attention_forward, RuntimeError
    before = fa.flash_attention_forward.launches
    with pytest.raises(exc):
        call(q, k, v, causal=True)
    assert fa.flash_attention_forward.launches == before


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

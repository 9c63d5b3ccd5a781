"""The head_dim-256 kernels' split schedules and the slab backward
kernels' division of a launch past head_dim 256 (ray_tpu_torch/ops/
flash_schedule.py), on the CPU.

The CUDA kernels run only on the card; what they compute when split is
held here through the schedule they follow:

- coverage: every (kv tile, q head, q stage) pair of a dK/dV launch is
  walked by exactly one chunk, and every causal q tile's key stages by
  exactly one of its units, for any shape and SM count (hypothesis);
- arithmetic: a plain-torch emulation of the split kernels (each block
  over its own pairs or keys in float32; the dK/dV chunks' partial sums
  added in chunk order, the forward's halves merged by lse as
  ``flash_fwd_merge_kernel`` does) against the plain versions
  ``flash_attention_bwd_dkv_reference`` and ``flash_attention_reference``
  at 1e-5 (the same float32 arithmetic summed in another order), and
  against the JAX package's Pallas kernels in interpret mode at the JAX
  suite's own bounds, 2e-2 forward and 5e-2 grads;
- the slab kernels (head_dim past 256): every element of dQ, dK and dV
  owned by exactly one (block, consumer) and every dK/dV cluster's
  partials contracting over every column once, at the shapes of
  ``chip_smoke.py``'s ``kernel_dtypes`` and ``wide_head`` phases; and a
  plain-torch model of the blocks' arithmetic in their order (S and dP
  summed over 64-column slices, or over the cluster's slabs in rank
  order; P passed on in float32; P and dS rounded to the operand type
  before the products they feed) against the plain versions at 1e-5 in
  float32 and against the Pallas kernels in interpret mode at 2e-2 / 5e-2
  in bfloat16;
- the slab forward: every element of O owned by exactly one (block,
  consumer); up to head_dim 512 one block a (q tile, head) whose two
  consumers read each column of Q and K once (S computed once,
  ``wide_products``); and a plain-torch model of its arithmetic (each
  consumer's partial S over its slab's columns, the two added, the
  online softmax over 64-key tiles, P rounded to the operand type
  before P V) against the plain version at 1e-5 in float32 and the
  Pallas kernel at 2e-2 in bfloat16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import flash_schedule as fs

EXACT = dict(atol=1e-5, rtol=1e-5)
PALLAS_FWD_TOL = dict(atol=2e-2, rtol=2e-2)
PALLAS_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------------ coverage

shapes = st.tuples(
    st.integers(1, 2),                 # B
    st.integers(1, 8192),              # T
    st.integers(1, 4),                 # Hkv
    st.sampled_from([1, 2, 4, 8]),     # rep
    st.sampled_from([200, 256]),       # head_dim (the kernels' width)
    st.booleans(),                     # causal
    st.integers(1, 132))               # SMs


@settings(max_examples=60, deadline=None)
@given(shapes)
def test_every_dkv_pair_is_walked_by_one_chunk(shape):
    B, T, Hkv, rep, D, causal, sms = shape
    Hq = Hkv * rep
    n_split = fs.dkv_split(B, T, Hq, Hkv, D, causal, sms)
    tiles = _cdiv(T, fs.DKV_KV_ROWS)
    assert 1 <= n_split <= fs.MAX_DKV_SPLIT
    if tiles * Hkv * B >= sms:
        assert n_split == 1  # a launch that fills the card is not split
    blocks = fs.dkv_blocks(B, T, Hq, Hkv, causal, n_split)
    assert len(blocks) == tiles * Hkv * B * n_split
    n_qs_max = _cdiv(T, fs.DKV_Q_ROWS)
    walked = np.zeros((tiles, B, Hq, n_qs_max), np.int64)
    for kvtile, hk, b, chunk, it0, it1 in blocks:
        n_iter = fs.dkv_tile_iters(T, rep, kvtile, causal)
        n_qs = n_iter // rep
        q_start = kvtile * fs.DKV_KV_ROWS if causal else 0
        it = np.arange(it0, it1)
        # pair it: q head hk * rep + it // n_qs, q stage it % n_qs (its
        # rows from q_start on); stage index in 64-row units of T
        stage = q_start // fs.DKV_Q_ROWS + it % n_qs
        np.add.at(walked, (kvtile, b, hk * rep + it // n_qs, stage), 1)
    for kvtile in range(tiles):
        first = kvtile if causal else 0  # the diagonal's stage
        assert (walked[kvtile, :, :, first:] == 1).all()
        assert (walked[kvtile, :, :, :first] == 0).all()


@settings(max_examples=60, deadline=None)
@given(shapes)
def test_every_causal_q_tile_is_walked_once_by_its_units(shape):
    B, T, Hkv, rep, D, causal, sms = shape
    Hq = Hkv * rep
    ns = fs.forward_split_tiles(B, T, Hq, D, causal, sms)
    n_qtiles = _cdiv(T, fs.FWD_Q_ROWS)
    assert 0 <= ns <= n_qtiles
    if not causal or n_qtiles * Hq * B >= sms:
        assert ns == 0
    units = fs.forward_units(T, ns, causal)
    assert len(units) == n_qtiles + ns
    walked = {}
    for qt, j0, j1 in units:
        assert 0 <= j0 < j1  # no unit is empty
        walked.setdefault(qt, []).append((j0, j1))
    assert sorted(walked) == list(range(n_qtiles))
    for qt, ranges in walked.items():
        ranges.sort()
        assert ranges[0][0] == 0
        assert ranges[-1][1] == fs.forward_walk(T, qt, causal)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        # split tiles are the last ns, in two halves
        assert len(ranges) == (2 if qt >= n_qtiles - ns else 1)
    # longest first: the grid's units never grow in length
    lengths = [j1 - j0 for _, j0, j1 in units]
    assert lengths == sorted(lengths, reverse=True)


@pytest.mark.parametrize("D", [64, 128, 264, 512])
def test_other_head_dims_are_not_split(D):
    """Only the head_dim-256 instantiation splits: D 64 and 128 keep
    their kernels, the slab kernels past 256 theirs."""
    assert fs.dkv_split(1, 2048, 8, 1, D, True, 132) == 1
    assert fs.forward_split_tiles(1, 2048, 8, D, True, 132) == 0


def test_the_d256_row_splits_to_fill_the_card():
    """Gemma-2B's attention at a 2k prefill (B 1, 8 q heads over one kv
    head, head_dim 256, causal) on an H100's 132 SMs: the dK/dV kernel's
    32 blocks become 256 (kv tile 0's 256 pairs in chunks of 32, the
    average an SM walks), and the forward splits the 4 of its 16 q tiles
    that walk more than 24 of the longest's 32 key stages."""
    assert fs.dkv_split(1, 2048, 8, 1, 256, True, 132) == 8
    blocks = fs.dkv_blocks(1, 2048, 8, 1, True, 8)
    assert len(blocks) == 256
    assert max(it1 - it0 for *_, it0, it1 in blocks) == 32
    ns = fs.forward_split_tiles(1, 2048, 8, 256, True, 132)
    assert ns == 4
    units = fs.forward_units(2048, ns)
    assert len(units) == 20
    assert max(j1 - j0 for _, j0, j1 in units) == 24  # from 32


# --------------------------------------------------------- arithmetic


def _qkv(B, T, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, T, h, D).astype(np.float32))
                 for h in (Hq, Hkv, Hkv, Hq))


def emulate_dkv(q, k, v, do, lse, delta, causal, n_split):
    """dK, dV as the split dK/dV kernel and its reduction compute them:
    each block sums its chunk's pairs into float32 partials, then the
    partials are added in chunk order, 0 first."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    part = torch.zeros(n_split, 2, B, T, Hkv, D)
    for kvtile, hk, b, chunk, it0, it1 in fs.dkv_blocks(
            B, T, Hq, Hkv, causal, n_split):
        k0 = kvtile * fs.DKV_KV_ROWS
        keys = torch.arange(k0, min(k0 + fs.DKV_KV_ROWS, T))
        n_qs = fs.dkv_tile_iters(T, rep, kvtile, causal) // rep
        q_start = k0 if causal else 0
        for it in range(it0, it1):
            h = hk * rep + it // n_qs
            r0 = q_start + (it % n_qs) * fs.DKV_Q_ROWS
            rows = torch.arange(r0, min(r0 + fs.DKV_Q_ROWS, T))
            s = q[b, rows, h] @ k[b, keys, hk].T
            p = torch.exp(s * scale - lse[b, h, rows, None])
            if causal:
                p = torch.where(keys[None] > rows[:, None],
                                torch.zeros_like(p), p)
            dp = do[b, rows, h] @ v[b, keys, hk].T
            ds = p * (dp - delta[b, h, rows, None]) * scale
            part[chunk, 0, b, keys, hk] += ds.T @ q[b, rows, h]
            part[chunk, 1, b, keys, hk] += p.T @ do[b, rows, h]
    total = part[0]
    for chunk in range(1, n_split):
        total = total + part[chunk]
    return total[0], total[1]


def _unit_softmax(q, k, v, rows, keys, causal, scale):
    """o and lse of q rows ``rows`` over keys ``keys`` alone, as one
    block computes them: a row that sees none of the keys gets o = 0 and
    lse = -inf (the kernel's max(l, 1e-30) over m = -inf)."""
    s = torch.einsum("rhd,khd->hrk", q[rows], k[keys]) * scale
    if causal:
        s = torch.where(keys[None, None] > rows[None, :, None],
                        torch.full_like(s, -math.inf), s)
    m = s.amax(-1, keepdim=True)
    base = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - base)
    l_sum = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("hrk,khd->rhd", p / l_sum, v[keys])
    return o, (m + torch.log(l_sum))[..., 0]


def emulate_forward(q, k, v, causal, n_split_tiles):
    """o and lse as the split forward and its merge compute them: a block
    per unit over its key stages, the split tiles' two halves merged,
    part 0 then part 1, each weighted by exp(its lse - the merged lse)."""
    B, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    k, v = (x.repeat_interleave(rep, dim=2) for x in (k, v))
    scale = 1.0 / math.sqrt(D)
    o = torch.zeros(B, T, Hq, D)
    lse = torch.zeros(B, Hq, T)
    halves = {}
    for qt, j0, j1 in fs.forward_units(T, n_split_tiles, causal):
        rows = torch.arange(qt * fs.FWD_Q_ROWS,
                            min((qt + 1) * fs.FWD_Q_ROWS, T))
        keys = torch.arange(j0 * fs.FWD_KEYS, min(j1 * fs.FWD_KEYS, T))
        for b in range(B):
            o_u, lse_u = _unit_softmax(q[b], k[b], v[b], rows, keys, causal,
                                       scale)
            whole = j0 == 0 and j1 == fs.forward_walk(T, qt, causal)
            if whole:
                o[b, rows], lse[b, :, rows] = o_u, lse_u
            else:
                halves.setdefault((b, qt), {})[int(j0 > 0)] = (o_u, lse_u)
    for (b, qt), parts in halves.items():
        (o0, l0), (o1, l1) = parts[0], parts[1]
        mx = torch.maximum(l0, l1)
        e0, e1 = torch.exp(l0 - mx), torch.exp(l1 - mx)
        total = e0 + e1
        w0, w1 = (e0 / total).T[..., None], (e1 / total).T[..., None]
        rows = torch.arange(qt * fs.FWD_Q_ROWS,
                            min((qt + 1) * fs.FWD_Q_ROWS, T))
        o[b, rows] = w0 * o0 + w1 * o1
        lse[b, :, rows] = mx + torch.log(total)
    return o, lse


def _all_splits(T):
    """The most q tiles a forward can split (every one walking two key
    stages or more)."""
    return sum(fs.forward_walk(T, qt, True) >= 2
               for qt in range(_cdiv(T, fs.FWD_Q_ROWS)))


DKV_CASES = [
    # (B, T, Hq, Hkv, D, causal, n_split): the kernel's split counts on
    # ragged lengths, MQA and GQA, causal and full
    (1, 1, 4, 1, 16, True, 3),
    (1, 65, 4, 1, 16, True, 2),
    (1, 200, 4, 1, 16, True, 5),
    (2, 200, 4, 2, 16, False, 3),
    (1, 130, 8, 1, 8, True, 16),
    (1, 129, 2, 2, 16, False, 1),
]


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal,n_split", DKV_CASES)
def test_split_dkv_sums_equal_the_plain_version(B, T, Hq, Hkv, D, causal,
                                                n_split):
    q, k, v, do = _qkv(B, T, Hq, Hkv, D, seed=20)
    o, lse = fa.flash_attention_reference(q, k, v, causal)
    delta = fa.attention_delta(o, do)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, causal, n_split)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, delta, causal)
    torch.testing.assert_close(dk, want_dk, **EXACT)
    torch.testing.assert_close(dv, want_dv, **EXACT)


def test_split_dkv_at_the_rules_count_equals_the_plain_version():
    """The count the rule picks for a head_dim-256 MQA launch on a card
    of 16 SMs, emulated at a narrow head_dim."""
    B, T, Hq, Hkv = 1, 190, 4, 1
    n_split = fs.dkv_split(B, T, Hq, Hkv, 256, True, 16)
    assert n_split > 1
    q, k, v, do = _qkv(B, T, Hq, Hkv, 16, seed=21)
    o, lse = fa.flash_attention_reference(q, k, v, True)
    delta = fa.attention_delta(o, do)
    got = emulate_dkv(q, k, v, do, lse, delta, True, n_split)
    want = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **EXACT)


@pytest.mark.parametrize("B,T,Hq,Hkv,D", [
    (1, 65, 2, 1, 16), (1, 129, 4, 2, 16), (2, 300, 2, 1, 8),
    (1, 520, 2, 2, 8)])
@pytest.mark.parametrize("which", ["all", "rule"])
def test_split_forward_merge_equals_the_plain_version(B, T, Hq, Hkv, D,
                                                      which):
    """Every splittable q tile split, or the count the rule picks on a
    card of 4 SMs."""
    ns = _all_splits(T) if which == "all" else \
        fs.forward_split_tiles(B, T, Hq, 256, True, 4)
    q, k, v, _ = _qkv(B, T, Hq, Hkv, D, seed=22)
    o, lse = emulate_forward(q, k, v, True, ns)
    want_o, want_lse = fa.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(o, want_o, **EXACT)
    torch.testing.assert_close(lse, want_lse, **EXACT)


def _jax(x):
    return jnp.asarray(x.numpy())


def test_split_kernels_match_the_pallas_kernels():
    """The split forward (every splittable tile) and the split dK/dV (5
    chunks) against the JAX package's flash_attention through its Pallas
    kernels in interpret mode: its output at 2e-2 and its dk, dv at
    5e-2 (its suite's bounds)."""
    B, T, Hq, Hkv, D = 1, 192, 4, 1, 32
    q, k, v, do = _qkv(B, T, Hq, Hkv, D, seed=23)
    o, lse = emulate_forward(q, k, v, True, _all_splits(T))
    fn = lambda q, k, v: jax_flash(q, k, v, causal=True,  # noqa: E731
                                   interpret=True)
    want_o, vjp = jax.vjp(fn, _jax(q), _jax(k), _jax(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               **PALLAS_FWD_TOL)
    _, want_dk, want_dv = vjp(_jax(do))
    delta = fa.attention_delta(o, do)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, True, 5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk),
                               **PALLAS_GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv),
                               **PALLAS_GRAD_TOL)


# ------------------------------------------------ the slab kernels (D > 256)

# chip_smoke's kernel_dtypes variants past 256 (the kernels' widths: bf16
# 300 is read padded to 304) with their element sizes, its lengths and
# GQA groups (8 q heads); the wide_head phase's shapes (B, T, Hq, Hkv, D):
# its step at B 4 x 2048 and its serving prefills at B 1
SLAB_WIDTHS = ((264, 2), (304, 2), (320, 2), (384, 2), (512, 2), (576, 2),
               (1024, 2), (1280, 2), (384, 4), (512, 4), (768, 4))
SLAB_LENGTHS = (1, 65, 129, 257, 2048)
WIDE_HEAD_SHAPES = ((4, 2048, 4, 1, 512), (1, 7, 4, 1, 512),
                    (1, 200, 4, 1, 512), (1, 1000, 4, 1, 512))


def _slab_ownership(B, T, Hq, Hkv, D, elem_bytes):
    """dQ, dK and dV element counts over the slab grids' (block,
    consumer) outputs, and the dK/dV clusters' partial columns."""
    rows = fs.WIDE_ROWS
    dq = np.zeros((B, T, Hq, D), np.int8)
    for qtile, h, b, pair in fs.wide_dq_blocks(B, T, Hq, D, True):
        for consumer in range(fs.WIDE_DQ_SLABS):
            lo, hi = fs.wide_dq_columns(D, pair, consumer)
            dq[b, qtile * rows:(qtile + 1) * rows, h, lo:hi] += 1
    dkv = {name: np.zeros((B, T, Hkv, D), np.int8)
           for name in fs.WIDE_DKV_OUTPUTS}
    blocks = fs.wide_dkv_blocks(B, T, Hkv, D)
    size = fs.wide_dkv_cluster(D, elem_bytes)
    for kvtile, hk, b, slab in blocks:
        for consumer in range(2):
            name, lo, hi = fs.wide_dkv_output(D, slab, consumer)
            dkv[name][b, kvtile * rows:(kvtile + 1) * rows, hk, lo:hi] += 1
    clusters = [blocks[i:i + size] for i in range(0, len(blocks), size)]
    return dq, dkv, size, clusters


@pytest.mark.parametrize("D,elem_bytes", SLAB_WIDTHS)
@pytest.mark.parametrize("T", SLAB_LENGTHS)
def test_every_slab_output_is_owned_once(D, elem_bytes, T):
    for group in (1, 4, 8):
        _check_slab_ownership(1, T, 8, 8 // group, D, elem_bytes)


@pytest.mark.parametrize("B,T,Hq,Hkv,D", WIDE_HEAD_SHAPES)
def test_every_wide_head_output_is_owned_once(B, T, Hq, Hkv, D):
    _check_slab_ownership(B, T, Hq, Hkv, D, 2)


def _check_slab_ownership(B, T, Hq, Hkv, D, elem_bytes):
    dq, dkv, size, clusters = _slab_ownership(B, T, Hq, Hkv, D, elem_bytes)
    assert (dq == 1).all()
    for name in fs.WIDE_DKV_OUTPUTS:
        assert (dkv[name] == 1).all(), name
    n_slabs = _cdiv(D, fs.WIDE_SLAB)
    assert size in (1, n_slabs)
    assert size <= fs.WIDE_CLUSTER_SLABS[elem_bytes] <= 8
    for cluster in clusters:
        # a cluster's blocks are neighbours on the grid: one (kv tile, kv
        # head, batch), its slabs in rank order
        assert len({blk[:3] for blk in cluster}) == 1
        if size > 1:
            assert [blk[3] for blk in cluster] == list(range(size))
            cols = np.zeros(D, np.int8)
            for blk in cluster:
                lo, hi = fs.wide_dkv_partial_columns(D, blk[3])
                cols[lo:hi] += 1
            assert (cols == 1).all()


def test_slab_products_at_head_dim_512():
    """At head_dim 512 (bf16) each of S, dP and the three gradients is
    computed once: dQ 24 and dK/dV 32 products of 64 x 64 x 64 a
    (row tile, row tile) pair, the fewest; a block a slab that computed S
    and dP itself (in dK/dV in both consumers) issued 40 and 80."""
    p = fs.wide_products(512)
    assert (p["dq"], p["dkv"]) == (p["dq_least"], p["dkv_least"]) == (24, 32)
    n_cb, slabs = 8, 2
    assert slabs * (2 * n_cb + 4) == 40
    assert slabs * 2 * (2 * n_cb + 4) == 80
    assert (40 + 80) / (24 + 32) == pytest.approx(2.142857, rel=1e-6)
    # float32 at 512: a cluster too; past four slabs (two in float32) the
    # blocks run alone and sum S and dP over every column themselves
    assert fs.wide_dkv_cluster(512, 4) == 2
    assert fs.wide_dkv_cluster(1024, 2) == 4
    assert fs.wide_dkv_cluster(1280, 2) == fs.wide_dkv_cluster(768, 4) == 1


def _rounded(x, op):
    return x.to(op).float()


def emulate_slab_backward(q, k, v, o, do, lse, causal, op):
    """dq, dk, dv as the slab kernels compute them (float32 inputs holding
    values of the input type; ``op`` the operand type of the products):
    the dQ blocks' S and dP summed over 64-column slices in slice order,
    P in float32 and dS rounded to ``op`` before dQ += dS K; the dK/dV
    clusters' S^T and dP^T summed over their blocks' slab partials in
    rank order (a block alone: over its slices), P^T and dS^T rounded to
    ``op`` before dV += P^T dO and dK += dS^T Q over each slab."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    rows = fs.WIDE_ROWS
    scale = 1.0 / math.sqrt(D)
    log2e = 1.4426950408889634
    delta = (o * do).sum(-1).transpose(1, 2)  # [B, Hq, T]
    slices = [slice(c, min(c + 64, D)) for c in range(0, D, 64)]

    def contract(a, b, parts):
        total = None
        for cols in parts:
            x = a[:, cols] @ b[:, cols].T
            total = x if total is None else total + x
        return total

    def probs(s, lse_rows, qrows, keys):
        p = torch.exp2(s * scale * log2e - lse_rows[:, None] * log2e)
        if causal:
            p = torch.where(keys[None] > qrows[:, None], torch.zeros_like(p),
                            p)
        return p

    dq = torch.zeros_like(q)
    for qtile, h, b, pair in fs.wide_dq_blocks(B, T, Hq, D, causal):
        qrows = torch.arange(qtile * rows, min((qtile + 1) * rows, T))
        hk = h // rep
        n_tiles = _cdiv(min((qtile + 1) * rows, T) if causal else T, rows)
        for j in range(n_tiles):
            keys = torch.arange(j * rows, min((j + 1) * rows, T))
            s = contract(q[b, qrows, h], k[b, keys, hk], slices)
            p = probs(s, lse[b, h, qrows], qrows, keys)
            dp = contract(do[b, qrows, h], v[b, keys, hk], slices)
            ds = _rounded(p * (dp - delta[b, h, qrows, None]) * scale, op)
            for consumer in range(fs.WIDE_DQ_SLABS):
                lo, hi = fs.wide_dq_columns(D, pair, consumer)
                dq[b, qrows, h, lo:hi] += ds @ k[b, keys, hk, lo:hi]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    size = fs.wide_dkv_cluster(D, 2 if op != torch.float32 else 4)
    parts = ([slice(*fs.wide_dkv_partial_columns(D, r))
              for r in range(size)] if size > 1 else slices)
    for kvtile, hk, b, slab in fs.wide_dkv_blocks(B, T, Hkv, D):
        keys = torch.arange(kvtile * rows, min((kvtile + 1) * rows, T))
        q_start = kvtile * rows if causal else 0
        for h in range(hk * rep, (hk + 1) * rep):
            for r0 in range(q_start, T, rows):
                qrows = torch.arange(r0, min(r0 + rows, T))
                st = contract(k[b, keys, hk], q[b, qrows, h], parts)
                pt = probs(st.T, lse[b, h, qrows], qrows, keys).T
                dpt = contract(v[b, keys, hk], do[b, qrows, h], parts)
                dst = pt * (dpt - delta[b, h, None, qrows]) * scale
                for name, a, x in (("dv", pt, do), ("dk", dst, q)):
                    _, lo, hi = fs.wide_dkv_output(
                        D, slab, fs.WIDE_DKV_OUTPUTS.index(name))
                    out = dv if name == "dv" else dk
                    out[b, keys, hk, lo:hi] += (_rounded(a, op)
                                                @ x[b, qrows, h, lo:hi])
    return dq, dk, dv


SLAB_MODEL_CASES = [
    # (B, T, Hq, Hkv, D, causal): one pair and a cluster of two, ragged
    # T; two pairs and a cluster of three; four slabs; past the cluster
    (1, 100, 2, 1, 320, True),
    (1, 70, 4, 2, 512, False),
    (2, 65, 2, 1, 576, True),
    (1, 40, 2, 2, 1024, True),
    (1, 33, 2, 1, 1280, False),
]


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", SLAB_MODEL_CASES)
def test_slab_model_equals_the_plain_version(B, T, Hq, Hkv, D, causal):
    q, k, v, do = _qkv(B, T, Hq, Hkv, D, seed=24)
    o, lse = fa.flash_attention_reference(q, k, v, causal)
    got = emulate_slab_backward(q, k, v, o, do, lse, causal, torch.float32)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                 causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, **EXACT, msg=name)


@pytest.mark.parametrize("T,Hkv,D,causal", [(128, 1, 320, True),
                                            (128, 2, 512, False),
                                            (96, 1, 576, True)])
def test_slab_model_matches_the_pallas_kernels(T, Hkv, D, causal):
    """bfloat16 inputs, the products' operands rounded as the kernels
    round them, against the JAX package's flash_attention through its
    Pallas kernels in interpret mode (its grads at 5e-2)."""
    q, k, v, do = (x.bfloat16() for x in _qkv(1, T, 2, Hkv, D, seed=25))
    fn = lambda q, k, v: jax_flash(q, k, v, causal=causal,  # noqa: E731
                                   interpret=True)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v, do))
    want_o, vjp = jax.vjp(fn, jq, jk, jv)
    want = vjp(jdo)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o, lse = fa.flash_attention_reference(qf, kf, vf, causal)
    o = o.bfloat16().float()  # the forward's output, in the input type
    got = emulate_slab_backward(qf, kf, vf, o, dof, lse, causal,
                                torch.bfloat16)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.bfloat16().float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=name, **PALLAS_GRAD_TOL)


# ------------------------------------------------ the slab forward (D > 256)

FWD_WIDTHS = (264, 300, 320, 384, 512, 576, 1024)


def _fwd_ownership(B, T, Hq, D):
    """O element counts over the slab forward grid's (block, consumer)
    outputs, and per block the columns of Q and K its consumers sum S
    over."""
    o = np.zeros((B, T, Hq, D), np.int8)
    reads = []
    rows = fs.WIDE_ROWS if D <= fs.WIDE_FWD_PAIR_WIDTH \
        else fs.WIDE_FWD_SLAB_ROWS
    for qtile, h, b, slab in fs.wide_fwd_blocks(B, T, Hq, D, True):
        cols = np.zeros(D, np.int8)
        for consumer in range(2):
            (r0, r1), (lo, hi), (s0, s1) = fs.wide_fwd_consumer(D, slab,
                                                                consumer)
            o[b, qtile * rows + r0:qtile * rows + r1, h, lo:hi] += 1
            cols[s0:s1] += 1
        reads.append(((qtile, h, b), cols))
    return o, reads


@pytest.mark.parametrize("D", FWD_WIDTHS)
@pytest.mark.parametrize("T", SLAB_LENGTHS)
def test_every_slab_forward_output_is_owned_once(D, T):
    for Hq in (1, 8):
        o, reads = _fwd_ownership(2, T, Hq, D)
        assert (o == 1).all()
        if D <= fs.WIDE_FWD_PAIR_WIDTH:
            # one block a (q tile, head, batch), whose two consumers read
            # each column of Q and K once a step: S computed once
            assert len({key for key, _ in reads}) == len(reads)
            assert all((cols == 1).all() for _, cols in reads)
        else:
            # past two slabs each slab's block sums S over every column
            # in each of its consumers (their own q rows)
            assert all((cols == 2).all() for _, cols in reads)


@pytest.mark.parametrize("B,T,Hq,Hkv,D", WIDE_HEAD_SHAPES)
def test_wide_head_forward_grid_is_one_block_a_q_tile_and_head(B, T, Hq,
                                                               Hkv, D):
    blocks = fs.wide_fwd_blocks(B, T, Hq, D, True)
    assert len(blocks) == _cdiv(T, fs.WIDE_ROWS) * Hq * B
    # causal: the longest q tiles first, every head of a tile side by side
    assert [b[0] for b in blocks[:Hq * B]] == [_cdiv(T, 64) - 1] * (Hq * B)
    o, _ = _fwd_ownership(B, T, Hq, D)
    assert (o == 1).all()


def test_slab_forward_computes_s_once_at_head_dim_512():
    """At head_dim 512 the forward issues 16 products of 64 x 64 x 64 a
    (64-row, 64-key) pair, the fewest (S and P V once); a block a slab
    summing S itself issued 24 (1.5x); past 512 the slab kernel's count
    stands (2.5x at 1024)."""
    p = fs.wide_products(512)
    assert p["fwd"] == p["fwd_least"] == 16
    assert 2 * (8 + 4) == 24
    assert fs.wide_products(300)["fwd"] == 16  # the second slab's empty
    assert fs.wide_products(1024)["fwd"] == 80 == 2.5 * \
        fs.wide_products(1024)["fwd_least"]


def emulate_pair_forward(q, k, v, causal, op):
    """o and lse as the slab forward up to two slabs computes them
    (float32 inputs holding values of the input type; ``op`` the
    products' operand type): per (64-row q tile, head) block and 64-key
    tile, each consumer's partial S over its slab's columns, the two
    added (the same sum in both), the online softmax in float32, P
    rounded to ``op`` and O += P V over each consumer's slab."""
    B, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    o = torch.zeros_like(q)
    lse = torch.zeros(B, Hq, T)
    for qtile, h, b, _ in fs.wide_fwd_blocks(B, T, Hq, D, causal):
        rows = torch.arange(qtile * 64, min(qtile * 64 + 64, T))
        hk = h // rep
        n_tiles = _cdiv(min(qtile * 64 + 64, T) if causal else T, 64)
        m = torch.full((len(rows),), -math.inf)
        l = torch.zeros(len(rows))
        acc = torch.zeros(len(rows), D)
        for j in range(n_tiles):
            keys = torch.arange(j * 64, min(j * 64 + 64, T))
            parts = []
            for consumer in range(2):
                _, _, (s0, s1) = fs.wide_fwd_consumer(D, 0, consumer)
                parts.append(q[b, rows, h, s0:s1] @ k[b, keys, hk, s0:s1].T)
            s = (parts[0] + parts[1]) * scale
            if causal:
                s = torch.where(keys[None] > rows[:, None],
                                torch.full_like(s, -math.inf), s)
            mx = torch.maximum(m, s.max(-1).values)
            corr = torch.exp(m - mx)
            p = torch.exp(s - mx[:, None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[:, None]
            for consumer in range(2):
                _, (lo, hi), _ = fs.wide_fwd_consumer(D, 0, consumer)
                acc[:, lo:hi] += _rounded(p, op) @ v[b, keys, hk, lo:hi]
            m = mx
        o[b, rows, h] = acc / l[:, None]
        lse[b, h, rows] = m + torch.log(l)
    return o, lse


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", [(1, 100, 2, 1, 320, True),
                                                 (1, 70, 4, 2, 512, False),
                                                 (2, 65, 2, 1, 264, True)])
def test_pair_forward_model_equals_the_plain_version(B, T, Hq, Hkv, D,
                                                     causal):
    q, k, v, _ = _qkv(B, T, Hq, Hkv, D, seed=26)
    got_o, got_lse = emulate_pair_forward(q, k, v, causal, torch.float32)
    want_o, want_lse = fa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(got_o, want_o, **EXACT)
    torch.testing.assert_close(got_lse, want_lse, **EXACT)


@pytest.mark.parametrize("T,Hkv,D,causal", [(128, 1, 320, True),
                                            (128, 2, 512, False)])
def test_pair_forward_model_matches_the_pallas_kernel(T, Hkv, D, causal):
    """bfloat16 inputs, P rounded as the kernel rounds it, against the JAX
    package's flash_attention through its Pallas kernel in interpret mode
    (2e-2)."""
    q, k, v, _ = (x.bfloat16() for x in _qkv(1, T, 2, Hkv, D, seed=27))
    want = jax_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v)), causal=causal, interpret=True)
    got, _ = emulate_pair_forward(q.float(), k.float(), v.float(), causal,
                                  torch.bfloat16)
    np.testing.assert_allclose(got.bfloat16().float().numpy(),
                               np.asarray(want, np.float32), **PALLAS_FWD_TOL)

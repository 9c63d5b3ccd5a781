"""The head_dim-256 dQ kernel's division of the work
(``flash_bwd_dq256_kernel``, mirrored in ray_tpu_torch/ops/flash_schedule.py),
on the CPU.

The CUDA kernel runs only on the card; what it computes is held here
through the schedule it follows:

- ownership: every element of dQ at head_dims 129–256 is written by
  exactly one (block, consumer), each consumer adding dS K into its own
  128 columns;
- the stages: the consumers' steps and the producer's loads, played out
  in order with the kernel's barrier rules (V's stage freed by dP, K's by
  both halves of dS K; the next tile's S or dP issued ahead of dS K, the
  third stage over Q and dO), reach the end for three stages (bf16, fp16)
  and one (float32), and no load overwrites a stage a consumer still
  reads, or Q and dO before both consumers hold them in registers;
- arithmetic: a plain-torch emulation of the kernel's steps, tile by tile
  (consumer 0's S and P, consumer 1's dP and dS, each half's dS K), against
  the plain version ``flash_attention_bwd_dq_reference`` at 1e-5 in
  float32 (the same float32 arithmetic summed in another order: over 64-key
  tiles), at ragged T, GQA 1/4/8, causal and full, head_dim 200 and 256;
  and, bfloat16 inputs with P's and dS's roundings where the kernel rounds
  them, against the JAX package's flash_attention through its Pallas
  kernels in interpret mode at its suite's grad bound, 5e-2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import flash_schedule as fs

EXACT = dict(atol=1e-5, rtol=1e-5)
PALLAS_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)
LOG2E = 1.4426950408889634


def _qkv(B, T, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, T, h, D).astype(np.float32))
                 for h in (Hq, Hkv, Hkv, Hq))


# ------------------------------------------------------------- ownership


@pytest.mark.parametrize("D", [136, 200, 256])
@pytest.mark.parametrize("T", [1, 65, 129, 257, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_every_dq_element_is_owned_once(D, T, causal):
    """chip_smoke's kernel_dtypes lengths; each (q tile, head) once on
    the grid, its two consumers' columns covering the row once."""
    B, Hq = 1, 8
    assert fs.dq_kernel(D) == "flash_bwd_dq256_kernel"
    count = np.zeros((B, T, Hq, D), np.int8)
    blocks = fs.dq256_blocks(B, T, Hq, causal)
    assert len(blocks) == len({blk[:3] for blk in blocks})
    for qtile, h, b, n_tiles in blocks:
        rows = slice(qtile * fs.DQ256_ROWS, (qtile + 1) * fs.DQ256_ROWS)
        assert n_tiles * fs.DQ256_KEYS >= (
            min((qtile + 1) * fs.DQ256_ROWS, T) if causal else T)
        for consumer in range(len(fs.DQ256_PRODUCTS)):
            lo, hi = fs.dq256_columns(D, consumer)
            count[b, rows, h, lo:hi] += 1
    assert (count == 1).all()


def test_causal_blocks_run_longest_first():
    walks = [blk[3] for blk in fs.dq256_blocks(1, 2048, 8, True)]
    assert walks == sorted(walks, reverse=True)
    assert walks[0] == 32 and walks[-1] == 1 and len(walks) == 32 * 8


@pytest.mark.parametrize("width,kernel", [
    (64, "flash_bwd_dq_kernel"), (128, "flash_bwd_dq_kernel"),
    (136, "flash_bwd_dq256_kernel"), (256, "flash_bwd_dq256_kernel"),
    (264, "flash_bwd_dq_wide_kernel")])
def test_widths_take_their_dq_kernel(width, kernel):
    assert fs.dq_kernel(width) == kernel


# ------------------------------------------------------------- the stages


def play_stages(n_tiles, elem_bytes):
    """The kernel's producer and two consumers stepped in turns under its
    barrier rules; returns the loads and frees in the order they happened.
    Raises if the three stop short of the end (a deadlock), a load lands
    in a stage that a consumer still reads, or a stage over Q and dO is
    loaded before both consumers hold Q and dO in registers."""
    n_stages, n_own = fs.dq256_stages(elem_bytes)
    ahead = n_stages > 1
    full = {(w, s): 0 for w in ("k", "v") for s in range(n_stages)}
    freed = {key: set() for key in full}  # consumers done with the stage
    reading = {key: set() for key in full}
    qdo_read = set()  # consumers holding Q or dO in registers
    log = []

    def producer():
        for j in range(n_tiles):
            if n_stages > n_own and j == n_own:
                while qdo_read != {0, 1}:  # the stage over Q and dO
                    yield
            for which in ("v", "k"):  # V before K
                key = (which, j % n_stages)
                if j >= n_stages:
                    while not set(fs.DQ256_FREES[which]) <= freed[key]:
                        yield
                    freed[key] = set()
                assert not reading[key], (which, j, reading[key])
                assert j % n_stages < n_own or qdo_read == {0, 1}
                full[key] = j + 1
                log.append(("load", which, j))

    def consumer(c):
        own = "k" if fs.DQ256_PRODUCTS[c] == "S" else "v"

        def take(which, j):  # wait for tile j's stage, then read it
            while full[(which, j % n_stages)] != j + 1:
                yield
            reading[(which, j % n_stages)].add(c)

        def free(which, j):
            reading[(which, j % n_stages)].discard(c)
            freed[(which, j % n_stages)].add(c)
            log.append(("free", which, j, c))

        qdo_read.add(c)  # Q or dO into registers
        yield
        yield from take(own, 0)  # the first S or dP
        for j in range(n_tiles):
            more = j + 1 < n_tiles
            if own == "v":
                free("v", j)  # dP has completed
            yield  # P or dS written
            if ahead and more:
                yield from take(own, j + 1)  # the next S or dP
            yield  # the other's hand-off
            yield from take("k", j)  # dS K reads K's stage
            free("k", j)  # dS K has completed
            if not ahead and more:
                yield from take(own, j + 1)

    runs = [producer(), consumer(0), consumer(1)]
    done = [False] * 3
    for _ in range(100 * n_tiles + 100):
        for i, run in enumerate(runs):
            if not done[i]:
                try:
                    next(run)
                except StopIteration:
                    done[i] = True
        if all(done):
            return log
    raise AssertionError(f"stuck: {done}")


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n_tiles", [1, 2, 3, 4, 32])
def test_stages_are_freed_without_deadlock(elem_bytes, n_tiles):
    log = play_stages(n_tiles, elem_bytes)
    loads = [e for e in log if e[0] == "load"]
    assert len(loads) == 2 * n_tiles
    # K's stage of tile j is freed by both consumers, V's by consumer 1
    for j in range(n_tiles):
        assert {e[3] for e in log if e[:3] == ("free", "k", j)} == {0, 1}
        assert {e[3] for e in log if e[:3] == ("free", "v", j)} == {1}


# ------------------------------------------------------------- arithmetic


def emulate_dq256(q, k, v, o, do, lse, causal, op):
    """dq and delta as flash_bwd_dq256_kernel computes them (float32
    inputs holding values of the input type; ``op`` the operand type of
    the products): per block and 64-key tile, consumer 0's S = Q K^T and
    P = exp2(S scale log2e - lse log2e), masked; consumer 1's dP = dO V^T
    and dS = P (dP - delta) scale, rounded to ``op``; then each consumer's
    dQ[:, its 128 columns] += dS K[:, its columns]."""
    B, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    delta = fa.attention_delta(o, do)
    dq = torch.zeros_like(q)
    for qtile, h, b, n_tiles in fs.dq256_blocks(B, T, Hq, causal):
        rows = torch.arange(qtile * fs.DQ256_ROWS,
                            min((qtile + 1) * fs.DQ256_ROWS, T))
        hk = h // rep
        lse2 = lse[b, h, rows, None] * LOG2E
        for j in range(n_tiles):
            keys = torch.arange(j * fs.DQ256_KEYS,
                                min((j + 1) * fs.DQ256_KEYS, T))
            # consumer 0
            s = q[b, rows, h] @ k[b, keys, hk].T
            p = torch.exp2(s * (scale * LOG2E) - lse2)
            if causal:
                p = torch.where(keys[None] > rows[:, None],
                                torch.zeros_like(p), p)
            # consumer 1
            dp = do[b, rows, h] @ v[b, keys, hk].T
            ds = (p * (dp - delta[b, h, rows, None]) * scale).to(op).float()
            for consumer in range(len(fs.DQ256_PRODUCTS)):
                lo, hi = fs.dq256_columns(D, consumer)
                dq[b, rows, h, lo:hi] += ds @ k[b, keys, hk, lo:hi]
    return dq, delta


@pytest.mark.parametrize("D", [200, 256])
@pytest.mark.parametrize("T", [65, 100, 257])
@pytest.mark.parametrize("Hkv", [8, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_emulation_equals_the_plain_version(D, T, Hkv, causal):
    q, k, v, do = _qkv(1, T, 8, Hkv, D, seed=23)
    o, lse = fa.flash_attention_reference(q, k, v, causal)
    got, got_delta = emulate_dq256(q, k, v, o, do, lse, causal,
                                   torch.float32)
    want, want_delta = fa.flash_attention_bwd_dq_reference(
        q, k, v, o, do, lse, causal)
    torch.testing.assert_close(got, want, **EXACT)
    torch.testing.assert_close(got_delta, want_delta, **EXACT)


@pytest.mark.parametrize("T,Hkv,D,causal", [(128, 1, 256, True),
                                            (192, 2, 200, False),
                                            (128, 4, 256, False)])
def test_emulation_matches_the_pallas_kernels(T, Hkv, D, causal):
    """bfloat16 inputs (8 q heads), dS rounded as the kernel rounds it,
    the forward's o in the input type, against the JAX package's
    flash_attention through its Pallas kernels in interpret mode: its dq
    at 5e-2."""
    q, k, v, do = (x.bfloat16() for x in _qkv(1, T, 8, Hkv, D, seed=24))
    fn = lambda q, k, v: jax_flash(q, k, v, causal=causal,  # noqa: E731
                                   interpret=True)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v, do))
    _, vjp = jax.vjp(fn, jq, jk, jv)
    want = vjp(jdo)[0]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o, lse = fa.flash_attention_reference(qf, kf, vf, causal)
    o = o.bfloat16().float()
    got, _ = emulate_dq256(qf, kf, vf, o, dof, lse, causal, torch.bfloat16)
    np.testing.assert_allclose(got.bfloat16().float().numpy(),
                               np.asarray(want, np.float32),
                               **PALLAS_GRAD_TOL)

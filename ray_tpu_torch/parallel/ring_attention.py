"""Ring attention: exact attention over a sequence split around a ring of
ranks (port of ``ray_tpu/parallel/ring_attention.py``).

Q stays on its rank; K/V blocks travel ``r -> r+1`` around the ``seq``
process group, one ``batch_isend_irecv`` a hop (each rank's send and
receive go in one batch, so no pair of ranks waits on the other). Each
visited block goes through the flash-attention kernels of
``ops/flash_attention.py`` (on a CUDA tensor the hand-written forward
kernel, which returns the block's output and row log-sum-exp, lse), and
the blocks merge by lse in float32: the JAX package's online softmax over
``_block_attn``, with the kernel swapped in underneath as its docstring
allows. Under ``causal``, by global block index, the rank's own block
runs causal, blocks from earlier ranks run full and blocks from later
ranks are skipped (JAX computes them fully masked; they add zero).

The backward (:class:`RingAttention`) is one autograd Function around the
whole ring, not autograd through each hop: it saves q, the local k and
v, the merged o and the global lse, rotates K/V again with float32 dK/dV
accumulators travelling beside them back to their owner, and runs the dQ
and dK/dV kernels on each visited block with the *global* o and lse (so
``delta = rowsum(o * do)`` is the global one). dQ sums over blocks in
float32.

K/V may be GQA (fewer heads than q): the kernels take them unrepeated,
so the ring carries ``Hkv`` heads. The ring's blocks are equal: every
rank holds ``T/R`` positions.

Each rank's loop is a generator that yields the tensors it passes on and
is sent the ones its left neighbour passed. :func:`ring_attention_local`
drives it over a process group; :func:`ring_attention_simulated` drives
every position of a ring in one process, in lockstep, with a list
standing in for the transport.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_bwd_dkv,
                                               flash_attention_bwd_dq,
                                               flash_attention_forward,
                                               kernel_readable)

NEG_INF = -1e30


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Reference full attention, float32 scores and softmax.

    q, k, v: [B, T, H, D] with equal head counts (repeat K/V for GQA
    first). Returns [B, T, H, D] in q's dtype.
    """
    T, Tk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    if causal:
        mask = torch.ones(T, Tk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _block_causal(rank: int, src: int, causal: bool):
    """How rank ``rank``'s queries see the K/V block of rank ``src``: the
    kernel's causal flag, or None for a block wholly in the future."""
    if not causal:
        return False
    if src > rank:
        return None
    return src == rank


def _merge(o, lse, o_b, lse_b):
    """Fold one block's (o [B, T, H, D], lse [B, H, T]) into the float32
    running pair: each weighted by exp(its lse - the merged lse)."""
    if o is None:
        return o_b.float(), lse_b
    new = torch.logaddexp(lse, lse_b)
    w = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - new).transpose(1, 2)[..., None]
    return o.mul_(w).add_(o_b.float() * w_b), new


def _forward_steps(q, k, v, rank: int, size: int, causal: bool):
    """Rank ``rank``'s forward over a ring of ``size``: yields the K/V
    block it passes on, is sent the next; returns ``(o, lse)``, o in q's
    dtype and the global lse [B, H, T] float32."""
    o = lse = None
    kb, vb = k, v
    for i in range(size):
        c = _block_causal(rank, (rank - i) % size, causal)
        if c is not None:
            o, lse = _merge(o, lse, *flash_attention_forward(q, kb, vb, c))
        if i + 1 < size:
            kb, vb = yield kb, vb
    return o.to(q.dtype), lse.contiguous()


def _backward_steps(q, k, v, o, lse, do, rank: int, size: int,
                    causal: bool):
    """Rank ``rank``'s backward: the K/V blocks travel the ring again
    with their float32 dK/dV accumulators; the last hop takes the
    accumulators home. Returns ``(dq, dk, dv)`` for this rank's q, k, v."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i in range(size):
        c = _block_causal(rank, (rank - i) % size, causal)
        if c is not None:
            dq_b, delta = flash_attention_bwd_dq(q, kb, vb, o, do, lse, c)
            dk_b, dv_b = flash_attention_bwd_dkv(q, kb, vb, do, lse, delta,
                                                 c)
            dq += dq_b
            dkb += dk_b
            dvb += dv_b
        if i + 1 < size:
            kb, vb, dkb, dvb = yield kb, vb, dkb, dvb
        elif size > 1:
            dkb, dvb = yield dkb, dvb
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


def _step(steps, passed=None):
    """Resume a rank's loop: ``(True, what it passes on)`` or ``(False,
    its result)``."""
    try:
        return True, (next(steps) if passed is None else steps.send(passed))
    except StopIteration as stop:
        return False, stop.value


def _drive(steps, shift):
    """Run one rank's loop, each hop through ``shift``."""
    going, out = _step(steps)
    while going:
        going, out = _step(steps, shift(out))
    return out


def _drive_lockstep(ring):
    """Run every position's loop of a ring in one process: at each hop,
    position r is sent what position r-1 passed on."""
    states = [_step(steps) for steps in ring]
    while all(going for going, _ in states):
        passed = [out for _, out in states]
        states = [_step(steps, passed[r - 1])
                  for r, steps in enumerate(ring)]
    return [out for _, out in states]


def _p2p_shift(group):
    """One hop around ``group``: send each tensor to the next rank and
    receive the previous rank's, in one batch."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (rank + 1) % size)
    frm = dist.get_global_rank(group, (rank - 1) % size)

    def shift(tensors):
        sent = [t.contiguous() for t in tensors]
        got = [torch.empty_like(t) for t in sent]
        ops = [dist.P2POp(dist.isend, t, to, group) for t in sent] \
            + [dist.P2POp(dist.irecv, t, frm, group) for t in got]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(got)

    return shift


class RingAttention(torch.autograd.Function):
    """Differentiable ring attention over process group ``group``: the
    forward saves ``(q, k, v, o, lse)``, the backward rotates K/V and
    their dK/dV accumulators once more (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        o, lse = _drive(_forward_steps(q, k, v, rank, size, causal),
                        _p2p_shift(group))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        dq, dk, dv = _drive(
            _backward_steps(q, k, v, o, lse, kernel_readable(do), rank, size,
                            ctx.causal), _p2p_shift(group))
        return dq, dk, dv, None, None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, causal: bool = True) -> torch.Tensor:
    """This rank's part of ring attention over the process group
    ``group`` (the ``seq`` axis' group); every rank of it calls this.

    q: [B, T/R, Hq, D], this rank's slice of the sequence (rank r of R
    holds positions ``[r T/R, (r+1) T/R)``); k, v: [B, T/R, Hkv, D] with
    ``Hq % Hkv == 0``. Returns o [B, T/R, Hq, D] in q's dtype,
    differentiable through :class:`RingAttention`.
    """
    return RingAttention.apply(q, k, v, group, causal)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   causal: bool = True, seq_axis: str = "seq"
                   ) -> torch.Tensor:
    """Ring attention over ``mesh``'s ``seq_axis``, on this rank's shards.

    q, k, v are this rank's shards of the global [B, T, H, D] arrays under
    JAX's spec ``P(batch axes, seq_axis, head axis, None)``: the port has
    no global arrays, so the caller slices (batch and heads may be split
    any way: attention is per row and head). With no live ``seq_axis``
    it is whole attention on this rank, as JAX's fallback is: through
    :func:`~ray_tpu_torch.ops.flash_attention.flash_attention` (the
    kernels on a CUDA tensor, their plain versions on the CPU).
    """
    names = mesh.mesh_dim_names
    if seq_axis not in names or mesh.size(names.index(seq_axis)) == 1:
        return flash_attention(q, k, v, causal)
    return ring_attention_local(q, k, v, mesh.get_group(seq_axis), causal)


def ring_attention_simulated(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, ring: int, causal: bool = True,
                             do=None):
    """Every position of a ring of ``ring`` ranks in this process, on
    whole [B, T, H, D] inputs cut into ``ring`` equal blocks of the
    sequence: the per-rank loops of :func:`ring_attention_local` (the same
    kernel calls, merges and accumulation order), with a list in place of
    the process group. Returns ``(o, lse)``: o [B, T, Hq, D] and the
    merged lse [B, Hq, T] float32; with the output gradient ``do`` also
    ``(dq, dk, dv)``, from the backward's loops."""
    T = q.shape[1]
    if T % ring:
        raise ValueError(f"a ring of {ring} takes equal blocks; T={T} does "
                         f"not split")

    def blocks(x):
        return [b.contiguous() for b in x.chunk(ring, dim=1)]

    qs, ks, vs = blocks(q), blocks(k), blocks(v)
    outs = _drive_lockstep([_forward_steps(qs[r], ks[r], vs[r], r, ring,
                                           causal) for r in range(ring)])
    o = torch.cat([out[0] for out in outs], dim=1)
    lse = torch.cat([out[1] for out in outs], dim=2)
    if do is None:
        return o, lse
    dos = blocks(do)
    grads = _drive_lockstep([
        _backward_steps(qs[r], ks[r], vs[r], outs[r][0], outs[r][1], dos[r],
                        r, ring, causal) for r in range(ring)])
    return o, lse, tuple(torch.cat([g[i] for g in grads], dim=1)
                         for i in range(3))

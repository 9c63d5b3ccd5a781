"""Pipeline parallelism over the ``pipe`` axis (port of
``ray_tpu/parallel/pipeline.py``): the GPipe microbatch schedule on a
``torch.distributed`` process group.

The JAX package writes the schedule as ``lax.scan`` over ticks with
``ppermute`` moving activations to the next stage and lets autodiff
derive the backward pipeline. Here the whole schedule is one autograd
Function (:class:`_Pipeline`) whose backward runs the ticks in reverse,
so the transfers of both directions are explicit and every rank enters
them in the same tick order.

Schedule, on stage s of P (this rank's index in the group), over ``M +
P - 1`` ticks: at tick t the stage holds microbatch ``i = t - s`` when
``0 <= i < M`` (stage 0 takes it from the microbatches, a later stage
from what stage s-1 sent at tick t-1), applies ``stage_fn`` and sends
the result to stage s+1. On the other ticks (the bubble) it computes
nothing: JAX computes on garbage there and masks the result out, which
gives the same outputs and grads. A transfer happens where both ends
hold a valid microbatch, which both compute from (s, t). Stage P-1's
outputs are broadcast to every stage at the end (JAX's masked ``psum``),
so the loss code after the region is uniform SPMD; since every stage
then computes the same loss, only stage P-1's cotangent of the outputs
flows back: the loss counts once.

The backward takes the ticks in reverse: stage s receives the cotangent
of microbatch i's output from stage s+1 (stage P-1 takes it from the
outputs' grad), back-propagates through the graph its forward kept for
microbatch i, accumulating its params' grads, and sends the cotangent of
its input to stage s-1. Stage 0's input cotangents are the microbatches'
grads; the other stages return none.

Bubble fraction (P-1)/(M+P-1), as GPipe's; pick ``M >= 4 P``.
``stage_fn`` must map an activation tree (a tensor or nested dicts, lists
or tuples of them) to one of the same structure, shapes and dtypes (a
residual stream). Embedding and head live outside the region.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.collective.collective import _leaves


def _rebuild(tree, leaves):
    """``tree``'s structure with the leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _tree_map(fn, tree):
    return _rebuild(tree, iter([fn(x) for x in _leaves(tree)]))


def num_ticks(num_microbatches: int, num_stages: int) -> int:
    return num_microbatches + num_stages - 1


def split_microbatches(batch, num_microbatches: int):
    """[B, ...] tree -> [M, B/M, ...] tree (leading microbatch axis)."""

    def split(x):
        B = x.shape[0]
        if B % num_microbatches:
            raise ValueError(
                f"batch {B} not divisible by num_microbatches "
                f"{num_microbatches}")
        return x.reshape((num_microbatches, B // num_microbatches)
                         + tuple(x.shape[1:]))

    return _tree_map(split, batch)


def merge_microbatches(mb):
    """Inverse of :func:`split_microbatches`."""
    return _tree_map(
        lambda x: x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])),
        mb)


def stage_slice_len(total_layers: int, num_stages: int) -> int:
    if total_layers % num_stages:
        raise ValueError(
            f"{total_layers} layers not divisible into {num_stages} stages")
    return total_layers // num_stages


def _exchange(group, send_to: Optional[int], sends, recv_from: Optional[int],
              like) -> Optional[List[torch.Tensor]]:
    """Send ``sends`` to group rank ``send_to`` and receive tensors shaped
    as ``like`` from group rank ``recv_from``, in one batch; None for a
    side with no peer. Returns the received tensors (or None)."""
    ops, got = [], None
    if send_to is not None:
        peer = dist.get_global_rank(group, send_to)
        sends = [t.contiguous() for t in sends]
        ops += [dist.P2POp(dist.isend, t, peer, group) for t in sends]
    if recv_from is not None:
        peer = dist.get_global_rank(group, recv_from)
        got = [torch.empty_like(t) for t in like]
        ops += [dist.P2POp(dist.irecv, t, peer, group) for t in got]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of :func:`pipelined_apply` (see the module
    docstring). Inputs: the microbatch leaves ``[M, mb, ...]``, then the
    stage's param leaves; outputs: the output leaves ``[M, mb, ...]``,
    the same on every stage."""

    @staticmethod
    def forward(ctx, stage_fn, params_tree, mb_tree, group, n_mb, *leaves):
        mbs, params = leaves[:n_mb], leaves[n_mb:]
        P, s = dist.get_world_size(group), dist.get_rank(group)
        M = mbs[0].shape[0]
        # the stage's graphs end in these aliases; their grads are the
        # params' grads
        alias = [p.detach().requires_grad_(p.requires_grad) for p in params]
        ptree = _rebuild(params_tree, iter(alias))
        like = [x[0] for x in mbs]
        # every rank of the group joins one collective before the first
        # transfer, which only stages 0 and 1 take part in: NCCL sets a
        # group's communicator up on its first collective, with all ranks
        dist.all_reduce(torch.zeros(1, device=like[0].device), group=group)
        kept, outs, held = {}, [], None
        for t in range(num_ticks(M, P)):
            i = t - s
            ys = None
            if 0 <= i < M:
                xs = [x[i] for x in mbs] if s == 0 else held
                xs = [x.detach().requires_grad_(x.is_floating_point())
                      for x in xs]
                with torch.enable_grad():
                    ys = _leaves(stage_fn(ptree, _rebuild(mb_tree,
                                                          iter(xs))))
                kept[i] = (xs, ys)
                if s == P - 1:
                    outs.append([y.detach() for y in ys])
            held = _exchange(
                group, s + 1 if s < P - 1 and ys is not None else None, ys,
                s - 1 if s > 0 and 0 <= t + 1 - s < M else None, like)
        if s == P - 1:
            result = [torch.stack(o) for o in zip(*outs)]
        else:
            result = [torch.empty_like(x) for x in mbs]
        last = dist.get_global_rank(group, P - 1)
        for r in result:
            dist.broadcast(r, src=last, group=group)
        ctx.stage = (group, kept, alias, like, M)
        ctx.mark_non_differentiable(
            *(r for r in result if not r.is_floating_point()))
        return tuple(result)

    @staticmethod
    def backward(ctx, *grads):
        group, kept, alias, like, M = ctx.stage
        P, s = dist.get_world_size(group), dist.get_rank(group)
        floats = [x.is_floating_point() for x in like]
        flike = [x for x, f in zip(like, floats) if f]
        in_grads = [torch.zeros((M,) + tuple(x.shape), dtype=x.dtype,
                                device=x.device) if f and s == 0 else None
                    for x, f in zip(like, floats)]
        held = None
        for t in reversed(range(num_ticks(M, P))):
            i = t - s
            sent = None
            if 0 <= i < M:
                xs, ys = kept.pop(i)
                if s == P - 1:
                    cts = [g[i] if g is not None else None for g in grads]
                else:
                    got = iter(held)
                    cts = [next(got) if f else None for f in floats]
                pairs = [(y, c) for y, c in zip(ys, cts)
                         if c is not None and y.requires_grad]
                if pairs:
                    torch.autograd.backward([y for y, _ in pairs],
                                            [c for _, c in pairs])
                sent = [x.grad if x.grad is not None else torch.zeros_like(x)
                        for x, f in zip(xs, floats) if f]
                if s == 0:
                    got = iter(sent)
                    for g, f in zip(in_grads, floats):
                        if f:
                            g[i] = next(got)
            held = _exchange(
                group, s - 1 if s > 0 and sent is not None else None, sent,
                s + 1 if s < P - 1 and 0 <= t - 1 - s < M else None, flike)
        ctx.stage = None
        return (None, None, None, None, None, *in_grads,
                *(a.grad for a in alias))


def pipelined_apply(stage_fn: Callable[[Any, Any], Any], stage_params,
                    microbatches, group):
    """The GPipe schedule on this rank's stage of the ``pipe`` process
    group ``group``; every rank of it calls this.

    ``stage_fn(stage_params, x) -> y`` with y matching x's structure and
    shapes. ``stage_params``: this rank's stage (a tensor or a tree of
    them). ``microbatches``: ``[M, mb, ...]`` tree, identical on every
    stage (the pipe axis must not shard the batch). Returns the
    ``[M, mb, ...]`` outputs, the same on every stage, differentiable in
    the microbatches (through stage 0) and the stage params."""
    mb_leaves = _leaves(microbatches)
    out = _Pipeline.apply(stage_fn, stage_params, microbatches, group,
                          len(mb_leaves), *mb_leaves, *_leaves(stage_params))
    return _rebuild(microbatches, iter(out))


def make_pipelined_fn(stage_fn, mesh, num_microbatches: int, *,
                      axis_name: str = "pipe"):
    """``fn(stage_params, batch) -> out``: :func:`pipelined_apply` over
    ``mesh``'s ``axis_name`` group on a ``[B, ...]`` batch tree, split
    into ``num_microbatches`` and merged back. ``stage_params`` is this
    rank's stage and ``batch`` its rows (sharded over the batch axes, not
    over ``axis_name``), as the body of JAX's ``shard_map`` sees them: the
    port holds local shards, so the caller places them."""
    group = mesh.get_group(axis_name)

    def fn(stage_params, batch):
        mb = split_microbatches(batch, num_microbatches)
        return merge_microbatches(
            pipelined_apply(stage_fn, stage_params, mb, group))

    return fn

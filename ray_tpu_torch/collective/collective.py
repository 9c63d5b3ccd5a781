"""Tree collectives over the axes of a DeviceMesh (port of the in-program
half of ``ray_tpu/collective/collective.py``: ``psum_tree`` and
``pmean_tree``), the differentiable ``all_to_all`` of expert parallelism,
and the one-dim all-gather and reduce-scatter (each the other's
transpose) of the sharded steps and the MoE FFN's ``seq`` exchange.

Each leaf is all-reduced over the process group of each named mesh axis
in turn, in place. An axis of size 1 is the identity and costs nothing,
as the JAX package's collectives fold away on one device.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axis_names: Axes):
    return (axis_names,) if isinstance(axis_names, str) \
        else tuple(axis_names)


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> List[Any]:
    """The leaves of nested dicts, lists and tuples, in order; a tuple
    subclass (a PartitionSpec) is a leaf."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if type(tree) in (list, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def psum_tree(tree, mesh, axis_names: Axes):
    """Sum every tensor leaf of ``tree`` (a tensor or a nested dict of
    them) over ``axis_names`` of ``mesh``, in place; returns ``tree``."""
    live = [a for a in _axes(axis_names) if _size(mesh, a) > 1]

    def red(x: torch.Tensor):
        for ax in live:
            dist.all_reduce(x, group=mesh.get_group(ax))
        return x

    return _map(red, tree)


def pmean_tree(tree, mesh, axis_names: Axes):
    """Mean of every leaf over ``axis_names`` of ``mesh``, in place — the
    gradient reduction of a data-parallel train step."""
    denom = 1
    for ax in _axes(axis_names):
        denom *= _size(mesh, ax)
    tree = psum_tree(tree, mesh, axis_names)
    if denom == 1:
        return tree
    return _map(lambda x: x.div_(denom), tree)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` over dim 0 in equal chunks. Its inverse
    (each chunk sent back to the rank it came from) is the same exchange,
    so that is the backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _exchange(ct, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all over the process ``group`` (n ranks):
    dim 0 of ``x`` is cut into n equal chunks, chunk j is sent to rank j,
    and the chunks received are stacked in rank order. The backward sends
    each gradient chunk back where its value came from. NCCL on the card,
    gloo on the CPU."""
    return _AllToAll.apply(x, group)


# the names newer torch releases give all_gather_into_tensor and
# reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class _Pending:
    """An all-gather in flight: ``wait()`` returns the gathered leaf."""

    def __init__(self, work, src, out, dim):
        # src is kept until the gather is waited for: the collective
        # reads it after the call returns
        self.work, self.src, self.out, self.dim = work, src, out, dim

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return self.out.movedim(0, self.dim)


def _all_gather_dim(x, dim: int, group, async_op: bool = False):
    """Concatenate every rank's ``x`` of ``group`` along ``dim``, in group
    order. NCCL and gloo gather along dim 0, so any other dim is moved to
    the front and back (the result is then a strided view)."""
    src = x.detach().movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    work = _all_gather(out, src, group=group, async_op=async_op)
    pending = _Pending(work, src, out, dim)
    return pending if async_op else pending.wait()


def _reduce_scatter_dim(g, dim: int, group) -> torch.Tensor:
    """Sum ``g`` over ``group`` and keep this rank's slice along ``dim``:
    the transpose of :func:`_all_gather_dim`."""
    src = g.movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _reduce_scatter(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    """All-gather along a dim forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter_dim(ct, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along a dim forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_gather_dim(ct, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable all-gather over the process ``group``: every rank's
    ``x`` concatenated along ``dim`` in rank order. The backward sums the
    cotangents over the group and keeps this rank's slice (a
    reduce-scatter)."""
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable reduce-scatter over the process ``group`` (n ranks):
    ``x`` summed over the group, and rank j keeps slice j of n equal
    slices along ``dim`` (n must divide it). The backward all-gathers the
    cotangents."""
    return _ReduceScatter.apply(x, dim, group)

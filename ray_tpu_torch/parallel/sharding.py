"""Logical-axis sharding rules and per-rank placement (port of
``ray_tpu/parallel/sharding.py``).

Arrays carry *logical* axis names (batch, seq, embed, heads, mlp, vocab,
...); rules map logical axes to mesh axes. Without GSPMD, a sharded array
is simply each rank's slice of it: :func:`shard_device_put` cuts that
slice out of a host array. Optimizer state needs no placement code:
torch's AdamW makes its moments per parameter tensor, so they follow
their parameter's shard.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import PartitionSpec, shard_index

# logical axis -> mesh axis (or tuple of axes). None = replicated.
DEFAULT_RULES: Tuple[Tuple[str, object], ...] = (
    ("batch", ("slice", "data", "fsdp")),
    ("seq", "seq"),                # activation sequence axis (ring attention)
    ("embed", "fsdp"),             # param fsdp shard axis
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
    ("kv", None),
    ("layers", None),
    ("stage", "pipe"),
)


def _live_axes(axes, names) -> Optional[object]:
    """``axes`` (a mesh axis, a tuple of them, or None) without the axes
    that ``names`` lacks; None when none is left."""
    if axes is None:
        return None
    if isinstance(axes, (tuple, list)):
        present = tuple(a for a in axes if a in names)
        return present if present else None
    return axes if axes in names else None


def _mesh_axes_for(logical: Optional[str], rules, mesh) -> Optional[object]:
    if logical is None:
        return None
    for name, axes in rules:
        if name == logical:
            return _live_axes(axes, mesh.mesh_dim_names)
    return None


def logical_spec(logical_axes: Sequence[Optional[str]], mesh, rules=None):
    """PartitionSpec for an array annotated with logical axis names."""
    rules = rules or DEFAULT_RULES
    return PartitionSpec(*(_mesh_axes_for(ax, rules, mesh)
                           for ax in logical_axes))


def shard_device_put(x, mesh, spec, device=None,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's shard of the host array ``x`` (numpy or tensor) under
    ``spec``, as a new contiguous tensor on ``device`` that shares no
    memory with ``x`` (``dtype`` casts a floating-point array). Every
    dimension ``spec`` names an axis for is cut into equal slices; a
    dimension that does not divide raises."""
    shape = tuple(x.shape)
    idx = []
    for dim, axes in enumerate(spec):
        if axes is None:
            idx.append(slice(None))
            continue
        index, count = shard_index(mesh, axes)
        n = shape[dim]
        if n % count:
            raise ValueError(f"dimension {dim} of size {n} does not split "
                             f"over {count} shards of {axes}")
        idx.append(slice(index * (n // count), (index + 1) * (n // count)))
    idx = tuple(idx)
    if torch.is_tensor(x):
        t = x.detach()[idx].to(device, copy=True)
    else:
        t = torch.tensor(np.asarray(x)[idx], device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.contiguous()


def param_residency_bytes(params, specs, mesh, mode: str = "upfront",
                          scan_key: str = "layers", window: int = 2):
    """Analytic peak per-device LIVE param bytes inside the sharded
    train step (train/spmd.py) — the resident shards plus the
    fsdp-gathered working copies the gather schedule keeps alive.

    ``"upfront"`` gathers the whole tree before the first layer, so
    every leaf's fsdp-full copy is simultaneously live. ``"streamed"``
    keeps the stacked layers (the top-level ``scan_key`` subtree, leaves
    shaped [L, ...]) sharded and holds at most ``window`` fsdp-full
    layers (current + prefetched next); non-stacked leaves still gather
    up front. Tensor- and expert-sharded dims stay sharded under both
    schedules (the port's step never gathers them).
    ``params`` is a nested dict of tensors (``meta`` tensors will do) and
    ``specs`` mirrors it. Returns ``{"mode", "shard_bytes",
    "gathered_bytes", "peak_bytes"}`` — analytic, so it is the same on
    every device.
    """
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def div(spec, only=None):
        d = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is None or a not in sizes:
                    continue
                if only is None or a in only:
                    d *= sizes[a]
        return d

    shard_bytes = 0
    gathered_bytes = 0

    def walk(tree, spec_tree, key0):
        nonlocal shard_bytes, gathered_bytes
        for key, leaf in tree.items():
            spec = spec_tree[key]
            top = key if key0 is None else key0
            if isinstance(leaf, dict):
                walk(leaf, spec, top)
                continue
            b = int(np.prod(tuple(leaf.shape), dtype=np.int64)) \
                * leaf.element_size()
            shard_bytes += b // div(spec)
            # fsdp-gathered working copy: tensor and expert dims stay
            # sharded
            g = b // div(spec, only=("tensor", "expert"))
            if mode == "streamed" and top == scan_key:
                L = max(1, int(leaf.shape[0]))
                gathered_bytes += min(window, L) * (g // L)
            else:
                gathered_bytes += g

    walk(params, specs, None)
    return {"mode": mode, "shard_bytes": int(shard_bytes),
            "gathered_bytes": int(gathered_bytes),
            "peak_bytes": int(shard_bytes + gathered_bytes)}

"""Device meshes for data, fsdp and tensor parallelism (port of
``ray_tpu/parallel/mesh.py``) on a ``torch.distributed`` DeviceMesh.

A mesh names the parallelism axes and lays the process group's ranks out
over them: one process per card, NCCL on CUDA, gloo on the CPU. Axis
order follows the JAX package's, bandwidth-hungry axes last, so the
``tensor`` axis joins neighbouring ranks. The process group must be
initialised first (``train/launch.py`` does it); every rank of it is in
the mesh.

Partition specs are tuples with one entry per array dimension: a mesh
axis name, a tuple of names, or None (replicated), as JAX's
``PartitionSpec``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# canonical axis order: DCN-most-friendly first, bandwidth-hungry last
AXIS_ORDER = ("slice", "pipe", "data", "fsdp", "expert", "seq", "tensor")


class PartitionSpec(tuple):
    """How an array shards over a mesh: ``PartitionSpec("fsdp", None)``
    splits dimension 0 over the ``fsdp`` axis and replicates dimension 1."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass
class MeshConfig:
    """Sizes of each parallelism axis; -1 infers from the device count.

    data    : pure data parallel (params replicated)
    fsdp    : data parallel with params sharded (ZeRO-3 / FSDP analog)
    seq     : sequence/context parallelism (ring attention axis)
    tensor  : tensor (megatron-style) model parallelism
    expert  : MoE expert parallelism
    pipe    : pipeline stages
    slice   : multi-slice (DCN) replicas
    """

    data: int = 1
    fsdp: int = -1
    seq: int = 1
    tensor: int = 1
    expert: int = 1
    pipe: int = 1
    slice: int = 1

    def resolved(self, n_devices: int) -> Dict[str, int]:
        sizes = {"slice": self.slice, "pipe": self.pipe, "data": self.data,
                 "fsdp": self.fsdp, "expert": self.expert, "seq": self.seq,
                 "tensor": self.tensor}
        unknown = [k for k, v in sizes.items() if v == -1]
        known = math.prod(v for v in sizes.values() if v != -1)
        if n_devices % known:
            raise ValueError(
                f"mesh {sizes} incompatible with {n_devices} devices")
        rest = n_devices // known
        if not unknown:
            # explicit sizes may use a subset of local devices
            if known > n_devices:
                raise ValueError(
                    f"mesh size {known} > device count {n_devices}")
        elif len(unknown) == 1:
            sizes[unknown[0]] = rest
        else:
            # fill the first unknown with the remainder, others with 1
            sizes[unknown[0]] = rest
            for k in unknown[1:]:
                sizes[k] = 1
        return sizes


def make_mesh(config: Optional[MeshConfig] = None,
              axis_sizes: Optional[Dict[str, int]] = None,
              world_size: Optional[int] = None, device=None):
    """A ``DeviceMesh`` from a MeshConfig or explicit ``{axis: size}``,
    over the process group's ranks, on the device type of
    ``resolve_device(device)`` (``cuda`` unless asked for the CPU). Only
    axes larger than 1 are kept; a mesh of size 1 is ``("data",)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tpu_torch import resolve_device

    dev = resolve_device(device)
    world = dist.get_world_size() if world_size is None else int(world_size)
    if axis_sizes is None:
        axis_sizes = (config or MeshConfig()).resolved(world)
    names = tuple(a for a in AXIS_ORDER if axis_sizes.get(a, 1) > 1)
    if not names:
        names = ("data",)
        axis_sizes = {"data": 1}
    shape = tuple(axis_sizes[a] for a in names)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh of {n} devices on a process group of "
                         f"{world}: every rank must be in the mesh")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes a batch dimension shards over."""
    return tuple(a for a in ("slice", "data", "fsdp")
                 if a in mesh.mesh_dim_names)


def shard_index(mesh, axes) -> Tuple[int, int]:
    """(index, count) of this rank's shard of a dimension split over
    ``axes`` (a name or a tuple of names, the first the major one)."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    index, count = 0, 1
    for a in axes:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        index = index * n + mesh.get_local_rank(a)
        count *= n
    return index, count


def batch_sharding(mesh) -> Callable:
    """The function that gives this rank its rows of a host batch
    ``[B, ...]``: the batch splits over the data axes, and ranks that
    differ only on other axes (``tensor``) get the same rows."""
    axes = data_axes(mesh)

    def rows(batch):
        if not axes:
            return batch
        index, count = shard_index(mesh, axes)
        n = batch.shape[0]
        if n % count:
            raise ValueError(f"batch of {n} rows does not split over "
                             f"{count} batch shards {axes}")
        per = n // count
        return batch[index * per:(index + 1) * per]

    return rows

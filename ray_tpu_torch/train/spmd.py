"""SPMD sharded training: regex partition rules and a sharded train step
(port of ``ray_tpu/train/spmd.py``) on a ``torch.distributed`` DeviceMesh.

One process per card (NCCL) or per CPU rank (gloo) runs the same program
on its own shards; the collectives are written out:

- **Regex partition rules** (``match_partition_rules``) map '/'-joined
  param-tree paths to ``PartitionSpec``s: one table names how every
  weight shards, and applies to a checkpoint's tree as well as to a fresh
  init.
- **Shard/gather fns** (``make_shard_and_gather_fns``): ``shard`` cuts
  this rank's slice out of a host (or replicated) leaf, ``gather``
  all-gathers a sharded leaf back to the full array on every rank.
  shard → gather is byte-identical per leaf (tested).
- **The sharded train step** (``make_spmd_train_step``). Each rank holds
  its shard of every leaf; fsdp-sharded leaves are all-gathered where
  they are used and their grads reduce-scattered straight back to
  shards, so AdamW runs on the shards and its moments stay sharded
  (ZeRO-3). Two gather schedules for the stacked ``[L, ...]`` layers:
  ``"upfront"`` all-gathers every leaf before the first layer;
  ``"streamed"`` (default) gathers one layer at a time, starting layer
  *i+1*'s all-gather (``async_op=True``) before layer *i*'s compute, and
  its backward re-gathers the layer from its shards, recomputes it and
  reduce-scatters the layer's grads, so at most two fsdp-full layers are
  live. A live ``tensor`` axis is handled Megatron-style: heads, MLP and
  vocab stay sharded through compute, with the exact-grad
  ``tp_psum_pair`` collectives at block boundaries and a vocab-parallel
  embedding and cross-entropy (``models/llama.py``).

- **The mesh step** (``make_mesh_train_step``, the port of the JAX
  package's GSPMD ``make_train_step(cfg, mesh)``): the same step with a
  live ``seq`` axis as well. Each ``seq`` rank keeps its block of the
  sequence through every layer, attention is the ring of
  ``parallel/ring_attention.py``, and loss and grads average over
  ``seq`` too.
- **The MoE step** (``make_moe_train_step``, the port of the JAX
  package's ``models/moe_llama.py:make_train_step(cfg, mesh)``): the
  same step for the MoE decoder of ``models/moe_llama.py``, with live
  ``expert``, ``tensor`` and ``seq`` axes. Each ``expert`` rank keeps
  ``E/ep`` experts and its share of the rows; the MoE FFN sends the
  dispatched slots to their experts' ranks and back by all-to-all
  (``ops/moe.py``), and loss and grads average over ``expert`` too.
  ``tensor`` splits each expert's mlp dim as the dense MLP's; ``seq``
  splits each row, with the whole row's routing.

Observation, as in the JAX package: ``make_spmd_train_step``'s functions
run through the program observatory (``util/program_observatory.py``) as
``spmd.init_state`` / ``spmd.train_step``, ``make_mesh_train_step``'s as
``llama.gspmd_init`` / ``llama.gspmd_train_step`` (JAX's GSPMD step), and
the placement fns of :func:`make_shard_and_gather_fns` as
``spmd.shard_put`` / ``spmd.gather_replicate``; the MoE step is not
observed, as in JAX. The SPMD step-phase spans are registered here
(``spmd.compute`` measures the train steps in the program report).

The steps share one body; what differs between the two decoders (the
param shapes and partition rules, the init, the layer, whether a layer
returns an aux loss) is a :class:`_Decoder` record. On one device the
mesh is ``("data",)`` of size 1 and every collective is the identity.
``make_spmd_train_step`` takes the batch axes (``slice``/``data``),
``fsdp`` and ``tensor`` and refuses a live ``seq`` or ``pipe`` axis,
naming ``make_mesh_train_step`` and
``models/llama.py:make_pipeline_train_step``, which take them, as the
JAX package's does; a live ``expert`` axis it refuses naming the MoE
step.
"""

from __future__ import annotations

import difflib
import re
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import PARAM_DTYPE, resolve_device
from ray_tpu_torch.collective.collective import (_all_gather_dim, _leaves,
                                                 _map, _Pending,
                                                 _reduce_scatter_dim,
                                                 all_gather, pmean_tree,
                                                 psum_tree)
from ray_tpu_torch.models import moe_llama
from ray_tpu_torch.models.llama import (LlamaConfig, _check_mesh,
                                        _init_model, _make_optimizer,
                                        _plain_chunk_nll, _positions,
                                        _pp_layer, _unbind_layers,
                                        chunked_nll_mean, param_shapes,
                                        tp_psum_pair, vp_chunk_nll,
                                        vp_embed)
from ray_tpu_torch.ops.layers import rms_norm
from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, P, PartitionSpec,
                                         axis_sizes, data_axes, make_mesh)
from ray_tpu_torch.parallel.sharding import _live_axes, shard_device_put
from ray_tpu_torch.util import flight_recorder as _fr
from ray_tpu_torch.util.program_observatory import observe_program

# the SPMD step phases. A runtime train loop closes each after a sync and
# only with the recorder on; the first call of a step is its own phase
_sp_ingest = _fr.register_span("spmd.ingest_wait")
_sp_compute = _fr.register_span("spmd.compute")
_sp_compile = _fr.register_span("spmd.compile")
# one-shot probe timings of the step's collective seams (see
# make_collective_probes)
_sp_gather = _fr.register_span("spmd.gather")
_sp_scatter = _fr.register_span("spmd.scatter")

__all__ = [
    "match_partition_rules",
    "make_shard_and_gather_fns",
    "llama_partition_rules",
    "moe_partition_rules",
    "spmd_param_specs",
    "make_spmd_train_step",
    "make_mesh_train_step",
    "make_moe_train_step",
    "make_collective_probes",
    "global_grad_norm",
    "parse_mesh_spec",
    "build_train_mesh",
    "tree_paths",
]

# --------------------------------------------------------------------------- #
# Nested-dict trees
# --------------------------------------------------------------------------- #


def _nest(flat: Dict[str, Any], sep: str = "/") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, name = path.split(sep)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


# --------------------------------------------------------------------------- #
# Regex partition rules
# --------------------------------------------------------------------------- #


def tree_paths(tree, sep: str = "/", prefix: str = ""):
    """Mirror ``tree`` (nested dicts) with '/'-joined key-path strings at
    the leaves."""
    return {k: (tree_paths(v, sep, f"{prefix}{k}{sep}")
                if isinstance(v, dict) else f"{prefix}{k}")
            for k, v in tree.items()}


def match_partition_rules(rules, params, sep: str = "/"):
    """Tree of PartitionSpec from ``rules``: ordered (regex, spec) pairs
    matched with ``re.search`` against each leaf's '/'-joined path.
    Scalars and size-1 leaves never partition. A leaf no rule matches is
    an error — silent replication of a large weight is the classic way
    to quietly lose FSDP memory savings."""

    def spec_for(name, leaf):
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        patterns = [r for r, _ in rules]
        near = difflib.get_close_matches(name, patterns, n=3, cutoff=0.0)
        raise ValueError(
            f"no partition rule matches param path {name!r} "
            f"(shape {shape}); nearest rule patterns: "
            + ", ".join(repr(p) for p in near)
            + " — add a (regex, PartitionSpec) entry for it")

    return _map(spec_for, tree_paths(params, sep), params)


def llama_partition_rules():
    """Partition rules for the llama param tree (models/llama.py).

    Mirrors ``parallel/sharding.DEFAULT_RULES``'s logical-axis mapping
    (embed→fsdp, heads/kv_heads/mlp/vocab→tensor) but keyed by name, so
    the table reads like the model: every projection shards its embed
    dim over ``fsdp`` and its heads/mlp dim over ``tensor``; the stacked
    ('layers') dim never shards."""
    return (
        # embedding: (vocab, embed)
        (r"(^|/)embedding$", P("tensor", "fsdp")),
        # q/k/v and gate/up: (L, embed, heads*hd | mlp)
        (r"layers/w(q|k|v)$", P(None, "fsdp", "tensor")),
        (r"layers/w_(gate|up)$", P(None, "fsdp", "tensor")),
        # output projections: (L, heads*hd | mlp, embed)
        (r"layers/(wo|w_down)$", P(None, "tensor", "fsdp")),
        # norm scales: replicated
        (r"norm$", P()),
        # lm_head: (embed, vocab)
        (r"(^|/)lm_head$", P("fsdp", "tensor")),
    )


def moe_partition_rules():
    """Partition rules for the MoE decoder's param tree
    (models/moe_llama.py), mirroring its ``param_logical_axes`` through
    the JAX package's ``DEFAULT_RULES``: embed dims over ``fsdp``, heads,
    kv_heads, each expert's mlp dim and the vocab over ``tensor``, the
    experts' dim over ``expert``; the router's expert dim is never
    split."""
    return (
        (r"(^|/)embedding$", P("tensor", "fsdp")),
        (r"layers/w(q|k|v)$", P(None, "fsdp", "tensor")),
        (r"layers/wo$", P(None, "tensor", "fsdp")),
        (r"layers/router$", P(None, "fsdp", None)),
        # experts: (L, E, embed, mlp) and (L, E, mlp, embed)
        (r"layers/w_(gate|up)$", P(None, "expert", "fsdp", "tensor")),
        (r"layers/w_down$", P(None, "expert", "tensor", "fsdp")),
        (r"norm$", P()),
        (r"(^|/)lm_head$", P("fsdp", "tensor")),
    )


@dataclass(frozen=True)
class _Decoder:
    """What the sharded step needs of a decoder: its param shapes, its
    default partition rules, its init (a seed or a JAX tree as numpy ->
    a module with ``tree()``), its layer ``(cfg, x, p, positions,
    groups) -> x`` or ``(x, aux)`` on local shards, and the axes its
    step refuses, each with the reason."""

    shapes: Callable
    rules: Callable
    init_model: Callable
    layer: Callable
    refused: Dict[str, str]


@dataclass(frozen=True)
class _Groups:
    """A layer's collectives: the tensor axis' ``(f, g)`` pair, the seq
    and expert process groups, and the aux loss' ``frac`` mean over the
    ranks that split the batch (None where an axis is not live)."""

    collectives: Any = None
    seq_group: Any = None
    expert_group: Any = None
    frac_mean: Optional[Callable] = None


_OTHER_STEPS = "use make_mesh_train_step or make_pipeline_train_step " \
    "for that layout"
_LLAMA = _Decoder(
    shapes=param_shapes, rules=llama_partition_rules,
    init_model=_init_model,
    layer=lambda cfg, x, p, pos, g: _pp_layer(cfg, x, p, pos, g.collectives,
                                              g.seq_group),
    refused={"seq": _OTHER_STEPS, "pipe": _OTHER_STEPS,
             "expert": "the expert axis is the MoE decoder's "
                       "(make_moe_train_step)"})
_MOE = _Decoder(
    shapes=moe_llama.param_shapes, rules=moe_partition_rules,
    init_model=moe_llama.init_model,
    layer=lambda cfg, x, p, pos, g: moe_llama._layer(
        cfg, x, p, pos, g.expert_group, g.frac_mean, g.collectives,
        g.seq_group),
    refused={"pipe": "the JAX package's MoE step has no pipeline schedule "
                     "(its params carry no stage axis), so there is "
                     "none to port"})


def _decoder(cfg) -> _Decoder:
    return _MOE if isinstance(cfg, moe_llama.MoEConfig) else _LLAMA


def _restrict_spec(spec, mesh):
    """Drop mesh axes the spec names that this mesh does not have (or
    has at size 1 — ``make_mesh`` omits size-1 axes), so one rule table
    serves every layout."""
    return PartitionSpec(*(_live_axes(a, mesh.mesh_dim_names)
                           for a in spec))


def _spec_axes(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


# --------------------------------------------------------------------------- #
# Collectives on one dimension of a leaf
# --------------------------------------------------------------------------- #


def _gather_dims(spec, mesh, skip=()) -> Tuple[Tuple[int, Any], ...]:
    """(dim, process group) pairs that gather a leaf sharded by ``spec``,
    in gather order, leaving out the axes in ``skip``. A dim split over
    several axes gathers the minor axis first."""
    out = []
    for dim, ax in enumerate(spec):
        for a in reversed(_spec_axes(ax)):
            if a not in skip:
                out.append((dim, mesh.get_group(a)))
    return tuple(out)


def _gather(x, dims):
    for dim, group in dims:
        x = _all_gather_dim(x, dim, group)
    return x


def _scatter(g, dims):
    for dim, group in reversed(dims):
        g = _reduce_scatter_dim(g, dim, group)
    return g


def _gather_leaf(x, dims):
    """The gathered leaf, differentiable (each dim's all-gather backs into
    a reduce-scatter); ``x`` itself with no dims."""
    for dim, group in dims:
        x = all_gather(x, dim, group)
    return x


# --------------------------------------------------------------------------- #
# Shard / gather fns and specs
# --------------------------------------------------------------------------- #


def make_shard_and_gather_fns(partition_specs, mesh, dtype_specs=None,
                              device=None):
    """Per-leaf placement fns from a PartitionSpec tree.

    ``shard_fns[leaf](host_array)`` is this rank's slice of the leaf on
    ``device`` (float leaves cast to ``dtype_specs`` if given);
    ``gather_fns[leaf](shard)`` all-gathers every sharded dim and returns
    the full array on every rank (a collective: every rank calls it)."""
    dev = resolve_device(device)
    # one observed fn per distinct spec, as JAX keeps one jitted callable
    # per distinct sharding
    observed: Dict[Any, Callable] = {}

    def make_shard(spec):
        spec = _restrict_spec(spec, mesh)
        key = ("shard", spec)
        if key not in observed:
            observed[key] = observe_program(
                lambda x: shard_device_put(x, mesh, spec, dev, dtype_specs),
                "spmd.shard_put")
        return observed[key]

    def make_gather(spec):
        dims = _gather_dims(_restrict_spec(spec, mesh), mesh)
        key = ("gather", dims)
        if key not in observed:
            observed[key] = observe_program(
                lambda x: _gather(x, dims).contiguous(),
                "spmd.gather_replicate")
        return observed[key]

    return _map(make_shard, partition_specs), _map(make_gather,
                                                   partition_specs)


def spmd_param_specs(cfg: LlamaConfig, mesh, rules=None):
    """(abstract param tree, PartitionSpec tree) for ``cfg`` (a Llama or
    an MoE config) on ``mesh`` — the rule table (the decoder's own by
    default) matched and restricted to the mesh's live axes. The abstract
    tree holds ``meta`` tensors of the params' shapes."""
    model = _decoder(cfg)
    sample = _nest({path: torch.empty(shape, dtype=PARAM_DTYPE,
                                      device="meta")
                    for path, shape in model.shapes(cfg).items()})
    specs = _map(lambda s: _restrict_spec(s, mesh),
                 match_partition_rules(rules or model.rules(), sample))
    return sample, specs


def global_grad_norm(params, specs, mesh) -> torch.Tensor:
    """The global L2 norm of the grads of a sharded param tree: the local
    squared sums all-reduced over the mesh, each leaf's shared by the
    ranks that hold the same shard of it counted once."""
    sizes = axis_sizes(mesh)
    world = int(np.prod(list(sizes.values())))
    total = None
    for p, spec in zip(_leaves(params), _leaves(specs)):
        shards = 1
        for ax in spec:
            for a in _spec_axes(ax):
                shards *= sizes[a]
        sq = p.grad.float().pow(2).sum() * (shards / world)
        total = sq if total is None else total + sq
    if world > 1:
        dist.all_reduce(total)
    return total.sqrt()


# --------------------------------------------------------------------------- #
# The sharded train step (manual DP + fsdp ZeRO-3 + tensor)
# --------------------------------------------------------------------------- #


class GatherStats:
    """A gather schedule (``schedule``, the one that runs) and its
    fsdp-full layers: how many were gathered, how many are live now, and
    the most live at once. A gathered layer is live while the memory of
    any of its gathered leaves is: a weak reference on each leaf's
    storage, so whatever keeps that memory (a view, a detached alias, a
    tensor saved for backward) keeps the layer counted."""

    def __init__(self, schedule: str):
        self.schedule = schedule
        self.gathers = 0
        self.live = 0
        self.peak = 0

    def track(self, gathered: List[torch.Tensor], count: int = 1) -> None:
        """Count ``count`` layers live until the storage of every tensor
        in ``gathered`` is freed."""
        if not gathered:
            return
        self.gathers += count
        self.live += count
        self.peak = max(self.peak, self.live)
        left = [len(gathered)]

        def free():
            left[0] -= 1
            if not left[0]:
                self.live -= count

        for x in gathered:
            weakref.finalize(x.untyped_storage(), free)


class _LayerStream:
    """One step's streamed gathers: the layers' shards, the gathers in
    flight, and the layer function."""

    def __init__(self, layer: Callable, shards: List[Dict[str, Any]],
                 dims: Dict[str, Tuple], stats: GatherStats):
        self.layer, self.shards, self.dims = layer, shards, dims
        self.names = list(dims)
        self.stats = stats
        self.pending: Dict[int, Dict[str, Any]] = {}

    def prefetch(self, i: int) -> None:
        """Start layer ``i``'s all-gathers without waiting for them."""
        if 0 <= i < len(self.shards) and i not in self.pending:
            full: Dict[str, Any] = {}
            for name in self.names:
                x, dims = self.shards[i][name], self.dims[name]
                if not dims:
                    full[name] = x
                    continue
                x = _gather(x, dims[:-1])
                full[name] = _all_gather_dim(x, *dims[-1], async_op=True)
            self.stats.track([x.out for x in full.values()
                              if isinstance(x, _Pending)])
            self.pending[i] = full

    def take(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``, gathered: waits for its prefetch (or starts it)."""
        self.prefetch(i)
        full = self.pending.pop(i)
        for name, x in full.items():
            if isinstance(x, _Pending):
                full[name] = x.wait()
        return full

    def scatter(self, g, name: str):
        return _scatter(g, self.dims[name])


class _StreamedLayer(torch.autograd.Function):
    """One layer with ZeRO-3 residency: the forward runs on the gathered
    layer but saves only (input activation, shards); the backward
    re-gathers the layer, recomputes it (an inherent per-layer remat) and
    reduce-scatters the layer's grads back to shards. The layer returns
    x, or ``(x, aux)``: then both outputs carry a cotangent back."""

    @staticmethod
    def forward(ctx, x, stream, i, full, *shards):
        # the shards are inputs for their grads; the stream keeps views
        # of them for the backward's gather
        ctx.stream, ctx.i = stream, i
        ctx.save_for_backward(x)
        return stream.layer(x, full)

    @staticmethod
    def backward(ctx, *cts):
        stream, i = ctx.stream, ctx.i
        (x,) = ctx.saved_tensors
        full = stream.take(i)
        stream.prefetch(i - 1)  # the next layer of the backward pass
        names = stream.names
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            leaves = [full[n].detach().requires_grad_(True) for n in names]
            out = stream.layer(xd, dict(zip(names, leaves)))
            grads = torch.autograd.grad(out, [xd, *leaves], cts)
        del full, leaves, out
        dshards = [stream.scatter(g, n) for g, n in zip(grads[1:], names)]
        return (grads[0], None, None, None, *dshards)


def make_spmd_train_step(cfg: LlamaConfig, mesh, optimizer=None,
                         gather: str = "streamed", device=None, rules=None):
    """Build ``(init_state, train_step)`` for this rank of ``mesh``, the
    sharded counterpart of ``models/llama.py:make_train_step`` with its
    numerics (held to the JAX step at rtol 1e-4 in float32, 3e-3 in
    bfloat16, tested).

    ``init_state(init=0)`` takes a seed or a JAX param tree as numpy
    arrays and keeps only this rank's shards. A seed draws the whole tree
    from a ``torch.Generator`` on the device, as the single-device step
    does, and slices it, so every layout holds the same params. Returns
    ``{"params": nested dict of shard tensors, "opt_state": optimizer,
    "step": 0}``.

    ``train_step(state, tokens)`` takes this rank's rows of the global
    batch (``parallel.mesh.batch_sharding(mesh)``), int ``[b, T+1]``,
    updates the state in place and returns the loss, the mean over the
    batch axes. ``train_step.gather_stats`` names the schedule that runs
    and counts its gathered layers.

    ``gather`` picks the fsdp schedule for the stacked layers:
    ``"upfront"`` all-gathers every leaf before the first layer (layers
    then run under ``checkpoint`` if ``cfg.remat``); ``"streamed"``
    (default) gathers layer by layer, prefetching the next layer's
    all-gather, with at most two fsdp-full layers live (see the module
    docstring). Folds to ``"upfront"`` when the mesh has no fsdp axis.

    A live ``tensor`` axis shards heads/mlp/vocab through compute
    (Megatron manual TP via ``_pp_layer`` + ``tp_psum_pair``), with a
    vocab-parallel embedding and cross-entropy; tensor-sharded dims are
    never gathered.

    ``optimizer`` maps a list of shard tensors to a
    ``torch.optim.Optimizer``; the default is AdamW at the JAX step's
    optax settings (lr 3e-4, betas (0.9, 0.95), eps 1e-8, weight decay
    0.1). It runs on the shards, so elementwise transforms are exact;
    one that needs a global statistic (clipping by the global norm)
    would see only this rank's shard.

    A live ``seq`` or ``pipe`` axis is refused, as in the JAX package:
    :func:`make_mesh_train_step` takes ``seq``,
    ``models/llama.py:make_pipeline_train_step`` takes ``pipe``; a live
    ``expert`` axis too (:func:`make_moe_train_step` takes it, for the
    MoE decoder).

    Runs on ``cuda`` (NCCL mesh) unless ``device`` says otherwise."""
    dev = resolve_device(device)
    _refuse_axes("make_spmd_train_step", "tensor", mesh,
                 ("seq", "pipe", "expert"), cfg)
    init_state, train_step = _sharded_step(cfg, mesh, optimizer, gather, dev,
                                           rules)
    return (observe_program(init_state, "spmd.init_state"),
            observe_program(train_step, "spmd.train_step"))


def make_mesh_train_step(cfg: LlamaConfig, mesh, optimizer=None,
                         gather: str = "streamed", device=None, rules=None):
    """Build ``(init_state, train_step)`` for this rank of ``mesh``, any
    of the batch axes, ``fsdp``, ``seq`` and ``tensor``: the port of the
    JAX package's GSPMD ``models/llama.py:make_train_step(cfg, mesh)``,
    the one JAX step that takes a live ``seq`` axis. It is
    :func:`make_spmd_train_step` (same arguments, state, gather schedules
    and tensor parallelism) with sequence parallelism added:

    - tokens shard over the batch axes only, as JAX's ``data_sharding``:
      ``train_step`` takes the same ``[b, T+1]`` rows on every rank of a
      ``seq`` group, and rank r of R keeps inputs and targets
      ``[r T/R, (r+1) T/R)`` (T % R == 0, or it raises);
    - the residual stream stays split over ``seq`` through every layer
      (JAX's ``("batch", "seq", None)`` constraint), RoPE takes the
      global positions, and attention is the ring
      (``parallel/ring_attention.py``) over the ``seq`` group;
    - the loss is the global mean, averaged over the ``seq`` group too,
      and params, replicated over ``seq``, have their grads all-reduced
      over it as well as over the batch axes.

    A live ``pipe`` axis is refused (``make_pipeline_train_step``), and
    so is ``expert`` (:func:`make_moe_train_step`)."""
    dev = resolve_device(device)
    _refuse_axes("make_mesh_train_step", "seq + tensor", mesh,
                 ("pipe", "expert"), cfg)
    init_state, train_step = _sharded_step(cfg, mesh, optimizer, gather, dev,
                                           rules)
    return (observe_program(init_state, "llama.gspmd_init"),
            observe_program(train_step, "llama.gspmd_train_step"))


def make_moe_train_step(cfg: moe_llama.MoEConfig, mesh, optimizer=None,
                        gather: str = "streamed", device=None, rules=None):
    """Build ``(init_state, train_step)`` of the MoE decoder
    (``models/moe_llama.py``) for this rank of ``mesh``, any of the batch
    axes, ``fsdp``, ``expert``, ``tensor`` and ``seq``: the port of the
    JAX package's ``moe_llama.make_train_step(cfg, mesh)``. It is
    :func:`make_spmd_train_step` (same arguments, state, gather schedules
    and tensor parallelism; ``rules`` defaults to
    :func:`moe_partition_rules`) with expert and sequence parallelism:

    - rank j of the ``expert`` axis (ep ranks) keeps experts
      ``[j E/ep, (j+1) E/ep)`` of every layer (``E % ep`` raises), and
      each MoE FFN sends the dispatched slots to their experts' ranks and
      back by all-to-all;
    - tokens shard over the batch axes only, as JAX's ``data_sharding``:
      ``train_step`` takes the same ``[b, T+1]`` rows on every rank of an
      ``expert`` group, and expert rank j keeps rows ``[j b/ep, (j+1)
      b/ep)`` (``b % ep`` raises). Capacity is per row, so no routing
      decision changes;
    - the aux loss takes ``frac`` (the first-choice shares, without
      gradient) averaged over the batch axes and ``expert`` times the
      local mean router probability: the mean of the ranks' losses is
      JAX's global-batch loss, in value and in gradient;
    - loss and grads average over ``expert`` as over the batch axes.
      Expert leaves are not summed over it (the all-to-all's backward
      brought every rank's contribution home), but take its ``1/ep``;
    - ``tensor`` splits heads, the vocab and each expert's mlp dim (gate
      and up column-parallel, down row-parallel), with the router and
      the routing replicated over it;
    - ``seq`` splits each row as :func:`make_mesh_train_step` does
      (inputs, targets and positions, attention the ring), and the MoE
      FFN routes the whole row (``ops/moe.py:top_k_routing``'s
      ``seq_group``: capacity from the whole row, slot offsets from the
      other ranks' counts) and runs each rank's C/R capacity slots of
      every expert. Expert leaves are summed over ``seq`` as every
      replicated leaf is: rank r's grad covers its own slots, with the
      cotangents of every ``seq`` rank's tokens.

    A live ``pipe`` axis is refused: the JAX package's MoE step has no
    pipeline schedule."""
    dev = resolve_device(device)
    if not isinstance(cfg, moe_llama.MoEConfig):
        raise TypeError(f"make_moe_train_step takes an MoEConfig, not "
                        f"{type(cfg).__name__}")
    _refuse_axes("make_moe_train_step", "expert + tensor + seq", mesh,
                 ("pipe",), cfg)
    return _sharded_step(cfg, mesh, optimizer, gather, dev, rules)


def _refuse_axes(step: str, axes: str, mesh, refused, cfg) -> None:
    """Raise on the first live axis of ``refused``, with the reason the
    decoder of ``cfg`` gives (the step that takes it, as the JAX
    package's refusal names it, or why it has no port)."""
    sizes = axis_sizes(mesh)
    if _decoder(cfg) is _MOE and step != "make_moe_train_step":
        raise ValueError(f"{step} trains the Llama decoder; an MoE config "
                         f"is make_moe_train_step's")
    for ax in refused:
        if sizes.get(ax, 1) > 1:
            raise ValueError(f"{step} shards over batch axes + fsdp + "
                             f"{axes}; mesh has live {ax!r} axis — "
                             f"{_decoder(cfg).refused[ax]}")


def _keep_block(x, dim: int, rank: int, n_ranks: int, what: str):
    """Block ``rank`` of ``n_ranks`` equal blocks of ``x`` along ``dim``;
    raises unless they divide it (``what`` names the dim and the axis)."""
    n, rem = divmod(x.shape[dim], n_ranks)
    if rem:
        raise ValueError(what.format(x.shape[dim], n_ranks))
    return x.narrow(dim, rank * n, n)


def _sharded_step(cfg: LlamaConfig, mesh, optimizer, gather: str,
                  dev: torch.device, rules):
    """The step the constructors return; see :func:`make_spmd_train_step`,
    :func:`make_mesh_train_step` and :func:`make_moe_train_step`."""
    model = _decoder(cfg)
    sizes = axis_sizes(mesh)
    if gather not in ("streamed", "upfront"):
        raise ValueError(
            f"gather must be 'streamed' or 'upfront', got {gather!r}")
    tensor = "tensor" if sizes.get("tensor", 1) > 1 else None
    _check_mesh(cfg, mesh, dev)
    batch_axes = data_axes(mesh)
    fsdp = "fsdp" if "fsdp" in sizes else None
    gather_mode = gather if fsdp is not None else "upfront"
    seq = "seq" if sizes.get("seq", 1) > 1 else None
    seq_group = mesh.get_group(seq) if seq is not None else None
    seq_rank = mesh.get_local_rank(seq) if seq is not None else 0
    expert = "expert" if sizes.get("expert", 1) > 1 else None
    if expert is not None and cfg.num_experts % sizes[expert]:
        raise ValueError(f"expert axis size {sizes[expert]} does not "
                         f"divide cfg.num_experts={cfg.num_experts}")
    expert_rank = mesh.get_local_rank(expert) if expert is not None else 0
    # the loss and the grads average over the batch axes, seq and expert
    mean_axes = batch_axes + tuple(a for a in (seq, expert) if a is not None)
    denom = int(np.prod([sizes[a] for a in mean_axes]))
    _, specs = spmd_param_specs(cfg, mesh, rules)
    shard_fns, _ = make_shard_and_gather_fns(specs, mesh, device=dev)
    # tensor- and expert-sharded dims stay sharded through compute
    skip = (tensor, expert)
    dims = _map(lambda s: _gather_dims(s, mesh, skip), specs)
    # one layer (stacked dim sliced off): spec dims shift left by one
    layer_dims = {name: _gather_dims(P(*s[1:]), mesh, skip)
                  for name, s in specs["layers"].items()}
    tp_group = mesh.get_group(tensor) if tensor is not None else None
    collectives = tp_psum_pair(tp_group) if tensor is not None else None
    groups = _Groups(
        collectives=collectives, seq_group=seq_group,
        expert_group=mesh.get_group(expert) if expert is not None else None,
        # frac carries no gradient: a plain in-place mean of a copy
        frac_mean=lambda f: pmean_tree(f.detach().clone(), mesh, mean_axes))
    stats = GatherStats(gather_mode)

    def init_state(init=0):
        whole = model.init_model(cfg, init, dev)
        params = _map(lambda f, x: f(x).requires_grad_(True), shard_fns,
                      whole.tree())
        del whole
        return {"params": params, "step": 0,
                "opt_state": _make_optimizer(optimizer, _leaves(params))}

    def run_layers(x, layer_shards):
        """x through the layers; returns ``(x, aux summed over the layers
        or None)``."""
        B, T, _ = x.shape
        positions = _positions(B, T, x.device) + seq_rank * T
        aux = []

        def layer(h, p):
            return model.layer(cfg, h, p, positions, groups)

        def carry(out):
            if isinstance(out, tuple):
                aux.append(out[1])
                return out[0]
            return out

        if gather_mode == "streamed":
            shards = _unbind_layers({"layers": layer_shards})
            stream = _LayerStream(layer, [
                {n: s.detach() for n, s in lay.items()} for lay in shards],
                layer_dims, stats)
            for i, lay in enumerate(shards):
                cur = stream.take(i)
                # start layer i+1's gather first, to overlap layer i
                stream.prefetch(i + 1)
                x = carry(_StreamedLayer.apply(
                    x, stream, i, cur, *(lay[n] for n in stream.names)))
                del cur
            return x, (sum(aux) if aux else None)
        full = {n: _gather_leaf(s, dims["layers"][n])
                for n, s in layer_shards.items()}
        stats.track([full[n] for n, s in layer_shards.items()
                     if full[n] is not s], cfg.n_layers)
        remat = cfg.remat and torch.is_grad_enabled()
        for p in _unbind_layers({"layers": full}):
            if remat:
                x = carry(checkpoint(layer, x, p, use_reentrant=False))
            else:
                x = carry(layer(x, p))
        return x, (sum(aux) if aux else None)

    def local_loss(params, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        if seq is not None:
            # this rank's block of the sequence, inputs and targets alike
            inputs, targets = (_keep_block(
                t, 1, seq_rank, sizes[seq], "sequence of {} tokens does "
                "not split over seq axis size {}") for t in (inputs, targets))
        if expert is not None:
            # this expert rank's block of the rows
            inputs, targets = (_keep_block(
                t, 0, expert_rank, sizes[expert], "batch of {} rows does "
                "not split over expert axis size {}")
                for t in (inputs, targets))
        emb_local = _gather_leaf(params["embedding"], dims["embedding"])
        if tensor is not None:
            x = vp_embed(cfg, emb_local, inputs, tp_group, collectives[1])
        else:
            x = emb_local[inputs].to(cfg.dtype)
        x, aux = run_layers(x, params["layers"])
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            head_local = emb_local.T
        else:
            head_local = _gather_leaf(params["lm_head"], dims["lm_head"])
        if tensor is not None:
            nll = chunked_nll_mean(
                cfg, collectives[0](x), targets,
                vp_chunk_nll(cfg, head_local, tp_group, collectives[1]))
        else:
            nll = chunked_nll_mean(cfg, x, targets,
                                   _plain_chunk_nll(cfg, head_local))
        if aux is None:
            return nll
        return nll + cfg.aux_loss_coef * (aux / cfg.n_layers)

    def reduce_leaf(g, spec):
        """Locally-reduced grad shard → global mean: summed over every
        batch axis the leaf is not sharded over (a gathered leaf's fsdp
        sum came with its reduce-scatter) and over ``seq`` and
        ``expert``, where every leaf but the experts' is replicated; an
        expert leaf's sum over ``expert`` came with the all-to-all's
        backward, and its sum over ``seq`` is this one's (each ``seq``
        rank ran its own capacity slots). No tensor reduction:
        tensor-sharded leaves carry exact per-shard grads and
        tensor-replicated leaves identical ones (the tp_psum_pair
        contract)."""
        named = {a for ax in spec for a in _spec_axes(ax)}
        psum_tree(g, mesh, [a for a in mean_axes if a not in named])
        if denom > 1:
            g.div_(denom)

    def train_step(state, tokens: torch.Tensor) -> torch.Tensor:
        params, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        loss = local_loss(params, tokens.to(dev).long())
        loss.backward()
        for p, spec in zip(_leaves(params), _leaves(specs)):
            reduce_leaf(p.grad, spec)
        opt.step()
        state["step"] += 1
        return pmean_tree(loss.detach(), mesh, mean_axes)

    train_step.gather_stats = stats
    return init_state, train_step


def make_collective_probes(cfg: LlamaConfig, mesh, rules=None):
    """Probe functions that price the step's collective seams outside the
    step: ``gather_probe(params)`` all-gathers every fsdp-sharded leaf —
    the upfront schedule's full-tree gather — and
    ``scatter_probe(params)`` reduce-scatters a same-shaped full tree —
    the backward's reduce-scatter. Each returns a scalar that depends on
    every collective's output. Without an fsdp axis they move nothing."""
    _, specs = spmd_param_specs(cfg, mesh, rules)
    fsdp = "fsdp" if "fsdp" in mesh.mesh_dim_names else None

    def fsdp_dim(spec):
        for dim, ax in enumerate(spec):
            if fsdp is not None and fsdp in _spec_axes(ax):
                return dim
        return None

    def probe(params, one):
        acc = torch.zeros((), dtype=torch.float32,
                          device=_leaves(params)[0].device)
        for leaf, spec in zip(_leaves(params), _leaves(specs)):
            d = fsdp_dim(spec)
            if d is not None:
                acc = acc + one(leaf.detach(), d, mesh.get_group(fsdp))
        return acc

    def gather_one(leaf, d, group):
        return _all_gather_dim(leaf, d, group).reshape(-1)[0].float()

    def scatter_one(leaf, d, group):
        shape = list(leaf.shape)
        shape[d] *= dist.get_world_size(group)
        # seeded from the input, so the full buffer is not a constant
        full = leaf.new_empty(shape).fill_(leaf.reshape(-1)[0])
        return _reduce_scatter_dim(full, d, group).reshape(-1)[0].float()

    return (lambda params: probe(params, gather_one),
            lambda params: probe(params, scatter_one))


# --------------------------------------------------------------------------- #
# Mesh specs
# --------------------------------------------------------------------------- #


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"data=4,fsdp=2"`` → ``{"data": 4, "fsdp": 2}``."""
    axes: Dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad mesh spec part {part!r} in {spec!r}")
        k, v = part.split("=", 1)
        axes[k.strip()] = int(v)
    return axes


def build_train_mesh(spec: str = "", world_size: Optional[int] = None,
                     device=None):
    """Mesh for sharded training: ``spec`` (e.g. ``"data=2,fsdp=2"``), or
    pure data-parallel over every rank when empty, on the device type of
    ``resolve_device(device)``. ``world_size`` defaults to the process
    group's. The same empty spec therefore runs one rank and N ranks
    unchanged."""
    axes = parse_mesh_spec(spec)
    unknown = [k for k in axes if k not in AXIS_ORDER]
    if unknown:
        # make_mesh keeps only AXIS_ORDER names, so a typo'd axis would
        # otherwise yield a silent size-1 mesh (no parallelism at all)
        raise ValueError(f"unknown mesh axis(es) {unknown!r} in "
                         f"{spec!r}; valid axes: {AXIS_ORDER}")
    world = dist.get_world_size() if world_size is None else int(world_size)
    if not axes:
        axes = {"data": world}
    n = int(np.prod(list(axes.values())))
    if n > world:
        raise ValueError(f"mesh spec {spec!r} needs {n} devices, "
                         f"have {world}")
    return make_mesh(axis_sizes=axes, world_size=world, device=device)

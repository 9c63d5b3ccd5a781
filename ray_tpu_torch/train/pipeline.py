"""MPMD pipeline-parallel training over compiled graphs (port of
``ray_tpu/train/pipeline.py``).

Per "Scaling Deep Learning Training with MPMD Pipeline Parallelism"
(arXiv:2412.14374): instead of one global SPMD program, each pipeline
stage is its OWN program — here a resident actor holding its slice of
the param tree on its card — and stages exchange activations and
gradients point-to-point. The stage graph (forward chain, loss+grad at
the last stage, backward chain) is compiled ONCE into ring channels
(``experimental_compile(device_channels=True, max_inflight=N)``), so a
training step is M microbatch ``execute()`` calls flowing through the
pipeline, activations and gradients crossing stages as CUDA tensors on
the typed tensor path (one device-to-host copy into the ring slot, one
host-to-device copy out of it onto the next stage's card; no
serialization layer), and per-call scheduling out of the loop.

Two schedules:

- ``schedule="1f1b"`` (default; 1F1B per arXiv:1806.03377 /
  arXiv:2412.14374): at most K (= num_stages) microbatches in flight,
  so each stage's activation stash never exceeds K; stage executor
  loops run **backward-over-forward** (the backward nodes are bound
  with a higher scheduling priority, so a stage with both a forward
  and a backward microbatch ready runs the backward first); and the
  per-stage SGD update is **overlapped into the drain bubble**: each
  stage applies its mean-grad step the moment its own M-th backward
  microbatch lands, while downstream stages are still draining.
- ``schedule="gpipe"``: stream all M microbatches in a sliding window
  of ``max_inflight`` (default 2K), then apply updates in one eager
  ``apply_grads()`` barrier after the flush.

Both schedules compute exactly full-batch gradient descent (mean over
microbatch mean-grads), so ``reference_train_losses`` /
``reference_llama_losses`` reproduce them in one process and the
distributed losses AND final params match to numerical noise.

Two stage models:

- ``model="mlp"`` — MLP slices (tanh layers, MSE loss).
- ``model="llama"`` — decoder-block stages over
  ``ray_tpu_torch/models/llama.py`` (attention through the Hopper
  flash-attention kernels on the card): stage 0 owns the embedding plus
  the first block slice, middle stages own contiguous block slices, the
  last stage owns the final blocks + final_norm + lm_head and computes
  next-token cross-entropy. Only activation-sized ``[B, T, dim]``
  tensors (and their gradients) cross stages.

JAX's ``jit``/``vjp``/``value_and_grad`` become autograd here: a
forward runs under ``torch.no_grad()`` and stashes its input; the
backward re-runs the stage on the stashed input with grad on and takes
``torch.autograd.grad`` against the incoming cotangent (the stage is its
own rematerialization unit, as in the reference).

Device policy: the trainer runs its stages on ``cuda`` (one card a
stage actor, ``num_gpus=1``, unless ``stage_resources`` gives another
share under ``"GPU"``) unless ``device="cpu"``; without a card it
raises.

    trainer = MPMDPipelineTrainer([8, 32, 32, 4], num_stages=2, lr=0.05,
                                  device="cpu")
    losses = trainer.fit(x, y, steps=20, num_microbatches=4)
    trainer.shutdown()
"""

from __future__ import annotations

import collections
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import resolve_device
from ray_tpu_torch.collective.collective import _leaves
from ray_tpu_torch.models.llama import (_layer, _positions, _unbind_layers,
                                        embed_tokens, init_params)
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.layers import rms_norm
from ray_tpu_torch.util import flight_recorder as _fr

_sp_fwd = _fr.register_span("pipe.fwd", tag_keys=("stage", "chunk", "mb"))
_sp_bwd = _fr.register_span("pipe.bwd", tag_keys=("stage", "chunk", "mb"))
_sp_loss_bwd = _fr.register_span("pipe.loss_bwd",
                                 tag_keys=("stage", "chunk", "mb"))
_sp_step = _fr.register_span("pipe.step")

# Regression-detector feed: the MPMD loop publishes its step time under
# the same gauge the SPMD loop uses (registered there), tagged
# loop=pipeline, so the health monitor watches one series family.
from ray_tpu_torch.train.spmd import _g_step_seconds, _sync  # noqa: E402

__all__ = [
    "MPMDPipelineTrainer",
    "PipelineStageActor",
    "init_mlp_params",
    "reference_train_losses",
    "reference_llama_losses",
    "split_llama_stages",
    "split_stages",
]

# the attention kernels' wrappers, whose launch counts a stage reports
_KERNELS = {"fwd": fa.flash_attention_forward,
            "dq": fa.flash_attention_bwd_dq,
            "dkv": fa.flash_attention_bwd_dkv}


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _tree_unflatten(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _to_tensor(x, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``dev`` (a copy for numpy:
    the caller's array or a ring slot is not aliased)."""
    if torch.is_tensor(x):
        return x.to(dev)
    return torch.from_numpy(np.array(x)).to(dev)


# ------------------------------------------------------------ model math
#
# A small MLP: tanh on every layer except the final (linear) one, MSE
# loss. The SAME functions drive the stage actors and the single-process
# reference, so loss-equivalence is a property of the schedule, not of
# two implementations agreeing.


def init_mlp_params(layer_sizes: Sequence[int],
                    seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic (W, b) list — one entry per layer (the JAX
    package's numpy init: the same seed gives the same arrays)."""
    rng = np.random.RandomState(seed)
    params = []
    for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        scale = np.sqrt(2.0 / fan_in)
        params.append((
            (rng.randn(fan_in, fan_out) * scale).astype(np.float32),
            np.zeros((fan_out,), dtype=np.float32),
        ))
    return params


def split_stages(params: List, num_stages: int) -> List[List]:
    """Partition the layer list into contiguous, near-even stages."""
    if num_stages < 1 or num_stages > len(params):
        raise ValueError(
            f"num_stages={num_stages} must be in [1, {len(params)}]")
    base, extra = divmod(len(params), num_stages)
    out, i = [], 0
    for s in range(num_stages):
        n = base + (1 if s < extra else 0)
        out.append(params[i:i + n])
        i += n
    return out


def _apply_stage(params, x, final_linear: bool):
    for i, (w, b) in enumerate(params):
        z = x @ w + b
        x = z if (final_linear and i == len(params) - 1) else torch.tanh(z)
    return x


def _stage_loss(params, a, y):
    pred = _apply_stage(params, a, True)
    return torch.mean((pred - y) ** 2)


# ----------------------------------------------------- llama stage math
#
# Decoder-block stages over models/llama.py: the SAME _layer as the
# single-device train step (attention on the flash kernels), the stacked
# layer params sliced [l0:l1] per stage. Stage boundaries carry the
# [B, T, dim] residual stream only.


def _check_llama_split(cfg, num_stages: int) -> None:
    if cfg.tie_embeddings:
        raise ValueError(
            "MPMD llama stages need tie_embeddings=False (a tied lm_head "
            "would make stage 0 and stage K-1 share one weight)")
    if num_stages < 1 or num_stages > cfg.n_layers:
        raise ValueError(
            f"num_stages={num_stages} must be in [1, {cfg.n_layers}]")


def split_llama_stages(cfg, params, num_stages: int) -> List[dict]:
    """Slice a llama param tree into contiguous block stages: stage 0
    adds the embedding, the last stage adds final_norm + lm_head.
    ``params`` is the JAX param tree as numpy arrays (each stage's
    leaves numpy views), or the port's :class:`Llama` or its ``tree()``
    (each stage's leaves detached copies, so the whole model can be
    freed). Requires untied embeddings (a tied head would couple the
    first and last stage's weights across the pipeline)."""
    _check_llama_split(cfg, num_stages)
    if isinstance(params, torch.nn.Module):
        params = params.tree()

    def take(v, sl=slice(None)):
        if torch.is_tensor(v):
            return v.detach()[sl].clone()
        return np.asarray(v[sl])

    bounds = [round(s * cfg.n_layers / num_stages)
              for s in range(num_stages + 1)]
    stages = []
    for s in range(num_stages):
        l0, l1 = bounds[s], bounds[s + 1]
        sp: dict = {"layers": {k: take(v, slice(l0, l1))
                               for k, v in params["layers"].items()}}
        if s == 0:
            sp["embedding"] = take(params["embedding"])
        if s == num_stages - 1:
            sp["final_norm"] = take(params["final_norm"])
            sp["lm_head"] = take(params["lm_head"])
        stages.append(sp)
    return stages


def _llama_stage_fwd(cfg, sparams, x):
    """One pipeline stage of the backbone: embed (stage 0 only: x is
    int tokens there, the residual stream everywhere else), then this
    stage's decoder blocks over the sliced layer stack."""
    if "embedding" in sparams:
        x = embed_tokens(cfg, sparams, x)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for p in _unbind_layers(sparams):
        x = _layer(cfg, x, p, positions)
    return x


def _llama_stage_loss(cfg, sparams, a, tokens):
    """Last stage: remaining blocks + final_norm + lm_head + next-token
    cross-entropy (fp32 log-softmax over the whole vocab, unchunked).
    ``tokens`` is the full [B, T+1] input; the stage slices its own
    targets."""
    x = _llama_stage_fwd(cfg, sparams, a)
    x = rms_norm(x, sparams["final_norm"], cfg.norm_eps)
    logits = (x.to(cfg.dtype) @ sparams["lm_head"].to(cfg.dtype)).float()
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return nll.mean()


# --------------------------------------------------------- stage chunks


class _Chunk:
    """One model chunk resident on a stage: its param slice on its
    device, activation stash, grad accumulator, and its forward, vjp and
    loss-grad. With ``virtual_stages == 1`` an actor hosts exactly one
    chunk (plain 1F1B/GPipe); the interleaved schedule round-robins ``v``
    chunks per actor (Megatron-style, arXiv:2104.04473) so each actor
    always has another chunk's work to fill what would otherwise be
    bubble."""

    def __init__(self, kind, spec_meta, cparams, cid: int,
                 is_first: bool, is_last: bool, dev: torch.device):
        self.cid = cid
        self.is_first = is_first
        self.is_last = is_last
        self.stash: collections.deque = collections.deque()
        self.stash_max = 0
        self.grad_sum = None
        self.nmb = 0
        self.fwd_seq = 0  # forward-microbatch index within the step
        self.loss_sum = 0.0
        self.params = _tree_map(lambda v: _to_tensor(v, dev).float(),
                                cparams)
        if kind == "mlp":
            self._fwd = lambda p, x: _apply_stage(p, x, False)  # noqa: E731
            self._loss = _stage_loss
        else:  # llama
            cfg = spec_meta
            self._fwd = lambda p, x: _llama_stage_fwd(cfg, p, x)  # noqa: E731
            self._loss = lambda p, a, y: _llama_stage_loss(cfg, p, a, y)  # noqa: E731,E501

    def _grad_params(self):
        """The params as fresh autograd leaves (sharing storage) and
        their flat list."""
        leaves = [p.detach().requires_grad_()
                  for p in _leaves(self.params)]
        return _tree_unflatten(self.params, leaves), leaves

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Stash the input (the backward rematerializes from it) and run
        the chunk without building a graph (not ``inference_mode``: the
        stash becomes an autograd input later)."""
        self.stash.append(x)
        self.stash_max = max(self.stash_max, len(self.stash))
        with torch.no_grad():
            return self._fwd(self.params, x)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        """Pop the oldest stashed input, re-run the chunk on it with grad
        on and pull ``g`` back: param grads are accumulated, the input's
        grad returned. The first chunk's input (int tokens for llama) is
        not differentiated: grads go to the params only and a zero fp32
        scalar (on the host) is the edge's result, as in the
        reference."""
        x = self.stash.popleft()
        params, leaves = self._grad_params()
        with torch.enable_grad():
            if self.is_first:
                out = self._fwd(params, x)
                gp = torch.autograd.grad(out, leaves, g)
                gx = torch.zeros((), dtype=torch.float32)
            else:
                xr = x.detach().requires_grad_()
                out = self._fwd(params, xr)
                *gp, gx = torch.autograd.grad(out, leaves + [xr], g)
        self.accum(gp)
        self.nmb += 1
        return gx

    def loss_backward(self, a: torch.Tensor, y: torch.Tensor
                      ) -> torch.Tensor:
        """The last chunk's fused forward + loss + backward: accumulates
        the param grads and the loss, returns the activation's grad."""
        params, leaves = self._grad_params()
        with torch.enable_grad():
            ar = a.detach().requires_grad_()
            loss = self._loss(params, ar, y)
            *gp, ga = torch.autograd.grad(loss, leaves + [ar])
        self.accum(gp)
        self.loss_sum += float(loss.detach())
        self.nmb += 1
        return ga

    def accum(self, gparams) -> None:
        """Sum one microbatch's grads (float32, the params' dtype) in
        microbatch order: sum + g, as the reference's tree add."""
        if self.grad_sum is None:
            self.grad_sum = list(gparams)
        else:
            for s, g in zip(self.grad_sum, gparams):
                s.add_(g)

    def apply_step(self, lr: float) -> Optional[float]:
        """The mean-grad SGD step ``p - lr * (sum / nmb)``, in place."""
        with torch.no_grad():
            for p, g in zip(_leaves(self.params), self.grad_sum):
                p.sub_(lr * (g / self.nmb))
        loss = (self.loss_sum / self.nmb) if self.is_last else None
        self.grad_sum = None
        self.nmb = 0
        self.fwd_seq = 0
        self.loss_sum = 0.0
        return loss

    def reset(self) -> None:
        self.stash.clear()
        self.stash_max = 0
        self.grad_sum = None
        self.nmb = 0
        self.fwd_seq = 0
        self.loss_sum = 0.0


def _stage_device(device: str) -> torch.device:
    """The card a stage actor runs on: the one its ``CUDA_VISIBLE_DEVICES``
    binding shows it (``cuda:0``), or the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    return resolve_device(torch.device("cuda", 0))


def _make_chunks(kind, spec_meta, chunk_params: Dict[int, Any],
                 first_cid: int, last_cid: int, dev: torch.device,
                 init: Optional[Tuple[int, int]] = None
                 ) -> Dict[int, _Chunk]:
    """The chunks of ``chunk_params`` (cid -> param tree) on ``dev``. With
    ``init = (seed, num_chunks)`` (llama) the trees are made here: the
    port's seeded ``init_params`` of the whole model on ``dev``, split
    into ``num_chunks`` and this stage's chunks kept, so every stage (and
    the in-process reference) holds slices of one init without shipping
    the weights."""
    if init is not None:
        seed, num_chunks = init
        gen = torch.Generator(device=dev).manual_seed(seed)
        whole = split_llama_stages(
            spec_meta, init_params(spec_meta, gen, dev), num_chunks)
        chunk_params = {cid: whole[cid] for cid in chunk_params}
        del whole
    return {cid: _Chunk(kind, spec_meta, cp, cid, cid == first_cid,
                        cid == last_cid, dev)
            for cid, cp in chunk_params.items()}


# --------------------------------------------------------- stage actors


@rt.remote
class PipelineStageActor:
    """One pipeline stage: one or more model chunks resident on a worker
    (and its card), driven by compiled-graph executor loops. ``fwd*``
    stashes the chunk input (activation rematerialization: backward
    re-runs the chunk under autograd instead of shipping intermediate
    activations), ``bwd``/``loss_bwd`` accumulate param grads
    chunk-locally; updates apply either eagerly (``apply_grads()``
    barrier, gpipe) or chunk-locally the moment the armed microbatch
    count lands (1F1B overlap — ``set_step_microbatches``).

    The in-place update never races a forward on the same params: the
    actor is serial, so its compiled exec loops run every node method
    under the actor's one exec lock (``core/worker_runtime.py``,
    ``_compiled_exec_loop``: one method at a time, priority only picks
    which waiting loop goes next), and the update runs inside ``bwd`` /
    ``loss_bwd``. Within a step every forward of a chunk precedes its
    M-th backward, and the driver submits the next step only after the
    flush, so no forward of either step sees half-stepped params."""

    def __init__(self, kind: str, spec_meta, chunk_params: Dict[int, Any],
                 first_cid: int, last_cid: int, lr: float,
                 stage: int = 0, device: str = "cuda",
                 init: Optional[Tuple[int, int]] = None):
        self.kind = kind
        self.lr = lr
        self._stage = stage  # flight-recorder span tag
        self.dev = _stage_device(device)
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)
        self.chunks = _make_chunks(kind, spec_meta, chunk_params,
                                   first_cid, last_cid, self.dev, init)
        self._last_cid = last_cid
        self._busy_s = 0.0
        self._step_m = 0  # auto-apply target (0 = eager barrier mode)
        self._last_loss: Optional[float] = None

    def _chunk(self, cid) -> _Chunk:
        return self.chunks[next(iter(self.chunks)) if cid is None else cid]

    def _microbatch_done(self, ch: _Chunk) -> None:
        """In 1F1B mode the armed M-th backward applies the chunk's
        update HERE, inside the pipeline drain — upstream chunks are
        still running their remaining backwards while this one steps its
        weights (update/bubble overlap)."""
        if self._step_m and ch.nmb >= self._step_m:
            loss = ch.apply_step(self.lr)
            if ch.is_last:
                self._last_loss = loss

    # ---- compiled-graph node methods (one resident loop each) ----
    #
    # Each stops its busy clock after synchronising the card, so busy
    # time (pipeline_stats' bubble, the goodput ledger's bubble column,
    # the flight recorder's attribute_trace) is the card's work, not the
    # host's enqueue.

    def fwd(self, x, cid: int = None):
        t0 = time.perf_counter()
        _t = _fr.now()
        ch = self._chunk(cid)
        mb = ch.fwd_seq
        ch.fwd_seq += 1
        out = ch.forward(_to_tensor(x, self.dev))
        _sync(self.dev)
        self._busy_s += time.perf_counter() - t0
        _sp_fwd.end(_t, self._stage, ch.cid, mb)
        return out

    def fwd_first(self, inp, cid: int = None):
        if self.kind == "llama":
            # inp = tokens [B, T+1]; the backbone sees [:, :-1]
            return self.fwd(inp[:, :-1], cid)
        return self.fwd(inp[0], cid)

    def bwd(self, g, cid: int = None):
        t0 = time.perf_counter()
        _t = _fr.now()
        ch = self._chunk(cid)
        mb = ch.nmb
        gx = ch.backward(_to_tensor(g, self.dev))
        _sync(self.dev)
        self._microbatch_done(ch)
        self._busy_s += time.perf_counter() - t0
        _sp_bwd.end(_t, self._stage, ch.cid, mb)
        return gx

    def loss_bwd(self, a, inp):
        t0 = time.perf_counter()
        _t = _fr.now()
        ch = self.chunks[self._last_cid]
        mb = ch.nmb
        # the token batch reaches this stage on its own edge from the
        # driver: each stage moves it to its own card
        y = _to_tensor(inp if self.kind == "llama" else inp[1], self.dev)
        ga = ch.loss_backward(_to_tensor(a, self.dev), y)
        _sync(self.dev)
        self._microbatch_done(ch)
        self._busy_s += time.perf_counter() - t0
        _sp_loss_bwd.end(_t, self._stage, ch.cid, mb)
        return ga

    # ---- eager control-plane methods (between pipeline flushes) ----

    def set_step_microbatches(self, m: int) -> None:
        """Arm 1F1B overlapped updates: each chunk applies its
        mean-grad SGD step the moment its m-th backward microbatch
        completes (0 disarms — gpipe/warmup mode, updates via
        apply_grads)."""
        self._step_m = int(m)

    def collect_loss(self):
        """The armed step's mean loss (last chunk's host; None
        elsewhere) — read AFTER the pipeline drains, the updates
        already applied."""
        loss, self._last_loss = self._last_loss, None
        return loss

    def apply_grads(self):
        """Mean each chunk's accumulated microbatch grads, take one SGD
        step, reset. Returns the mean microbatch loss (last chunk's
        host only)."""
        loss = None
        for ch in self.chunks.values():
            if ch.nmb == 0:
                continue
            step_loss = ch.apply_step(self.lr)
            if ch.is_last:
                loss = step_loss
        self._last_loss = None
        return loss

    def reset_state(self):
        """Drop accumulated grads/metrics WITHOUT stepping (used after
        the warm-up execution)."""
        for ch in self.chunks.values():
            ch.reset()
        self._busy_s = 0.0
        self._last_loss = None

    def get_params(self):
        return {cid: _tree_map(_to_numpy, ch.params)
                for cid, ch in self.chunks.items()}

    def stage_stats(self):
        return {"busy_s": self._busy_s,
                "stash_depth": sum(len(ch.stash)
                                   for ch in self.chunks.values()),
                "stash_max": max(ch.stash_max
                                 for ch in self.chunks.values()),
                "stash_actor_max": sum(ch.stash_max
                                       for ch in self.chunks.values())}

    def channel_stats(self):
        from ray_tpu_torch.experimental.channel import STATS

        return dict(STATS)

    def probe(self, reset: bool = False) -> Dict[str, Any]:
        """Where this stage runs and what it launched: its
        ``CUDA_VISIBLE_DEVICES``, the cards it sees and the first one's
        UUID, the attention kernels' launch counts and the peak device
        memory since the last reset, and the top-level modules this
        process has loaded. ``reset`` sets the counts and the peak
        memory statistics to 0 after reading them."""
        cuda = self.dev.type == "cuda"
        out = {"stage": self._stage,
               "cuda_visible_devices": os.environ.get(
                   "CUDA_VISIBLE_DEVICES"),
               "device_count": torch.cuda.device_count() if cuda else 0,
               "uuid": str(torch.cuda.get_device_properties(0).uuid)
               if cuda else None,
               "launches": {k: fn.launches for k, fn in _KERNELS.items()},
               "peak_bytes": torch.cuda.max_memory_allocated(self.dev)
               if cuda else None,
               "modules": sorted({m.split(".")[0] for m in sys.modules})}
        if reset:
            for fn in _KERNELS.values():
                fn.launches = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.dev)
        return out


# ---------------------------------------------------------- the trainer


class MPMDPipelineTrainer:
    """Partition a model across resident stage actors, compile the
    forward/backward stage graph once, and train with a 1F1B (default)
    or GPipe microbatch schedule over ring channels."""

    def __init__(self, layer_sizes: Optional[Sequence[int]] = None,
                 num_stages: int = 2,
                 lr: float = 0.05, seed: int = 0,
                 max_inflight: Optional[int] = None,
                 buffer_size_bytes: int = 8 << 20,
                 params: Optional[Any] = None,
                 schedule: str = "1f1b",
                 virtual_stages: int = 1,
                 model: str = "mlp",
                 llama_cfg=None,
                 stage_resources: Optional[List[dict]] = None,
                 device=None):
        if num_stages < 2:
            raise ValueError(
                "MPMD pipeline needs >= 2 stages (use a plain in-process "
                "train loop for 1)")
        if schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"unknown schedule {schedule!r} "
                             "(expected '1f1b' or 'gpipe')")
        if virtual_stages < 1:
            raise ValueError("virtual_stages must be >= 1")
        if virtual_stages > 1 and schedule != "1f1b":
            raise ValueError("interleaved virtual stages require "
                             "schedule='1f1b'")
        dev = resolve_device(device)
        self.num_stages = num_stages
        self.virtual_stages = virtual_stages
        num_chunks = num_stages * virtual_stages
        self.lr = lr
        self.schedule = schedule
        self.model = model
        init = None
        if model == "mlp":
            if layer_sizes is None:
                raise ValueError("model='mlp' needs layer_sizes")
            self.layer_sizes = list(layer_sizes)
            if params is None:
                params = init_mlp_params(layer_sizes, seed)
            kind, meta = "mlp", None
            chunk_params = [_tree_map(_to_numpy, c)
                            for c in split_stages(params, num_chunks)]
        elif model == "llama":
            if llama_cfg is None:
                raise ValueError("model='llama' needs llama_cfg")
            kind, meta = "llama", llama_cfg
            if params is None:
                # each stage makes its slices of the seeded init on its
                # own card (see _make_chunks)
                _check_llama_split(llama_cfg, num_chunks)
                chunk_params = [None] * num_chunks
                init = (seed, num_chunks)
            else:
                chunk_params = [
                    _tree_map(_to_numpy, c)
                    for c in split_llama_stages(llama_cfg, params,
                                                num_chunks)]
        else:
            raise ValueError(f"unknown model {model!r}")
        # interleaved chunk placement (Megatron, arXiv:2104.04473):
        # chunk c lives on actor c % K, so the forward chain visits the
        # actor ring v times and every actor always holds both early and
        # late pipeline work
        chunk_actor = [c % num_stages for c in range(num_chunks)]
        # in-flight bound: the driver keeps at most window microbatches
        # outstanding. Plain 1F1B: K (the defining per-stage activation
        # bound). Interleaved: K*v. GPipe: the ring depth.
        self.max_inflight = max_inflight or 2 * num_chunks
        self.window = num_chunks if schedule == "1f1b" \
            else self.max_inflight
        resources = stage_resources or [None] * num_stages
        self.stages = []
        for s in range(num_stages):
            # a card a stage on cuda unless the stage's resources give
            # another share under "GPU"; the rest are custom resources
            res = dict(resources[s] or {})
            opts: Dict[str, Any] = {"num_gpus": res.pop(
                "GPU", 1 if dev.type == "cuda" else 0)}
            if res:
                opts["resources"] = res
            own = {c: chunk_params[c] for c in range(num_chunks)
                   if chunk_actor[c] == s}
            self.stages.append(PipelineStageActor.options(**opts).remote(
                kind, meta, own, 0, num_chunks - 1, lr, s, dev.type, init))
        self._num_chunks = num_chunks
        self._chunk_actor = chunk_actor
        # constructor barrier: compile only against live actors
        rt.get([s.stage_stats.remote() for s in self.stages])

        from ray_tpu_torch.dag import InputNode

        with InputNode() as inp:
            # forward chain over chunks 0..n-2; the LAST chunk's forward
            # is fused into its loss_bwd (one forward + backward)
            h = self.stages[0].fwd_first.bind(inp, 0)
            for c in range(1, num_chunks - 1):
                h = self.stages[chunk_actor[c]].fwd.bind(h, c)
            # backward nodes get scheduling priority on their actor:
            # 1F1B's backward-over-forward rule
            last_actor = self.stages[chunk_actor[num_chunks - 1]]
            g = last_actor.loss_bwd.bind(h, inp).with_priority(1)
            for c in range(num_chunks - 2, -1, -1):
                g = self.stages[chunk_actor[c]].bwd.bind(g, c) \
                    .with_priority(1)
        self._dag = g.experimental_compile(
            buffer_size_bytes=buffer_size_bytes,
            device_channels=True,
            max_inflight=self.max_inflight)
        self._warmed = False
        self._armed_m = 0
        self._pipeline_wall_s = 0.0
        self._microbatches_run = 0
        self._torn_down = False

    # ---- schedule ----

    def _split_inputs(self, x, y, num_microbatches: int):
        if self.model == "llama":
            tokens = np.asarray(x, dtype=np.int32)
            if len(tokens) % num_microbatches:
                raise ValueError(
                    f"batch of {len(tokens)} does not split into "
                    f"{num_microbatches} equal microbatches")
            return [t for t in np.split(tokens, num_microbatches)]
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        if len(x) % num_microbatches:
            raise ValueError(
                f"batch of {len(x)} does not split into "
                f"{num_microbatches} equal microbatches")
        return list(zip(np.split(x, num_microbatches),
                        np.split(y, num_microbatches)))

    def _warmup(self, mb, timeout: float) -> None:
        """One throwaway microbatch to load every stage's kernels and
        libraries outside the measured/loss-bearing path, then reset
        stage state (params untouched — no apply path runs: auto-apply
        is disarmed and apply_grads is never called)."""
        self._dag.execute(mb, timeout=timeout).get(timeout=timeout)
        rt.get([s.reset_state.remote() for s in self.stages])
        self._warmed = True

    def _arm(self, num_microbatches: int) -> None:
        """1F1B: tell every stage at which backward count to self-apply
        (one eager barrier, only when M changes — step boundaries are
        pipeline flushes, so this never races in-flight microbatches)."""
        target = num_microbatches if self.schedule == "1f1b" else 0
        if self._armed_m == target:
            return
        rt.get([s.set_step_microbatches.remote(target)
                for s in self.stages])
        self._armed_m = target

    def train_step(self, x, y=None, num_microbatches: int = 4,
                   timeout: float = 120.0) -> float:
        """One full-batch step = M microbatches streamed through the
        compiled pipeline. 1F1B: in-flight window K, stages self-apply
        their update as their last backward lands (inside the drain);
        the driver then reads the step loss with one cheap call. GPipe:
        window max_inflight, then an eager apply_grads() barrier."""
        if self._torn_down:
            raise RuntimeError("trainer was shut down")
        mbs = self._split_inputs(x, y, num_microbatches)
        if not self._warmed:
            self._warmup(mbs[0], timeout)
        self._arm(num_microbatches)
        t0 = time.perf_counter()
        _t = _fr.now()
        # sliding window: at most ``window`` microbatches outstanding.
        # The output ring (max_inflight >= window deep) can always
        # absorb every in-flight result — the driver never holds the
        # submit side while the drain side is the only way forward.
        pending: collections.deque = collections.deque()
        for mb in mbs:
            if len(pending) >= self.window:
                pending.popleft().get(timeout=timeout)
            pending.append(self._dag.execute(mb, timeout=timeout))
        while pending:
            pending.popleft().get(timeout=timeout)
        self._pipeline_wall_s += time.perf_counter() - t0
        _sp_step.end(_t)
        _g_step_seconds.set(time.perf_counter() - t0,
                            tags={"loop": "pipeline"})
        self._microbatches_run += num_microbatches
        if self.schedule == "1f1b":
            # updates already applied stage-locally during the drain;
            # one eager read fetches the recorded step loss
            return rt.get(self.stages[-1].collect_loss.remote())
        losses = rt.get([s.apply_grads.remote() for s in self.stages])
        return losses[-1]

    def fit(self, x, y=None, steps: int = 1,
            num_microbatches: int = 4) -> List[float]:
        return [self.train_step(x, y, num_microbatches)
                for _ in range(steps)]

    # ---- introspection ----

    def get_params(self):
        """MLP: flat (W, b) list across chunks in pipeline order.
        Llama: list of per-chunk param trees in pipeline order (==
        per-stage when virtual_stages is 1). Leaves are numpy."""
        per_stage = rt.get([s.get_params.remote() for s in self.stages])
        chunks: Dict[int, Any] = {}
        for d in per_stage:
            chunks.update(d)
        ordered = [chunks[c] for c in range(self._num_chunks)]
        if self.model == "llama":
            return ordered
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        for chunk in ordered:
            out.extend(chunk)
        return out

    def pipeline_stats(self) -> Dict[str, Any]:
        """Measured pipeline efficiency: busy time summed over stages
        against K x wall (the pipeline's capacity to do work). The
        complement is the bubble fraction — GPipe's theoretical floor is
        (K-1)/(M+K-1) per flush; 1F1B shares the floor but keeps the
        activation window at K and fills the drain with weight updates."""
        stats = rt.get([s.stage_stats.remote() for s in self.stages])
        busy = sum(s["busy_s"] for s in stats)
        wall = self._pipeline_wall_s
        k = self.num_stages
        eff = busy / (k * wall) if wall > 0 else 0.0
        return {
            "num_stages": k,
            "virtual_stages": self.virtual_stages,
            "schedule": self.schedule,
            "model": self.model,
            "max_inflight": self.max_inflight,
            "window": self.window,
            "microbatches_run": self._microbatches_run,
            "pipeline_wall_s": round(wall, 6),
            "stage_busy_s": [round(s["busy_s"], 6) for s in stats],
            "stash_max": max(s["stash_max"] for s in stats),
            "pipeline_efficiency": round(eff, 4),
            "bubble_fraction": round(1.0 - eff, 4),
        }

    def channel_stats(self) -> List[Dict[str, int]]:
        """Per-stage channel byte accounting (the typed-tensor-path
        proof: serialized_bytes must stay flat across training)."""
        return rt.get([s.channel_stats.remote() for s in self.stages])

    def shutdown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        self._dag.teardown()
        for s in self.stages:
            try:
                rt.kill(s)
            except Exception:
                pass


# ------------------------------------------------- in-process reference


def _replay(chunks: List[_Chunk], mbs, steps: int, lr: float,
            first_input, target) -> List[float]:
    """The pipeline computation in one process, in pipeline order: each
    microbatch forward through the chunks, loss + grad at the last, the
    backward chain; then every chunk's mean-grad SGD step. The same
    chunk math the stage actors run."""
    losses = []
    for _ in range(steps):
        for mb in mbs:
            h = first_input(mb)
            for ch in chunks[:-1]:
                h = ch.forward(h)
            g = chunks[-1].loss_backward(h, target(mb))
            for ch in reversed(chunks[:-1]):
                g = ch.backward(g)
        for ch in chunks[:-1]:
            ch.apply_step(lr)
        losses.append(chunks[-1].apply_step(lr))
    return losses


def reference_train_losses(layer_sizes: Sequence[int], seed: int,
                           x: np.ndarray, y: np.ndarray, steps: int,
                           num_microbatches: int, num_stages: int,
                           lr: float = 0.05,
                           params: Optional[List] = None,
                           return_params: bool = False, device=None):
    """Single-process replay of the exact pipeline computation on
    ``device`` (``cuda`` unless given): same stage split, same per-stage
    backward, same mean-over-microbatch grad accumulation, same SGD step
    — so the distributed trainer matches these losses to numerical noise
    (both schedules: 1F1B reorders execution, not math)."""
    dev = resolve_device(device)
    if params is None:
        params = init_mlp_params(layer_sizes, seed)
    chunks = [_Chunk("mlp", None, st, s, s == 0, s == num_stages - 1, dev)
              for s, st in enumerate(split_stages(params, num_stages))]
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    mbs = list(zip(np.split(x, num_microbatches),
                   np.split(y, num_microbatches)))
    losses = _replay(chunks, mbs, steps, lr,
                     lambda mb: _to_tensor(mb[0], dev),
                     lambda mb: _to_tensor(mb[1], dev))
    if return_params:
        flat = []
        for ch in chunks:
            flat.extend(_tree_map(_to_numpy, ch.params))
        return losses, flat
    return losses


def reference_llama_losses(cfg, seed: int, tokens: np.ndarray, steps: int,
                           num_microbatches: int, num_stages: int,
                           lr: float = 0.05, params=None,
                           return_params: bool = False, device=None):
    """Single-process replay of the llama-stage pipeline on ``device``
    (``cuda`` unless given): same block slicing, same per-stage backward,
    same mean-grad SGD step. ``params=None`` is the trainer's seeded init
    (the port's ``init_params`` on ``device``)."""
    dev = resolve_device(device)
    chunk_params = dict(enumerate(
        split_llama_stages(cfg, params, num_stages) if params is not None
        else [None] * num_stages))
    init = None if params is not None else (seed, num_stages)
    by_cid = _make_chunks("llama", cfg, chunk_params, 0, num_stages - 1,
                          dev, init)
    chunks = [by_cid[c] for c in range(num_stages)]
    tokens = np.asarray(tokens, dtype=np.int32)
    mbs = [_to_tensor(t, dev) for t in np.split(tokens, num_microbatches)]
    losses = _replay(chunks, mbs, steps, lr, lambda mb: mb[:, :-1],
                     lambda mb: mb)
    if return_params:
        return losses, [_tree_map(_to_numpy, ch.params) for ch in chunks]
    return losses

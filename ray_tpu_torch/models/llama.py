"""Llama-3-family decoder (port of ``ray_tpu/models/llama.py``): serving,
the single-device train step and the tensor-parallel layer.

The model is an ``nn.Module`` holding the parameters in the JAX package's
layout: layers stacked on a leading ``[L, ...]`` axis, float32 at rest.
Its state-dict keys are the JAX param tree's paths with ``.`` for ``/``
(``embedding``, ``layers.wq`` ... ``layers.mlp_norm``, ``final_norm``,
``lm_head``). The compute is plain functions over a nested dict of
tensors (:meth:`Llama.tree`), matmuls in ``cfg.dtype`` with float32
norms and softmax, as in the JAX package.

Prefill and training attention (causal self-attention, Tq == Tk) go
through :func:`ray_tpu_torch.ops.flash_attention.flash_attention`, the
dispatch JAX's ``forward`` uses for the same computation: on the card
that is the hand-written forward kernel, and in training its backward
kernels. Single-token decode attends over a page-padded cache view with
plain torch ops.

The decode engine runs prefill and decode through the program
observatory (``util/program_observatory.py``) as ``llama.prefill`` and
``llama.decode``, and the pipeline step as ``llama.pipe_init`` /
``llama.pipe_train_step``, as the JAX package observes its jitted ones;
the single-device step is not observed, as in JAX.

Training (:func:`make_train_step`) is JAX's single-device step: per-layer
remat (``torch.utils.checkpoint``), the sequence-chunked fp32 cross
entropy, AdamW at optax's settings, the state updated in place where JAX
donates it. The tensor-parallel pieces (:func:`tp_psum_pair`,
:func:`vp_embed`, :func:`vp_chunk_nll` and the local-shard layer
``_pp_layer``, whose attention is the ring of
``parallel/ring_attention.py`` when it is given a ``seq`` group) serve
the sharded steps in ``train/spmd.py`` and the GPipe pipeline step
:func:`make_pipeline_train_step` (``parallel/pipeline.py``'s schedule).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import COMPUTE_DTYPE, PARAM_DTYPE, resolve_device
from ray_tpu_torch.collective.collective import _leaves, _map, pmean_tree
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.layers import rms_norm, rotary_embedding
from ray_tpu_torch.parallel.mesh import P, axis_sizes, data_axes
from ray_tpu_torch.parallel.pipeline import make_pipelined_fn
from ray_tpu_torch.parallel.ring_attention import ring_attention_local
from ray_tpu_torch.parallel.sharding import shard_device_put
from ray_tpu_torch.serve.kv_cache import PagePool, PrefixCache, pages_for
from ray_tpu_torch.util.metrics import Gauge
from ray_tpu_torch.util.program_observatory import observe_program

# the decode engine's padded-bucket contract made measurable: each
# distinct padded KV length is one input fingerprint of its program, so
# this gauge sits next to port_program_variants{program=llama.decode}
_g_decode_buckets = Gauge(
    "port_serve_decode_buckets",
    "Distinct padded KV lengths (compile buckets) the decode engine "
    "has served", tag_keys=("kind",))


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = COMPUTE_DTYPE  # compute dtype (params stored fp32)
    remat: bool = True
    loss_chunk: int = 256  # seq-chunk for the xent head; 0 = unchunked

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, dim=2048, n_layers=16,
                           n_heads=32, n_kv_heads=8, mlp_dim=8192)

    @staticmethod
    def small(vocab_size: int = 32000) -> "LlamaConfig":
        """~110M params."""
        return LlamaConfig(vocab_size=vocab_size, dim=768, n_layers=12,
                           n_heads=12, n_kv_heads=4, mlp_dim=2048,
                           max_seq_len=2048)

    @staticmethod
    def medium(vocab_size: int = 32000) -> "LlamaConfig":
        """~500M params, head_dim 80."""
        return LlamaConfig(vocab_size=vocab_size, dim=1280, n_layers=20,
                           n_heads=16, n_kv_heads=8, mlp_dim=5120,
                           max_seq_len=2048)

    @staticmethod
    def bench(vocab_size: int = 32000) -> "LlamaConfig":
        """~660M params, head_dim 128."""
        return LlamaConfig(vocab_size=vocab_size, dim=1536, n_layers=16,
                           n_heads=12, n_kv_heads=6, mlp_dim=6144,
                           max_seq_len=2048)

    @staticmethod
    def flagship(vocab_size: int = 32000) -> "LlamaConfig":
        """~1.04B params, head_dim 128."""
        return LlamaConfig(vocab_size=vocab_size, dim=2048, n_layers=16,
                           n_heads=16, n_kv_heads=8, mlp_dim=7168,
                           max_seq_len=2048)

    @staticmethod
    def debug() -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, mlp_dim=128, max_seq_len=128,
                           remat=False)

    def num_params(self) -> int:
        d, v, l = self.dim, self.vocab_size, self.n_layers
        attn = d * d + 2 * d * (self.n_kv_heads * self.head_dim) + d * d
        mlp = 3 * d * self.mlp_dim
        per_layer = attn + mlp + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return emb + l * per_layer + d


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #

# leaves that feed a matmul: cast to the compute dtype (norms stay fp32)
_MATMUL_LEAVES = ("embedding", "lm_head", "wq", "wk", "wv", "wo", "w_gate",
                  "w_up", "w_down")


def param_logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Per-leaf logical axis names (leading 'layers' = the stacked axis),
    the JAX package's table; multi-device training maps them to a mesh."""
    layer = {
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "attn_norm": ("layers", None),
        "mlp_norm": ("layers", None),
    }
    out = {
        "embedding": ("vocab", "embed"),
        "layers": layer,
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    return out


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """``/``-joined param path -> shape, the JAX param tree's layout."""
    d, hd, L = cfg.dim, cfg.head_dim, cfg.n_layers
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    shapes = {
        "embedding": (cfg.vocab_size, d),
        "layers/wq": (L, d, nq),
        "layers/wk": (L, d, nkv),
        "layers/wv": (L, d, nkv),
        "layers/wo": (L, nq, d),
        "layers/w_gate": (L, d, cfg.mlp_dim),
        "layers/w_up": (L, d, cfg.mlp_dim),
        "layers/w_down": (L, cfg.mlp_dim, d),
        "layers/attn_norm": (L, d),
        "layers/mlp_norm": (L, d),
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def _no_reduced_precision_matmuls() -> None:
    # float32 matmuls stay float32 (no TF32 in cuBLAS or cuDNN), and bf16
    # matmuls reduce in float32: the dtype policy the JAX model states
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class Llama(nn.Module):
    """Llama parameters (uninitialised; see :func:`init_params` and
    :func:`params_from_numpy`) on ``device`` (``cuda`` unless given).
    ``shapes`` (path -> shape) defaults to :func:`param_shapes`; another
    decoder of the family (``models/moe_llama.py``) passes its own."""

    def __init__(self, cfg: LlamaConfig, device=None, shapes=None):
        super().__init__()
        _no_reduced_precision_matmuls()
        dev = resolve_device(device)
        self.cfg = cfg
        self.layers = nn.Module()
        for path, shape in (shapes or param_shapes(cfg)).items():
            owner, name = self, path
            if path.startswith("layers/"):
                owner, name = self.layers, path.split("/", 1)[1]
            owner.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=PARAM_DTYPE, device=dev)))

    def tree(self) -> Dict[str, object]:
        """The parameters as the nested dict the model functions take."""
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        out["layers"] = dict(self.layers.named_parameters())
        return out

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.tree(), tokens)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, model: Optional[Llama] = None) -> Llama:
    """Random init as in the JAX package: normal / sqrt(fan_in) for dense
    leaves (fan_in the next-to-last dim; the embedding's is ``dim``),
    ones for norms. ``generator`` must live on ``device``. Fills
    ``model`` when given, else a new :class:`Llama`."""
    model = Llama(cfg, device) if model is None else model
    with torch.no_grad():
        for path, p in model.named_parameters():
            if path.endswith("norm"):
                p.fill_(1.0)
            else:
                fan_in = cfg.dim if path == "embedding" else p.shape[-2]
                p.normal_(generator=generator).mul_(1.0 / math.sqrt(fan_in))
    return model


def params_from_numpy(cfg: LlamaConfig, tree, device=None,
                      model: Optional[Llama] = None) -> Llama:
    """The JAX param tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) turned into the port's model (``model`` when given, else
    a new :class:`Llama`), so both compute the same function."""
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, dict):
                walk(val, path)
            else:
                flat[path] = val

    walk(tree, "")
    model = Llama(cfg, device) if model is None else model
    state = {path.replace(".", "/"): p
             for path, p in model.named_parameters()}
    if set(flat) != set(state):
        raise ValueError(f"param tree paths {sorted(flat)} do not match "
                         f"the model's {sorted(state)}")
    with torch.no_grad():
        for path, p in state.items():
            arr = np.array(flat[path], dtype=np.float32)  # writable copy
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{path}: shape {arr.shape}, model wants "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return model


def compute_params(cfg: LlamaConfig, params: Llama, device=None):
    """The model's params as a nested dict on ``device`` with the matmul
    weights cast to ``cfg.dtype`` once: the values JAX's per-matmul
    ``.astype(cd)`` produces, without the cast on every call."""
    dev = resolve_device(device)

    def cast(name, p):
        dtype = cfg.dtype if name in _MATMUL_LEAVES else p.dtype
        return p.detach().to(device=dev, dtype=dtype)

    tree = params.tree()
    out = {k: cast(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: cast(k, v) for k, v in tree["layers"].items()}
    return out


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #


def embed_tokens(cfg: LlamaConfig, params, tokens: torch.Tensor):
    """Token embedding lookup (replicated table: a plain gather)."""
    return params["embedding"][tokens].to(cfg.dtype)


def _identity(x):
    return x


def _qkv(cfg: LlamaConfig, x, p, positions, col_in=_identity):
    """Pre-norm, the q/k/v projections and RoPE of one layer:
    x [B, T, dim] -> q [B, T, Hq, D], k and v [B, T, Hkv, D] (cfg.dtype).
    Head counts come from the weights' widths, so a tensor-parallel shard
    gives its local heads; ``col_in`` enters the column-parallel region."""
    cd = cfg.dtype
    B, T, _ = x.shape
    hd = cfg.head_dim
    h = col_in(rms_norm(x, p["attn_norm"], cfg.norm_eps).to(cd))
    q = (h @ p["wq"].to(cd)).view(B, T, -1, hd)
    kk = (h @ p["wk"].to(cd)).view(B, T, -1, hd)
    vv = (h @ p["wv"].to(cd)).view(B, T, -1, hd)
    q, kk = rotary_embedding(q, kk, positions, cfg.rope_theta)
    return q, kk, vv


def _attn_out(cfg: LlamaConfig, x, attn, p, row_out=_identity):
    """The wo projection of ``attn`` [B, T, Hq, D] added to the residual
    stream x [B, T, dim]; under tensor parallelism ``row_out`` sums the
    row-parallel projection's partial outputs."""
    B, T, _ = x.shape
    return x + row_out(attn.reshape(B, T, -1)
                       @ p["wo"].to(cfg.dtype)).to(x.dtype)


def _attn_out_and_mlp(cfg: LlamaConfig, x, attn, p, col_in=_identity,
                      row_out=_identity):
    """:func:`_attn_out`, then the SwiGLU MLP added to the residual
    stream. Under tensor parallelism ``col_in`` enters the MLP's
    column-parallel region and ``row_out`` leaves it."""
    cd = cfg.dtype
    x = _attn_out(cfg, x, attn, p, row_out)
    h = col_in(rms_norm(x, p["mlp_norm"], cfg.norm_eps).to(cd))
    g = F.silu(h @ p["w_gate"].to(cd))
    u = h @ p["w_up"].to(cd)
    return x + row_out((g * u) @ p["w_down"].to(cd)).to(x.dtype)


def _layer_kv(cfg: LlamaConfig, x, p, positions):
    """One decoder layer that also returns its (rotated) k/v, the bytes
    the paged cache stores. x: [B, T, dim] residual stream (cfg.dtype)."""
    q, kk, vv = _qkv(cfg, x, p, positions)
    attn = flash_attention(q, kk, vv, causal=True)
    return _attn_out_and_mlp(cfg, x, attn, p), kk, vv


def _layer(cfg: LlamaConfig, x, p, positions):
    """One decoder layer. x: [B, T, dim] (residual stream, cfg.dtype)."""
    return _layer_kv(cfg, x, p, positions)[0]


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32, device=device)[None, :] \
        .expand(B, T)


def _unbind_layers(params) -> List[Dict[str, torch.Tensor]]:
    """Every layer's params as views of the stacked leaves, taken at once:
    under autograd each leaf's backward is one ``stack``, where indexing
    layer by layer would write a zero tensor of the whole leaf per layer."""
    names = list(params["layers"])
    slices = [params["layers"][k].unbind(0) for k in names]
    return [dict(zip(names, layer)) for layer in zip(*slices)]


def _backbone(cfg: LlamaConfig, params, tokens: torch.Tensor):
    """tokens [B, T] -> final-normed hidden states [B, T, dim]. With
    ``cfg.remat`` and grad on, each layer runs under checkpoint (its
    activations are recomputed in the backward pass)."""
    B, T = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(B, T, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _unbind_layers(params):
        if remat:
            x = checkpoint(_layer, cfg, x, p, positions, use_reentrant=False)
        else:
            x = _layer(cfg, x, p, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head(cfg: LlamaConfig, params):
    return params["embedding"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg: LlamaConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, vocab] (cfg.dtype)."""
    x = _backbone(cfg, params, tokens)
    return x.to(cfg.dtype) @ _head(cfg, params).to(cfg.dtype)


# --------------------------------------------------------------------------- #
# Loss and train step
# --------------------------------------------------------------------------- #

ChunkNll = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _plain_chunk_nll(cfg: LlamaConfig, head: torch.Tensor) -> ChunkNll:
    """Per-chunk next-token NLL against a full-width head [d, vocab]:
    fp32 log-softmax over the whole vocab."""

    def chunk_nll(x_c, t_c):
        # the head is cast inside each chunk, as in the JAX package, so
        # the chunks' gradients add up in the fp32 head, not in bf16
        logits = (x_c.to(cfg.dtype) @ head.to(cfg.dtype)).float()
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, t_c[..., None])[..., 0]

    return chunk_nll


def chunked_nll_mean(cfg: LlamaConfig, x: torch.Tensor,
                     targets: torch.Tensor, chunk_nll: ChunkNll):
    """Mean NLL with the lm_head matmul and softmax chunked over the
    sequence, each chunk under checkpoint: fp32 logits exist for one
    chunk at a time ([B, C, vocab], not [B, T, vocab]) and are recomputed
    in the backward pass. Chunk sums are added in order, then the
    remainder chunk, then divided by B*T, as in the JAX package."""
    B, T, _ = x.shape
    C = cfg.loss_chunk
    if not C or T <= C:
        return chunk_nll(x, targets).mean()

    def chunk_sum(x_c, t_c):
        return chunk_nll(x_c, t_c).sum()

    n, rem = divmod(T, C)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * C, (i + 1) * C)
        total = total + checkpoint(chunk_sum, x[:, sl], targets[:, sl],
                                   use_reentrant=False)
    if rem:
        total = total + chunk_sum(x[:, n * C:], targets[:, n * C:])
    return total / (B * T)


def loss_fn(cfg: LlamaConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy, fp32 log-softmax. tokens [B, T+1]."""
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = _backbone(cfg, params, inputs)
    return chunked_nll_mean(cfg, x, targets,
                            _plain_chunk_nll(cfg, _head(cfg, params)))


def _init_model(cfg: LlamaConfig, init, device, model=None) -> Llama:
    """The model (``model``, uninitialised, when given) from a seed
    (:func:`init_params` from a ``torch.Generator`` on ``device``) or
    from a JAX param tree as numpy arrays (:func:`params_from_numpy`)."""
    if isinstance(init, dict):
        return params_from_numpy(cfg, init, device, model)
    gen = torch.Generator(device=device).manual_seed(int(init))
    return init_params(cfg, gen, device, model)


def _make_optimizer(optimizer, params) -> torch.optim.Optimizer:
    """``optimizer(params)``, or AdamW at the JAX step's optax settings
    when ``optimizer`` is None (the train steps' default)."""
    if optimizer is not None:
        return optimizer(params)
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=0.1)


def make_train_step(cfg: LlamaConfig, device=None, optimizer=None):
    """Build ``(init_state, train_step)`` for one device (``cuda`` unless
    ``device`` says otherwise).

    ``init_state(init=0)`` takes a seed (``init_params`` from a
    ``torch.Generator``) or a JAX param tree as numpy arrays
    (:func:`params_from_numpy`) and returns ``{"params": Llama,
    "opt_state": optimizer, "step": 0}``. ``optimizer`` maps the model's
    parameters to a ``torch.optim.Optimizer``; the default is AdamW at
    the JAX step's optax settings (lr 3e-4, betas (0.9, 0.95), eps 1e-8,
    weight decay 0.1 on every leaf, norms and embedding included).

    ``train_step(state, tokens)`` (tokens [B, T+1]) takes one step, updates
    the state in place (JAX donates it) and returns the loss. The
    gradients of the step stay in the parameters' ``.grad`` until the
    next step.
    """
    dev = resolve_device(device)

    def init_state(init=0):
        model = _init_model(cfg, init, dev)
        return {"params": model, "opt_state": _make_optimizer(
            optimizer, model.parameters()), "step": 0}

    def train_step(state, tokens: torch.Tensor) -> torch.Tensor:
        model, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(cfg, model.tree(), tokens.to(dev))
        loss.backward()
        opt.step()
        state["step"] += 1
        return loss.detach()

    return init_state, train_step


# --------------------------------------------------------------------------- #
# Tensor-parallel collectives (manual/Megatron style)
# --------------------------------------------------------------------------- #


class _EnterColumnParallel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, ct):
        # a copy: autograd may hand the same gradient to another branch
        ct = ct.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


class _LeaveRowParallel(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def tp_psum_pair(group):
    """Megatron 'f'/'g' collective pair over the tensor axis' process
    ``group``, for exact grads: ``f`` (identity forward / all-reduce
    backward) enters a column-parallel region, ``g`` (all-reduce forward /
    identity backward) leaves a row-parallel one. A plain differentiable
    all-reduce would all-reduce the already-replicated cotangent again in
    the backward pass, inflating every upstream grad by the axis size."""
    return (lambda x: _EnterColumnParallel.apply(x, group),
            lambda x: _LeaveRowParallel.apply(x, group))


def vp_embed(cfg: LlamaConfig, emb_local, tokens, axis, gp):
    """Vocab-parallel embedding lookup on a local shard [V/t, dim]:
    masked local take + all-reduce over the process group ``axis``
    assembles each token's row from whichever rank owns its id. ``gp`` is
    the all-reduce-forward / identity-backward half of
    :func:`tp_psum_pair`, so the backward scatter-adds straight into the
    local rows."""
    vloc = emb_local.shape[0]
    local = tokens - dist.get_rank(axis) * vloc
    ok = (local >= 0) & (local < vloc)
    rows = emb_local[local.clamp(0, vloc - 1)].to(cfg.dtype)
    return gp(torch.where(ok[..., None], rows, torch.zeros_like(rows)))


def vp_chunk_nll(cfg: LlamaConfig, head_local, axis, gp) -> ChunkNll:
    """Per-chunk NLL against a vocab-sharded head [d, V/t] (Megatron
    vocab-parallel cross-entropy): replicated logsumexp from the
    all-reduced max of the local maxima plus the all-reduced local
    sum-exp; the target logit by masked local take + all-reduce. The max
    is taken on a detached operand, as JAX's ``stop_gradient``: the shift
    is the gradient-free logsumexp stabilizer."""
    vloc = head_local.shape[-1]

    def chunk_nll(x_c, t_c):
        logits = (x_c.to(cfg.dtype) @ head_local.to(cfg.dtype)).float()
        m = logits.detach().amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=axis)
        lse = torch.log(gp(torch.exp(logits - m[..., None]).sum(-1))) + m
        local = t_c - dist.get_rank(axis) * vloc
        ok = (local >= 0) & (local < vloc)
        picked = logits.gather(-1, local.clamp(0, vloc - 1)[..., None])
        tlogit = gp(torch.where(ok, picked[..., 0],
                                torch.zeros_like(picked[..., 0])))
        return lse - tlogit

    return chunk_nll


def _pp_layer(cfg: LlamaConfig, x, p, positions, collectives=None,
              seq_group=None):
    """One decoder layer on *local* shards: head and MLP counts come from
    the shard shapes (Megatron-style manual TP: q/k/v/gate/up
    column-parallel, entered through ``f``; wo/down row-parallel, left
    through ``g``). Norm weights are full-width (replicated).
    ``collectives`` is the ``(f, g)`` pair from :func:`tp_psum_pair`, or
    None without a tensor axis. Attention runs on the local heads through
    :func:`flash_attention`; with ``seq_group`` (the ``seq`` axis'
    process group) x is this rank's slice of the sequence, ``positions``
    its global positions, and attention is the ring
    (:func:`ring_attention_local`), GQA K/V carried unrepeated."""
    col_in, row_out = collectives if collectives is not None \
        else (_identity, _identity)
    q, kk, vv = _qkv(cfg, x, p, positions, col_in)
    if seq_group is None:
        attn = flash_attention(q, kk, vv, causal=True)
    else:
        attn = ring_attention_local(q, kk, vv, seq_group, causal=True)
    return _attn_out_and_mlp(cfg, x, attn, p, col_in, row_out)


def _check_mesh(cfg: LlamaConfig, mesh, dev: torch.device) -> None:
    """Raise unless a live ``tensor`` axis divides the heads, the MLP and
    the vocab, and the mesh is on the step's device type."""
    t = axis_sizes(mesh).get("tensor", 1)
    for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("mlp_dim", cfg.mlp_dim), ("vocab_size", cfg.vocab_size)):
        if n % t:
            raise ValueError(
                f"tensor axis size {t} does not divide cfg.{what}={n}")
    if mesh.device_type != dev.type:
        raise ValueError(f"mesh is on {mesh.device_type!r}, the step on "
                         f"{dev.type!r}")


# --------------------------------------------------------------------------- #
# Pipeline-parallel train step (pipe [+ tensor/data] mesh axes)
# --------------------------------------------------------------------------- #


def pipeline_param_specs(cfg: LlamaConfig, mesh) -> Dict[str, Any]:
    """PartitionSpec of each leaf of the param tree (layers stacked
    ``[L, ...]``) under :func:`make_pipeline_train_step`: the layer dim
    cut into contiguous stages over ``pipe``, heads and MLP over a live
    ``tensor`` axis (JAX's ``layer_specs``), the vocab of the embedding
    and head over it too; norms replicated."""
    ta = "tensor" if "tensor" in mesh.mesh_dim_names else None
    col, row = P("pipe", None, ta), P("pipe", ta, None)
    specs: Dict[str, Any] = {
        "embedding": P(ta, None),
        "layers": {"wq": col, "wk": col, "wv": col, "wo": row,
                   "w_gate": col, "w_up": col, "w_down": row,
                   "attn_norm": P("pipe", None), "mlp_norm": P("pipe", None)},
        "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, ta)
    return specs


def make_pipeline_train_step(cfg: LlamaConfig, mesh, num_microbatches: int,
                             optimizer=None, device=None):
    """GPipe pipeline-parallel train step for this rank of a mesh with a
    ``pipe`` axis (port of the JAX package's ``make_pipeline_train_step``).

    The layers split into ``P`` contiguous stages (``[L] -> [P, L/P]``;
    this rank keeps its stage), run by ``parallel/pipeline.py``'s GPipe
    schedule over ``num_microbatches`` microbatches of this rank's rows.
    ``tensor`` shards heads, MLP and vocab inside a stage, through
    :func:`tp_psum_pair` (torch differentiates the region, where JAX's
    pipeline differentiates outside it and keeps the raw psum).
    ``data``/``fsdp`` act as pure data parallelism (grads averaged over
    them), as in JAX. The embedding and head run outside the region,
    replicated over ``pipe``: vocab-parallel under ``tensor``
    (:func:`vp_embed`, :func:`vp_chunk_nll`), else a plain lookup.

    Every stage computes the same loss from the same outputs, and it
    counts once: the head's and final norm's grads are not summed over
    ``pipe``, and stage 0's embedding grad (the lookup's, which only stage
    0 has, plus with tied embeddings the head's, alike on every stage) is
    sent to every stage. The loss is :func:`chunked_nll_mean`'s, the
    function JAX's unchunked fp32 log-softmax computes (the same ops at
    ``loss_chunk`` 0).

    ``init_state(init=0)`` (a seed, or a JAX param tree as numpy with the
    layers ``[L, ...]``) and ``train_step(state, tokens)`` (this rank's
    rows of the global batch, ``parallel.mesh.batch_sharding(mesh)``,
    int ``[b, T+1]``; returns the loss, the mean over the batch axes) as
    in ``train/spmd.py:make_spmd_train_step``; ``optimizer`` likewise.
    Raises as JAX's does on a mesh with no ``pipe`` axis and on
    ``L % P``; refuses a live ``seq`` or ``expert`` axis (the MoE
    decoder's expert axis is ``models/moe_llama.py:make_train_step``'s,
    and it has no pipeline step yet)."""
    dev = resolve_device(device)
    sizes = axis_sizes(mesh)
    if "pipe" not in sizes:
        raise ValueError("mesh has no 'pipe' axis")
    n_stages = sizes["pipe"]
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible by "
                         f"{n_stages} pipeline stages")
    for ax in ("seq", "expert"):
        if ax in sizes:
            raise ValueError(f"make_pipeline_train_step shards over pipe + "
                             f"batch axes + tensor; mesh has live {ax!r} "
                             f"axis" + (" — the MoE decoder's expert axis "
                                        "is models/moe_llama.py:"
                                        "make_train_step's"
                                        if ax == "expert" else ""))
    _check_mesh(cfg, mesh, dev)
    specs = pipeline_param_specs(cfg, mesh)
    batch_axes = data_axes(mesh)
    pipe_group = mesh.get_group("pipe")
    first_stage = dist.get_global_rank(pipe_group, 0)
    tensor = "tensor" if "tensor" in sizes else None
    tp_group = mesh.get_group(tensor) if tensor is not None else None
    collectives = tp_psum_pair(tp_group) if tensor is not None else None

    def init_state(init=0):
        tree = _init_model(cfg, init, dev).tree()
        params = _map(lambda spec, x: shard_device_put(
            x.detach(), mesh, spec, dev).requires_grad_(True), specs, tree)
        return {"params": params, "step": 0,
                "opt_state": _make_optimizer(optimizer, _leaves(params))}

    def stage_fn(stage, act):
        positions = act["pos"]

        def layer(h, p):
            return _pp_layer(cfg, h, p, positions, collectives)

        h = act["x"]
        for p in _unbind_layers({"layers": stage}):
            h = checkpoint(layer, h, p, use_reentrant=False) if cfg.remat \
                else layer(h, p)
        return {"x": h, "pos": positions}

    pipe_fn = make_pipelined_fn(stage_fn, mesh, num_microbatches)

    def loss_of(params, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        B, T = inputs.shape
        emb = params["embedding"]
        if tensor is not None:
            x = vp_embed(cfg, emb, inputs, tp_group, collectives[1])
        else:
            x = emb[inputs].to(cfg.dtype)
        x = pipe_fn(params["layers"],
                    {"x": x, "pos": _positions(B, T, x.device)})["x"]
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = emb.T if cfg.tie_embeddings else params["lm_head"]
        if tensor is not None:
            return chunked_nll_mean(
                cfg, collectives[0](x), targets,
                vp_chunk_nll(cfg, head, tp_group, collectives[1]))
        return chunked_nll_mean(cfg, x, targets, _plain_chunk_nll(cfg, head))

    def train_step(state, tokens: torch.Tensor) -> torch.Tensor:
        params, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        loss = loss_of(params, tokens.to(dev).long())
        loss.backward()
        emb = params["embedding"]
        if emb.grad is None:  # a later stage without tied embeddings
            emb.grad = torch.zeros_like(emb)
        dist.broadcast(emb.grad, src=first_stage, group=pipe_group)
        for p in _leaves(params):
            pmean_tree(p.grad, mesh, batch_axes)
        opt.step()
        state["step"] += 1
        return pmean_tree(loss.detach(), mesh, batch_axes)

    return (observe_program(init_state, "llama.pipe_init"),
            observe_program(train_step, "llama.pipe_train_step"))


# --------------------------------------------------------------------------- #
# Generative decode (paged KV cache: serve/kv_cache.py owns the pages)
# --------------------------------------------------------------------------- #


def _gqa_repeat(cfg: LlamaConfig, k, v):
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def prefill_with_cache(cfg: LlamaConfig, params, tokens: torch.Tensor):
    """tokens [1, T] (right-padded is fine: causal masking keeps pad
    garbage out of real positions) -> (logits [1, T, vocab] fp32,
    k [L, 1, T, n_kv, head_dim], v [...]): k/v are post-RoPE, the bytes
    the paged cache stores."""
    B, T = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(B, T, tokens.device)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for p in _unbind_layers(params):
        x, kk, vv = _layer_kv(cfg, x, p, positions)
        ks.append(kk)
        vs.append(vv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x.to(cfg.dtype) @ _head(cfg, params).to(cfg.dtype)).float()
    return logits, torch.stack(ks), torch.stack(vs)


def _layer_decode(cfg: LlamaConfig, x, p, positions, k_cache, v_cache,
                  length: int):
    """One decoder layer for a single new token against a page-padded KV
    view ``k_cache``/``v_cache`` [Tpad, n_kv, head_dim] (positions >=
    ``length`` are pad garbage, masked out). Returns the residual stream
    and the new token's k/v for the cache write."""
    cd = cfg.dtype
    q, kk, vv = _qkv(cfg, x, p, positions)
    Tpad = k_cache.shape[0]
    K = torch.cat([k_cache.to(cd)[None], kk], dim=1)
    V = torch.cat([v_cache.to(cd)[None], vv], dim=1)
    K, V = _gqa_repeat(cfg, K, V)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), K.float()) * scale
    idx = torch.arange(Tpad + 1, device=x.device)
    valid = (idx < length) | (idx == Tpad)  # history + the token itself
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    probs = torch.softmax(s, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, V.float()).to(cd)
    return _attn_out_and_mlp(cfg, x, attn, p), kk[:, 0], vv[:, 0]


def decode_step_with_cache(cfg: LlamaConfig, params, token: torch.Tensor,
                           pos: int, k_cache, v_cache):
    """One decode step. token [1] int; pos: the KV write position (tokens
    so far); k/v_cache [L, Tpad, n_kv, head_dim] page-padded views ->
    (logits [vocab] fp32, k_new [L, n_kv, head_dim], v_new [...])."""
    x = embed_tokens(cfg, params, token[None, :])
    positions = torch.full((1, 1), pos, dtype=torch.int32,
                           device=token.device)
    kns, vns = [], []
    for i, p in enumerate(_unbind_layers(params)):
        x, kn, vn = _layer_decode(cfg, x, p, positions, k_cache[i],
                                  v_cache[i], pos)
        kns.append(kn)
        vns.append(vn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x.to(cfg.dtype) @ _head(cfg, params).to(cfg.dtype)).float()
    return logits[0, 0], torch.stack(kns)[:, 0], torch.stack(vns)[:, 0]


class LlamaDecodeEngine:
    """Paged-KV decode engine over the llama model: the engine protocol
    :class:`ray_tpu_torch.serve.decode.DecodeScheduler` drives
    (prefill/decode/copy_page + pool/prefix_cache/page_size).

    Physical pages live in two device tensors in ``cfg.dtype`` indexed by
    pool page id: ``[n_pages, page_size, L, n_kv, head_dim]``. prefill
    scatters the layers' k/v into pages; decode gathers the sequence's
    page table into a page-padded view (positions beyond the true length
    are masked). Runs on ``cuda`` unless ``device`` says otherwise."""

    def __init__(self, cfg: Optional[LlamaConfig] = None,
                 params: Optional[Llama] = None, *, n_pages: int = 64,
                 page_size: int = 8, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or LlamaConfig.debug()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen, self.device)
        self.params = compute_params(self.cfg, params, self.device)
        self.page_size = int(page_size)
        self.pool = PagePool(n_pages, page_size)
        self.prefix_cache = PrefixCache(self.pool)
        c = self.cfg
        shape = (n_pages, page_size, c.n_layers, c.n_kv_heads, c.head_dim)
        self.k_store = torch.zeros(shape, dtype=c.dtype, device=self.device)
        self.v_store = torch.zeros(shape, dtype=c.dtype, device=self.device)
        self._prefill_fn = observe_program(
            partial(prefill_with_cache, self.cfg), "llama.prefill")
        self._decode_fn = observe_program(
            partial(decode_step_with_cache, self.cfg), "llama.decode")
        self.prefill_calls = 0
        self.decode_calls = 0
        # distinct padded KV lengths served, per kind
        self._buckets: Dict[str, set] = {"prefill": set(), "decode": set()}

    def buckets(self) -> Dict[str, List[int]]:
        """The padded KV lengths served so far, per kind (``prefill``,
        ``decode``): each is one input fingerprint of its program."""
        return {kind: sorted(b) for kind, b in self._buckets.items()}

    def _note_bucket(self, kind: str, tpad: int) -> None:
        buckets = self._buckets[kind]
        if tpad not in buckets:
            buckets.add(tpad)
            _g_decode_buckets.set(float(len(buckets)),
                                  tags={"kind": kind})

    @torch.inference_mode()
    def prefill(self, tokens, pages) -> np.ndarray:
        self.prefill_calls += 1
        T = len(tokens)
        tpad = len(pages) * self.page_size
        self._note_bucket("prefill", tpad)
        toks = torch.zeros((1, tpad), dtype=torch.long)
        toks[0, :T] = torch.as_tensor(tokens, dtype=torch.long)
        logits, ks, vs = self._prefill_fn(self.params, toks.to(self.device))
        # [L, 1, Tpad, nkv, hd] -> store layout [n, page_size, L, nkv, hd];
        # the tail of the last page gets the pad positions' k/v, which
        # decode masks like any other position >= length
        n = pages_for(T, self.page_size)
        idx = torch.as_tensor(pages[:n], device=self.device)
        span = (n, self.page_size) + tuple(self.k_store.shape[2:])
        self.k_store[idx] = ks[:, 0, :n * self.page_size].transpose(0, 1) \
            .reshape(span)
        self.v_store[idx] = vs[:, 0, :n * self.page_size].transpose(0, 1) \
            .reshape(span)
        return logits[0, T - 1].cpu().numpy()

    @torch.inference_mode()
    def decode_inputs(self, pos, token, pages) -> tuple:
        """The arguments of one decode step's program (``llama.decode``):
        the params, the token, the position and the sequence's page
        table gathered into a page-padded KV view."""
        tpad = len(pages) * self.page_size
        idx = torch.as_tensor(pages, device=self.device)
        rest = tuple(self.k_store.shape[2:])
        # gather [n_seq_pages, page_size, L, nkv, hd] -> [L, Tpad, nkv, hd]
        kc = self.k_store[idx].reshape((tpad,) + rest).transpose(0, 1)
        vc = self.v_store[idx].reshape((tpad,) + rest).transpose(0, 1)
        tok = torch.tensor([int(token)], dtype=torch.long, device=self.device)
        return self.params, tok, int(pos), kc, vc

    @torch.inference_mode()
    def decode(self, pos, token, pages) -> np.ndarray:
        self.decode_calls += 1
        self._note_bucket("decode", len(pages) * self.page_size)
        logits, kn, vn = self._decode_fn(
            *self.decode_inputs(pos, token, pages))
        pg, off = divmod(pos, self.page_size)
        self.k_store[pages[pg], off] = kn
        self.v_store[pages[pg], off] = vn
        return logits.cpu().numpy()

    def copy_page(self, src: int, dst: int) -> None:
        self.k_store[dst] = self.k_store[src]
        self.v_store[dst] = self.v_store[src]

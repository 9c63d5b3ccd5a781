"""MoE decoder, Mixtral-shaped (port of ``ray_tpu/models/moe_llama.py``):
Llama attention with the dense MLP replaced by the expert FFN of
``ops/moe.py``.

The params are the JAX package's tree: the Llama leaves without
``w_gate``/``w_up``/``w_down``, plus per layer a ``router [d, E]`` and
the experts' ``w_gate``, ``w_up [E, d, f]`` and ``w_down [E, f, d]``,
stacked ``[L, ...]`` and float32 at rest (the :class:`MoELlama` module,
a :class:`~ray_tpu_torch.models.llama.Llama` of these shapes). Each
layer is the Llama layer's pre-norm, q/k/v, RoPE and causal attention
through :func:`~ray_tpu_torch.ops.flash_attention.flash_attention` (the
hand-written kernels on the card), its ``wo`` projection, then
:func:`~ray_tpu_torch.ops.moe.moe_ffn` on the MLP pre-norm; it returns
the residual stream and the layer's aux loss. The loss is the mean NLL
plus ``aux_loss_coef`` times the aux averaged over layers.

:func:`make_train_step` is the single-card step (per-layer remat, AdamW
at optax's settings); on a mesh with more than one rank it is
``train/spmd.py:make_moe_train_step``, which takes the batch axes,
``fsdp``, ``expert``, ``tensor`` and ``seq``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import (Llama, LlamaConfig, _attn_out,
                                        _head, _identity, _init_model,
                                        _make_optimizer, _plain_chunk_nll,
                                        _positions, _qkv, _unbind_layers,
                                        chunked_nll_mean, embed_tokens)
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.layers import rms_norm
from ray_tpu_torch.ops.moe import moe_ffn
from ray_tpu_torch.parallel.ring_attention import ring_attention_local


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01

    @staticmethod
    def debug() -> "MoEConfig":
        return MoEConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, mlp_dim=128, max_seq_len=128,
                         remat=False, num_experts=4, top_k=2)

    @staticmethod
    def small(vocab_size: int = 32000) -> "MoEConfig":
        return MoEConfig(vocab_size=vocab_size, dim=768, n_layers=12,
                         n_heads=12, n_kv_heads=4, mlp_dim=1024,
                         max_seq_len=2048, num_experts=8, top_k=2)

    def num_params(self) -> int:
        d, v, L, E = self.dim, self.vocab_size, self.n_layers, self.num_experts
        attn = d * d + 2 * d * (self.n_kv_heads * self.head_dim) + d * d
        moe = d * E + 3 * E * d * self.mlp_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + moe + 2 * d) + d

    def active_params(self) -> int:
        """Params a token's forward touches: every expert's weights but
        its top-k's left out."""
        idle = self.num_experts - self.top_k
        return self.num_params() - self.n_layers * idle * 3 * self.dim \
            * self.mlp_dim


def param_logical_axes(cfg: MoEConfig) -> Dict[str, Any]:
    """Per-leaf logical axis names, the JAX package's table."""
    layer = {
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "router": ("layers", "embed", None),
        "w_gate": ("layers", "expert", "embed", "mlp"),
        "w_up": ("layers", "expert", "embed", "mlp"),
        "w_down": ("layers", "expert", "mlp", "embed"),
        "attn_norm": ("layers", None),
        "mlp_norm": ("layers", None),
    }
    out = {"embedding": ("vocab", "embed"), "layers": layer,
           "final_norm": (None,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    return out


def param_shapes(cfg: MoEConfig) -> Dict[str, Tuple[int, ...]]:
    """``/``-joined param path -> shape, the JAX param tree's layout."""
    d, hd, L, E, f = (cfg.dim, cfg.head_dim, cfg.n_layers, cfg.num_experts,
                      cfg.mlp_dim)
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    shapes = {
        "embedding": (cfg.vocab_size, d),
        "layers/wq": (L, d, nq),
        "layers/wk": (L, d, nkv),
        "layers/wv": (L, d, nkv),
        "layers/wo": (L, nq, d),
        "layers/router": (L, d, E),
        "layers/w_gate": (L, E, d, f),
        "layers/w_up": (L, E, d, f),
        "layers/w_down": (L, E, f, d),
        "layers/attn_norm": (L, d),
        "layers/mlp_norm": (L, d),
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


class MoELlama(Llama):
    """MoE decoder parameters (uninitialised; see :func:`init_params` and
    :func:`params_from_numpy`) on ``device`` (``cuda`` unless given)."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__(cfg, device, shapes=param_shapes(cfg))

    def forward(self, tokens: torch.Tensor):
        return forward_with_aux(self.cfg, self.tree(), tokens)


def init_model(cfg: MoEConfig, init=0, device=None) -> MoELlama:
    """The model from a seed (normal / sqrt(fan_in) from a
    ``torch.Generator`` on ``device``, ones for norms, as the JAX
    package's init) or from a JAX param tree as numpy arrays."""
    dev = resolve_device(device)
    return _init_model(cfg, init, dev, MoELlama(cfg, dev))


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device=None) -> MoELlama:
    """Random init from ``generator`` (which must live on ``device``)."""
    return llama.init_params(cfg, generator, device, MoELlama(cfg, device))


def params_from_numpy(cfg: MoEConfig, tree, device=None) -> MoELlama:
    """JAX's ``init_params`` output as numpy arrays (``jax.tree.map(
    np.asarray, params)``) turned into the port's model."""
    return llama.params_from_numpy(cfg, tree, device, MoELlama(cfg, device))


# --------------------------------------------------------------------------- #
# Forward and loss
# --------------------------------------------------------------------------- #


def _layer(cfg: MoEConfig, x, p, positions, expert_group=None,
           frac_mean=None, collectives=None, seq_group=None):
    """One MoE decoder layer. x: [B, T, dim] (residual stream, cfg.dtype).
    Returns ``(x, aux)``. ``expert_group`` and ``frac_mean`` are
    :func:`moe_ffn`'s, for expert parallelism. ``collectives`` (the
    ``tensor`` axis' ``(f, g)`` pair) and ``seq_group`` are as in
    ``models/llama.py:_pp_layer``: p holds this rank's heads and expert
    mlp shards, and with ``seq_group`` x is this rank's block of the
    sequence, attention the ring; :func:`moe_ffn` takes both."""
    col_in, row_out = collectives if collectives is not None \
        else (_identity, _identity)
    q, kk, vv = _qkv(cfg, x, p, positions, col_in)
    if seq_group is None:
        attn = flash_attention(q, kk, vv, causal=True)
    else:
        attn = ring_attention_local(q, kk, vv, seq_group, causal=True)
    x = _attn_out(cfg, x, attn, p, row_out)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps).to(cfg.dtype)
    y, aux = moe_ffn(h, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                     top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                     compute_dtype=cfg.dtype, expert_group=expert_group,
                     frac_mean=frac_mean, collectives=collectives,
                     seq_group=seq_group)
    return x + y.to(x.dtype), aux


def _backbone_with_aux(cfg: MoEConfig, params, tokens: torch.Tensor):
    """tokens [B, T] -> (final-normed hidden states [B, T, dim], the aux
    loss summed over layers). With ``cfg.remat`` and grad on, each layer
    runs under checkpoint."""
    B, T = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(B, T, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _unbind_layers(params):
        if remat:
            x, a = checkpoint(_layer, cfg, x, p, positions,
                              use_reentrant=False)
        else:
            x, a = _layer(cfg, x, p, positions)
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward_with_aux(cfg: MoEConfig, params, tokens: torch.Tensor):
    """tokens [B, T] -> (logits [B, T, vocab] in cfg.dtype, the aux loss
    averaged over layers)."""
    x, aux = _backbone_with_aux(cfg, params, tokens)
    logits = x.to(cfg.dtype) @ _head(cfg, params).to(cfg.dtype)
    return logits, aux / cfg.n_layers


def loss_fn(cfg: MoEConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL (fp32 log-softmax, computed in sequence chunks
    as the Llama loss is) plus ``aux_loss_coef`` times the layers' mean
    aux loss. tokens [B, T+1]."""
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x, aux = _backbone_with_aux(cfg, params, inputs)
    nll = chunked_nll_mean(cfg, x, targets,
                           _plain_chunk_nll(cfg, _head(cfg, params)))
    return nll + cfg.aux_loss_coef * (aux / cfg.n_layers)


# --------------------------------------------------------------------------- #
# Train step
# --------------------------------------------------------------------------- #


def make_train_step(cfg: MoEConfig, mesh=None, optimizer=None,
                    gather: str = "streamed", device=None, rules=None):
    """Build ``(init_state, train_step)``.

    With no mesh, or a mesh of one rank, the single-card step on
    ``device`` (``cuda`` unless given): ``init_state(init=0)`` takes a
    seed or a JAX param tree as numpy arrays and returns ``{"params":
    MoELlama, "opt_state": optimizer, "step": 0}``; ``train_step(state,
    tokens)`` (int ``[B, T+1]``) takes one step, updates the state in
    place and returns the loss. ``optimizer`` maps the parameters to a
    ``torch.optim.Optimizer``; the default is AdamW at the JAX step's
    optax settings (lr 3e-4, betas (0.9, 0.95), eps 1e-8, weight decay
    0.1).

    On a larger mesh it is ``train/spmd.py:make_moe_train_step(cfg, mesh,
    optimizer, gather, device, rules)``: the batch axes, ``fsdp`` (either
    gather schedule), ``expert`` (the experts split over it, dispatch
    and return by all-to-all), ``tensor`` (heads, each expert's mlp dim
    and the vocab split over it) and ``seq`` (each row split over it,
    attention the ring, routing the whole row's)."""
    if mesh is not None and mesh.size() > 1:
        from ray_tpu_torch.train.spmd import make_moe_train_step

        return make_moe_train_step(cfg, mesh, optimizer, gather, device,
                                   rules)
    dev = resolve_device(device)

    def init_state(init=0):
        model = init_model(cfg, init, dev)
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

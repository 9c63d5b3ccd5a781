"""Mixture-of-Experts routing and the expert FFN (port of
``ray_tpu/ops/moe.py``).

GShard/Switch-style *dense dispatch*: routing is one-hot dispatch and
combine tensors ``[B, S, E, C]`` with a static per-expert capacity ``C``,
and the expert FFN is a batch of einsums over the dispatched activations
``[E, B, C, d]``. Top-k routing with renormalised gates (Mixtral),
capacity-factor token dropping and the Switch load-balancing aux loss,
with the JAX package's conventions kept exactly (slot order, tie-breaks,
the renormaliser's epsilon).

Expert parallelism: given the ``expert`` axis' process group,
:func:`moe_ffn` keeps ``E/ep`` experts a rank, sends each expert's
dispatched slots to the rank that holds it with one all-to-all, runs the
SwiGLU there and returns the outputs with a second all-to-all (the
exchange the JAX package leaves to GSPMD). Capacity is per row, so the
rows a rank routes decide nothing about another rank's. Tensor
parallelism splits each expert's mlp dim, Megatron-style; sequence
parallelism splits each row over the ``seq`` ranks, whose routing is
the whole row's (the slot offsets come from the other ranks' counts)
and whose dispatched slots are summed and split by a reduce-scatter.

The dispatch and combine products are plain matmuls (``torch.einsum``),
as JAX computes them outside any Pallas kernel. Each stage runs in a
``torch.profiler.record_function`` range (``moe.route``,
``moe.dispatch``, ``moe.seq_scatter``, ``moe.experts``,
``moe.all_to_all``, ``moe.seq_gather``, ``moe.combine``), so a profile
can attribute device time to it.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from ray_tpu_torch import COMPUTE_DTYPE
from ray_tpu_torch.collective.collective import (all_gather, all_to_all,
                                                 reduce_scatter)


def expert_choices(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """The experts each token picks, in choice order: ``[G, S, top_k]``
    int64 from router probabilities ``[G, S, E]``, by repeated argmax
    (first index on ties), each pick zeroed before the next. These are
    :func:`top_k_routing`'s choices before capacity drops any."""
    picks, remaining = [], probs
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        picks.append(idx)
        remaining = remaining * (1.0 - F.one_hot(idx, probs.shape[-1])
                                 .float())
    return torch.stack(picks, dim=-1)


def top_k_routing(gate_logits: torch.Tensor, num_experts: int, top_k: int,
                  capacity: int,
                  frac_mean: Optional[Callable] = None, seq_group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch and combine tensors from router scores.

    gate_logits: ``[G, S, E]`` (G groups of S tokens). Returns
    ``(dispatch [G, S, E, C] 0/1 float32 without gradient, combine
    [G, S, E, C] float32, aux scalar)``. Each token takes its top-k
    experts (:func:`expert_choices`); slots are claimed
    choice-major, then in token order, so choice 0 of every token
    outranks choice 1 of any token; a token past an expert's capacity is
    dropped for that choice (combine weight 0). The surviving gates are
    renormalised to sum to 1 per token.

    With ``seq_group`` (the ``seq`` axis' process group, R ranks) the S
    tokens are this rank's block of rows of R S tokens split over it, rank
    r holding tokens ``[r S, (r+1) S)``, and ``capacity`` is the whole
    row's: the slots are the ones the whole row's routing gives. The slot
    of choice k of a token here is offset by the whole row's count of
    choices before k and by the earlier ranks' count of choice k, both
    before capacity; one all-gather of the ranks' counts ``[R, G, top_k,
    E]`` a call gives them.

    aux is the Switch loss ``E * sum_e frac_e * mean_p_e``: ``frac`` the
    share of tokens whose first choice (before capacity) is e, without
    gradient, and ``mean_p`` the mean router probability. ``frac_mean``,
    when given, maps this rank's ``frac`` to the global batch's (a mean
    over the ranks that split the batch and the sequence), so that the
    mean of the ranks' aux losses is the global one."""
    G, S, E = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)
    ms = [F.one_hot(idx, E).float()                             # [G,S,E]
          for idx in expert_choices(probs.detach(), top_k).unbind(-1)]

    masks, gate_vals, positions = [], [], []
    remaining = probs
    for m, offset in zip(ms, _slot_offsets(ms, seq_group)):
        gate_vals.append((remaining * m).sum(-1))               # [G,S]
        remaining = remaining * (1.0 - m)
        pos_e = torch.cumsum(m, dim=1) - m + offset             # [G,S,E]
        within = (pos_e < capacity).float() * m
        masks.append(within)
        positions.append((pos_e * within).sum(-1))             # [G,S]

    kept = [m.sum(-1) for m in masks]                           # [G,S] 0/1
    denom = sum(g * k for g, k in zip(gate_vals, kept)) + 1e-9
    dispatch = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for m, g, p in zip(masks, gate_vals, positions):
        slot = F.one_hot(p.long(), capacity).float()            # [G,S,C]
        d = m[..., None] * slot[:, :, None, :]                  # [G,S,E,C]
        dispatch = dispatch + d
        combine = combine + d * (g / denom)[:, :, None, None]

    first = F.one_hot(torch.argmax(probs, -1), E).float()
    frac = first.mean((0, 1))
    if frac_mean is not None:
        frac = frac_mean(frac)
    mean_p = probs.mean((0, 1))
    aux = num_experts * (frac * mean_p).sum()
    return dispatch, combine, aux


def _slot_offsets(ms: List[torch.Tensor], seq_group) -> List[torch.Tensor]:
    """Per choice, the ``[G, 1, E]`` slots of each expert that tokens
    before this rank's claimed: every choice before it (the whole row's,
    under ``seq_group``) and, under ``seq_group``, the same choice on the
    earlier ranks. Counts before capacity, as exact float32 integers."""
    if seq_group is None:
        offsets = [torch.zeros_like(ms[0][:, :1])]
        for m in ms[:-1]:
            offsets.append(offsets[-1] + m.sum(1, keepdim=True))
        return offsets
    counts = torch.stack([m.sum(1) for m in ms], 1)             # [G,k,E]
    every = all_gather(counts[None], 0, seq_group)              # [R,G,k,E]
    total = every.sum(0)
    offset = torch.cumsum(total, 1) - total \
        + every[:dist.get_rank(seq_group)].sum(0)
    return [o[:, None] for o in offset.unbind(1)]


def expert_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    c = int(math.ceil(top_k * tokens_per_group / num_experts
                      * capacity_factor))
    return max(c, 1)


def _identity(x):
    return x


def _swiglu_experts(ex_in, w_gate, w_up, w_down, cd, collectives=None):
    """SwiGLU per expert: ``[E, b, C, d]`` through ``[E, d, f]`` gate and
    up and ``[E, f, d]`` down; under tensor parallelism f is this rank's
    share, entered through ``collectives``' ``f`` and left through its
    ``g``."""
    col_in, row_out = collectives if collectives is not None \
        else (_identity, _identity)
    ex_in = col_in(ex_in)
    g = F.silu(torch.einsum("ebcd,edf->ebcf", ex_in, w_gate.to(cd)))
    u = torch.einsum("ebcd,edf->ebcf", ex_in, w_up.to(cd))
    return row_out(torch.einsum("ebcf,efd->ebcd", g * u, w_down.to(cd)))


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int = 2,
            capacity_factor: float = 1.25, compute_dtype=COMPUTE_DTYPE,
            expert_group=None, frac_mean: Optional[Callable] = None,
            collectives=None, seq_group=None):
    """MoE SwiGLU FFN. x: ``[B, S, d]``; router_w: ``[d, E]``.

    Without ``expert_group``: w_gate, w_up ``[E, d, f]``, w_down
    ``[E, f, d]``, every expert here. With it (the ``expert`` axis'
    process group, ep ranks): this rank's ``E/ep`` experts, rank j
    holding experts ``[j E/ep, (j+1) E/ep)``; the dispatched slots
    ``[E, B, C, d]`` go to their experts' ranks by an all-to-all and
    come back by another, so each rank combines its own rows. Raises
    unless ep divides E.

    ``collectives`` is the ``tensor`` axis' ``(f, g)`` pair
    (``models/llama.py:tp_psum_pair``): the expert weights are this
    rank's column-parallel ``[.., d, f/t]`` gate and up and row-parallel
    ``[.., f/t, d]`` down, the SwiGLU entered through ``f`` and left
    through ``g`` (after the all-to-all, before its way back). Router and
    routing are computed alike on every tensor rank.

    With ``seq_group`` (the ``seq`` axis' group, R ranks) x holds this
    rank's block of S of each row's R S tokens: the routing is the whole
    row's (:func:`top_k_routing`, capacity from R S), each rank's
    dispatch fills only the slots its tokens own, a reduce-scatter along
    the capacity dim sums the ranks' parts and leaves each rank C/R slots
    to run the experts on, and an all-gather brings every slot's output
    back for the local combine. Raises unless R divides C. ``frac_mean``
    (:func:`top_k_routing`) must then average over ``seq`` too.

    Returns ``(y [B, S, d] in x.dtype, aux scalar float32)``."""
    B, S, d = x.shape
    E = router_w.shape[-1]
    R = dist.get_world_size(seq_group) if seq_group is not None else 1
    C = expert_capacity(S * R, E, top_k, capacity_factor)
    if C % R:
        raise ValueError(
            f"seq axis size {R} does not divide the expert capacity C={C} "
            f"({S * R} tokens a row, {E} experts, top {top_k}, capacity "
            f"factor {capacity_factor})")
    cd = compute_dtype

    with record_function("moe.route"):
        logits = torch.einsum("bsd,de->bse", x.float(), router_w.float())
        dispatch, combine, aux = top_k_routing(logits, E, top_k, C,
                                               frac_mean, seq_group)
    with record_function("moe.dispatch"):
        ex_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(cd), x.to(cd))
    if seq_group is not None:
        with record_function("moe.seq_scatter"):
            ex_in = reduce_scatter(ex_in, 2, seq_group)
    if expert_group is None:
        with record_function("moe.experts"):
            ex_out = _swiglu_experts(ex_in, w_gate, w_up, w_down, cd,
                                     collectives)
    else:
        ex_out = _expert_parallel(ex_in, w_gate, w_up, w_down, cd,
                                  expert_group, collectives)
    if seq_group is not None:
        with record_function("moe.seq_gather"):
            ex_out = all_gather(ex_out, 2, seq_group)
    with record_function("moe.combine"):
        y = torch.einsum("bsec,ebcd->bsd", combine.to(cd), ex_out)
    return y.to(x.dtype), aux


def _expert_parallel(ex_in, w_gate, w_up, w_down, cd, group, collectives):
    """The experts' SwiGLU over the ``expert`` group: ex_in ``[E, b, C,
    d]`` (this rank's rows for every expert) in, this rank's rows' expert
    outputs ``[E, b, C, d]`` out; ``collectives`` as
    :func:`_swiglu_experts`'."""
    ep = dist.get_world_size(group)
    E, b, C, d = ex_in.shape
    if E % ep:
        raise ValueError(f"expert axis size {ep} does not divide "
                         f"num_experts={E}")
    local = E // ep
    if w_gate.shape[0] != local:
        raise ValueError(f"expert weights hold {w_gate.shape[0]} experts, "
                         f"want E/ep = {local}")
    # chunk j of dim 0 goes to rank j; chunk i that arrives came from rank i
    with record_function("moe.all_to_all"):
        got = all_to_all(ex_in.reshape(ep, local, b, C, d), group)
    with record_function("moe.experts"):
        # [ep (source rank), local, b, C, d] -> [local, ep*b, C, d]
        mine = got.transpose(0, 1).reshape(local, ep * b, C, d)
        out = _swiglu_experts(mine, w_gate, w_up, w_down, cd, collectives)
        out = out.reshape(local, ep, b, C, d).transpose(0, 1)
    with record_function("moe.all_to_all"):
        back = all_to_all(out, group)
    return back.reshape(E, b, C, d)

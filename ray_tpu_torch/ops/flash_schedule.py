"""How the head_dim-256 forward and dK/dV kernels spread a launch over
the card's SMs: the split counts the wrappers pass to the C entry
points, and the grid order the kernels follow; and how the slab
backward kernels past head_dim 256 share a launch's outputs between
blocks and consumer warpgroups (all mirrored here from
``csrc/flash_attention_{fwd,bwd}.cu``, so that tests can hold them).

At head_dim 256 a block takes one SM (about 193–200 KB of shared
memory), and a causal launch of few heads is one under-full wave whose
longest block walks many times the average:

- dK/dV: a block per (64-row kv tile, kv head, batch) walks every
  (q head of the group, 64-row q stage) pair, causal ones from the
  diagonal on, so kv tile 0 walks ``rep * cdiv(T, 64)`` stages. Split,
  each kv tile's pairs (head-major, as the kernel walks them) are cut
  into ``n_split`` contiguous chunks, a block each (chunks innermost on
  the grid). Each block writes its float32 partial dK and dV, and a
  second pass sums the partials in chunk order (never in arrival order,
  no atomics), so a result is bitwise repeatable.
- forward: a block per (128-row q tile, q head, batch) walks the 64-key
  stages up to the diagonal. Split, the last ``n_split_tiles`` q tiles
  (the longest) each become two blocks over the first and second half
  of their stages; each writes its float32 partial o and lse, and a
  second pass merges part 0 then part 1 by lse.

The counts come from the shape and the SM count alone, never from a
timing, so one shape on one card model always runs one schedule: dK/dV
cuts kv tile 0's walk into chunks no longer than the stages an SM walks
on average, and the forward splits the tiles whose walk is above three
quarters of the longest. A launch that already fills the card (a block
an SM or more) is not split.

At head_dim 129–256 dQ runs on a kernel of its own
(``flash_bwd_dq256_kernel``): a block of 64 q rows whose two consumer
warpgroups split S and dP by product, as the slab dQ kernel's do, and
each add dS K into their own 128 columns of dQ (:func:`dq256_columns`).

Past head_dim 256 (the slab kernels) a block's two consumer warpgroups
each own a 256-column slab of the output. The forward up to two slabs
(head_dim 512) is a block per (64-row q tile, q head, batch), causal q
tiles longest first: consumer c owns slab c of O, keeps its slab's
columns of Q and sums S's partial over them against the same columns of
K, and the two consumers add each other's partials, so each column of Q
and K is read once a (q tile, head) step and S is computed once; past
two slabs a block per (128-row q tile, q head, batch, slab), slabs
innermost, each consumer 64 of the rows, summing S over every column
itself. The backward's two consumers split S = Q K^T and dP = dO V^T
between them by product, so each is computed once a block:

- dQ: a block per (64-row q tile, q head, batch, pair of slabs), pairs
  innermost, causal q tiles longest first; consumer 0 computes S and P,
  consumer 1 dP, delta and dS, and each then dQ of its own slab;
- dK/dV: a block per (64-row kv tile, kv head, batch, slab), slabs
  innermost; consumer 0 computes S^T, P^T and dV of the slab, consumer 1
  dP^T, dS^T and dK of the slab. Up to four slabs (float32: two) the
  blocks of one (kv tile, kv head, batch) form a thread-block cluster,
  each block's S^T and dP^T a partial sum over its own slab's columns,
  sent to its peers and summed by every block in rank order; past that
  each block sums S^T and dP^T over every column itself.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

# the split instantiation: head_dim (the kernels' width) above 128, up to
# 256; past 256 the slab kernels run, unsplit
SPLIT_WIDTHS = (129, 256)
# dK/dV: kv rows a block, q rows a stage; forward: q rows a block, keys
# a stage (the D-256 instantiations' shapes)
DKV_KV_ROWS = DKV_Q_ROWS = 64
FWD_Q_ROWS, FWD_KEYS = 128, 64
# the partials' row width (the instantiation's head_dim)
PARTIAL_WIDTH = 256
MAX_DKV_SPLIT = 16

# The forward splits the q tiles whose walk is above this share of the
# longest, where that shortens the longest by FWD_MIN_GAIN stages or more.
# A forward stage runs slower on a full card than on a partly idle one
# (its K/V tiles come from L2), so splitting more tiles stops paying
# before the walks even out: on an H100 at Gemma-2B's 8/1 heads and T
# 2048, splitting the 4 of 16 q tiles above three quarters was the
# fastest count (chip_kernel_probe.py --sweep; PERF.md).
FWD_SPLIT_SHARE = 3 / 4
FWD_MIN_GAIN = 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splits(width: int) -> bool:
    """Whether the kernels built for head_dim ``width`` take a split."""
    return SPLIT_WIDTHS[0] <= width <= SPLIT_WIDTHS[1]


# ------------------------------------------------------------------ dK/dV


def dkv_tile_iters(T: int, rep: int, kvtile: int, causal: bool) -> int:
    """The (q head, q stage) pairs kv tile ``kvtile`` walks."""
    q_start = kvtile * DKV_KV_ROWS if causal else 0
    return rep * _cdiv(T - q_start, DKV_Q_ROWS)


def dkv_chunk(n_iter: int, n_split: int, chunk: int) -> Tuple[int, int]:
    """Chunk ``chunk``'s pairs ``[it0, it1)`` of a kv tile's ``n_iter``,
    as the kernel cuts them."""
    return n_iter * chunk // n_split, n_iter * (chunk + 1) // n_split


def dkv_blocks(B: int, T: int, Hq: int, Hkv: int, causal: bool,
               n_split: int) -> List[Tuple[int, int, int, int, int, int]]:
    """The dK/dV grid in order: ``(kv tile, kv head, batch, chunk, it0,
    it1)`` a block, kv tiles outermost, then heads, chunks innermost. Pair
    ``it`` is q head ``kv head * rep + it // n_qs`` and q stage ``it %
    n_qs`` (``n_qs = n_iter / rep``), from the diagonal on when causal."""
    rep = Hq // Hkv
    out = []
    for kvtile in range(_cdiv(T, DKV_KV_ROWS)):
        n_iter = dkv_tile_iters(T, rep, kvtile, causal)
        for hb in range(Hkv * B):
            for chunk in range(n_split):
                out.append((kvtile, hb % Hkv, hb // Hkv, chunk,
                            *dkv_chunk(n_iter, n_split, chunk)))
    return out


@functools.lru_cache(maxsize=256)
def dkv_split(B: int, T: int, Hq: int, Hkv: int, width: int, causal: bool,
              sms: int) -> int:
    """The chunks each kv tile of a dK/dV launch is cut into: 1 (today's
    kernel) unless head_dim ``width`` runs the split instantiation and
    the unsplit grid is under one block an SM; then the fewest that bring
    the longest tile's chunks down to the stages an SM walks on average,
    at most :data:`MAX_DKV_SPLIT`."""
    tiles = _cdiv(T, DKV_KV_ROWS)
    if not splits(width) or tiles * Hkv * B >= sms:
        return 1
    rep = Hq // Hkv
    longest = dkv_tile_iters(T, rep, 0, causal)
    total = Hkv * B * sum(dkv_tile_iters(T, rep, t, causal)
                          for t in range(tiles))
    return min(MAX_DKV_SPLIT, _cdiv(longest, _cdiv(total, sms)))


# ---------------------------------------------------------------- forward


def forward_walk(T: int, qtile: int, causal: bool) -> int:
    """The key stages q tile ``qtile`` walks."""
    end = min((qtile + 1) * FWD_Q_ROWS, T) if causal else T
    return _cdiv(end, FWD_KEYS)


def forward_units(T: int, n_split_tiles: int, causal: bool = True
                  ) -> List[Tuple[int, int, int]]:
    """The forward grid's units in order, ``(q tile, j0, j1)``: the key
    stages ``[j0, j1)`` a unit walks; each unit is a block per (q head,
    batch), heads inner. Unsplit, the q tiles longest first; split, the
    last ``n_split_tiles`` tiles' halves (second half first) and the
    whole tiles merged longest first, a split half before a whole tile
    of its length (the kernel's ``fwd_unit``)."""
    n_qtiles = _cdiv(T, FWD_Q_ROWS)
    if not n_split_tiles:
        order = range(n_qtiles - 1, -1, -1) if causal else range(n_qtiles)
        return [(qt, 0, forward_walk(T, qt, causal)) for qt in order]
    parts = []
    for qt in range(n_qtiles - 1, n_qtiles - 1 - n_split_tiles, -1):
        n = forward_walk(T, qt, True)
        parts += [(qt, n // 2, n), (qt, 0, n // 2)]
    whole = [(qt, 0, forward_walk(T, qt, True))
             for qt in range(n_qtiles - 1 - n_split_tiles, -1, -1)]
    out, s, w = [], 0, 0
    while s < len(parts) or w < len(whole):
        ls = parts[s][2] - parts[s][1] if s < len(parts) else -1
        lw = whole[w][2] if w < len(whole) else -1
        if ls >= lw:
            out.append(parts[s])
            s += 1
        else:
            out.append(whole[w])
            w += 1
    return out


@functools.lru_cache(maxsize=256)
def forward_split_tiles(B: int, T: int, Hq: int, width: int, causal: bool,
                        sms: int) -> int:
    """The q tiles (the last, longest ones) a forward launch splits into
    two halves of their key stages: 0 (today's kernel) unless head_dim
    ``width`` runs the split instantiation, the attention is causal, the
    unsplit grid is under one block an SM and the split shortens the
    longest walk by :data:`FWD_MIN_GAIN` stages or more. Split, the tiles
    whose walk is above :data:`FWD_SPLIT_SHARE` of the longest."""
    n_qtiles = _cdiv(T, FWD_Q_ROWS)
    if not (splits(width) and causal) or n_qtiles * Hq * B >= sms:
        return 0
    walks = [forward_walk(T, qt, True) for qt in range(n_qtiles)]
    split = sum(w > FWD_SPLIT_SHARE * walks[-1] for w in walks)
    longest = max(walks[-1] - walks[-1] // 2, *walks[:n_qtiles - split], 0)
    return split if walks[-1] - longest >= FWD_MIN_GAIN else 0


# ------------------------------------------------------ dQ at head_dim 256

# flash_bwd_dq256_kernel (head_dim 129-256, read at 256): a block of 64 q
# rows of one (q head, batch), causal q tiles longest first, heads inner;
# 64-key K/V stages. Consumer 0 computes S and P, consumer 1 delta, dP and
# dS; each adds dS K into its own 128 columns of dQ. V's stage is freed by
# dP (consumer 1), K's by both consumers' dS K. 16-bit inputs keep three
# stages, two of their own and the third over the rows of Q and dO, which
# the consumers hold in registers (the A operands of S and dP) before the
# first K/V tile lands there; each consumer issues the next tile's S or dP
# as soon as this tile's is consumed (consumer 0: P written; consumer 1:
# dS written). float32 (whose stages hold V's rest, and whose dO rest
# stays in shared memory) keeps one stage and issues the next product
# after dS K.
DQ256_ROWS = DQ256_KEYS = 64
DQ256_WIDTH = 256
DQ256_HALF = DQ256_WIDTH // 2
DQ256_PRODUCTS = ("S", "dP")  # consumer c's own product before dS K
DQ256_FREES = {"v": (1,), "k": (0, 1)}  # the consumers that free a stage


def dq_kernel(width: int) -> str:
    """The dQ kernel that head_dim ``width`` (the kernels' width) runs
    on."""
    if width > WIDE_SLAB:
        return "flash_bwd_dq_wide_kernel"
    if width > 128:
        return "flash_bwd_dq256_kernel"
    return "flash_bwd_dq_kernel"


def dq256_blocks(B: int, T: int, Hq: int, causal: bool
                 ) -> List[Tuple[int, int, int, int]]:
    """The head_dim-256 dQ grid in order: ``(q tile, q head, batch, key
    tiles)`` a block, causal q tiles longest first, then heads (q head
    inner to batch); a block walks key tiles 0 .. ``key tiles`` - 1 (up to
    its diagonal when causal)."""
    n_qtiles = _cdiv(T, DQ256_ROWS)
    out = []
    for rank in range(n_qtiles):
        qtile = n_qtiles - 1 - rank if causal else rank
        end = min((qtile + 1) * DQ256_ROWS, T) if causal else T
        for hb in range(Hq * B):
            out.append((qtile, hb % Hq, hb // Hq, _cdiv(end, DQ256_KEYS)))
    return out


def dq256_columns(width: int, consumer: int) -> Tuple[int, int]:
    """The columns ``[lo, hi)`` of dQ that consumer ``consumer`` adds dS K
    into and writes (empty past the tensor's columns: the consumer still
    computes its S or dP for the block)."""
    lo = consumer * DQ256_HALF
    return min(lo, width), min(lo + DQ256_HALF, width)


def dq256_stages(elem_bytes: int) -> Tuple[int, int]:
    """``(stages, own)``: the K/V stages of the head_dim-256 dQ kernel for
    inputs of ``elem_bytes`` bytes, and how many of them have shared
    memory of their own (the rest lie over Q and dO); the next tile's S or
    dP is issued ahead of dS K where there is more than one."""
    return (3, 2) if elem_bytes == 2 else (1, 1)


# ------------------------------------------------- the slab kernels (D > 256)

# output columns a consumer warpgroup owns, and rows of a block's tile
WIDE_SLAB = 256
WIDE_ROWS = 64
# dQ: the consumers (slabs) of a block; dK/dV: what each consumer writes
WIDE_DQ_SLABS = 2
WIDE_DKV_OUTPUTS = ("dv", "dk")
# the unit of :func:`wide_products`: a 64 x 64 x 64 multiply-add block
WIDE_UNIT = 64
# dK/dV: the most slabs a cluster takes, by element size (a block's
# receive slots for its peers' partials take the room: float32 tiles
# keep what rounding to bf16 left, so fewer fit)
WIDE_CLUSTER_SLABS = {2: 4, 4: 2}


# the forward: the widest head_dim a block of both slabs takes (Q of its
# 64 rows resident), and the q rows of a block a slab past it
WIDE_FWD_PAIR_WIDTH = 2 * WIDE_SLAB
WIDE_FWD_SLAB_ROWS = 128


def wide_fwd_blocks(B: int, T: int, Hq: int, width: int, causal: bool
                    ) -> List[Tuple[int, int, int, int]]:
    """The slab forward grid in order: ``(q tile, q head, batch, slab)``
    a block, causal q tiles longest first, then heads (q head inner to
    batch), slabs innermost. Up to :data:`WIDE_FWD_PAIR_WIDTH` a block
    takes :data:`WIDE_ROWS` q rows and both slabs (slab 0 names it); past
    it :data:`WIDE_FWD_SLAB_ROWS` q rows and one slab."""
    pair = width <= WIDE_FWD_PAIR_WIDTH
    rows = WIDE_ROWS if pair else WIDE_FWD_SLAB_ROWS
    n_slabs = 1 if pair else _cdiv(width, WIDE_SLAB)
    n_qtiles = _cdiv(T, rows)
    out = []
    for rank in range(n_qtiles):
        qtile = n_qtiles - 1 - rank if causal else rank
        for hb in range(Hq * B):
            for slab in range(n_slabs):
                out.append((qtile, hb % Hq, hb // Hq, slab))
    return out


def wide_fwd_consumer(width: int, slab: int, consumer: int
                      ) -> Tuple[Tuple[int, int], Tuple[int, int],
                                 Tuple[int, int]]:
    """What consumer ``consumer`` of a slab forward block of ``slab``
    does: the q rows ``(lo, hi)`` of the block's tile whose O it writes,
    the columns ``(lo, hi)`` of O it writes, and the columns ``(lo, hi)``
    of Q and K over which it sums S (up to :data:`WIDE_FWD_PAIR_WIDTH`
    its slab's, a partial the other consumer adds to its own; past it
    every column, S whole)."""
    if width <= WIDE_FWD_PAIR_WIDTH:
        lo = consumer * WIDE_SLAB
        cols = (min(lo, width), min(lo + WIDE_SLAB, width))
        return (0, WIDE_ROWS), cols, cols
    lo = slab * WIDE_SLAB
    return ((consumer * WIDE_ROWS, (consumer + 1) * WIDE_ROWS),
            (lo, min(lo + WIDE_SLAB, width)), (0, width))


def wide_dq_blocks(B: int, T: int, Hq: int, width: int, causal: bool
                   ) -> List[Tuple[int, int, int, int]]:
    """The slab dQ grid in order: ``(q tile, q head, batch, pair)`` a
    block, causal q tiles longest first, then heads (q head inner to
    batch), pairs of slabs innermost."""
    n_pairs = _cdiv(width, WIDE_DQ_SLABS * WIDE_SLAB)
    n_qtiles = _cdiv(T, WIDE_ROWS)
    out = []
    for rank in range(n_qtiles):
        qtile = n_qtiles - 1 - rank if causal else rank
        for hb in range(Hq * B):
            for pair in range(n_pairs):
                out.append((qtile, hb % Hq, hb // Hq, pair))
    return out


def wide_dq_columns(width: int, pair: int, consumer: int
                    ) -> Tuple[int, int]:
    """The columns ``[lo, hi)`` of dQ that consumer ``consumer`` of a
    block of pair ``pair`` writes (empty past the tensor's columns; the
    consumer still computes dP or S for its block)."""
    lo = (WIDE_DQ_SLABS * pair + consumer) * WIDE_SLAB
    return min(lo, width), min(lo + WIDE_SLAB, width)


def wide_dkv_blocks(B: int, T: int, Hkv: int, width: int
                    ) -> List[Tuple[int, int, int, int]]:
    """The slab dK/dV grid in order: ``(kv tile, kv head, batch, slab)``
    a block, kv tiles outermost, then heads (kv head inner to batch),
    slabs innermost. Each block walks every (q head of its group, 64-row
    q step), from the diagonal on when causal."""
    n_slabs = _cdiv(width, WIDE_SLAB)
    out = []
    for kvtile in range(_cdiv(T, WIDE_ROWS)):
        for hb in range(Hkv * B):
            for slab in range(n_slabs):
                out.append((kvtile, hb % Hkv, hb // Hkv, slab))
    return out


def wide_dkv_cluster(width: int, elem_bytes: int = 2) -> int:
    """The blocks of a slab dK/dV cluster (its slabs) at head_dim
    ``width`` for inputs of ``elem_bytes`` bytes, or 1 where the slabs
    outnumber :data:`WIDE_CLUSTER_SLABS` and each block runs alone."""
    n_slabs = _cdiv(width, WIDE_SLAB)
    return n_slabs if n_slabs <= WIDE_CLUSTER_SLABS[elem_bytes] else 1


def wide_dkv_partial_columns(width: int, slab: int) -> Tuple[int, int]:
    """The columns ``[lo, hi)`` over which the cluster block of slab
    ``slab`` sums its partial S^T and dP^T (its own slab's): the
    cluster's partials, added in rank order, contract over every column
    once."""
    lo = slab * WIDE_SLAB
    return min(lo, width), min(lo + WIDE_SLAB, width)


def wide_dkv_output(width: int, slab: int, consumer: int
                    ) -> Tuple[str, int, int]:
    """What consumer ``consumer`` of a block of slab ``slab`` writes:
    ``("dv" or "dk", lo, hi)``, the slab's columns ``[lo, hi)``."""
    lo = slab * WIDE_SLAB
    return (WIDE_DKV_OUTPUTS[consumer], lo, min(lo + WIDE_SLAB, width))


def wide_products(width: int, elem_bytes: int = 2) -> dict:
    """The 64 x 64 x 64 products (:data:`WIDE_UNIT`) the slab kernels
    issue a (64-row tile, 64-row tile) pair, beside the fewest the
    forward and backward need (S, P V; S, dP and each gradient once;
    float32's extra dP products of the rests not counted): the forward up
    to two slabs S's two partials over their slabs' four column blocks
    and P V over both slabs (boxes past the tensor's columns included),
    past that S over every slice and P V over the slab, a slab's block
    each; dQ's S and dP over every slice once a block, dS K over both
    slabs (a slab past the tensor's columns included); dK/dV in a
    cluster, each block's partial S^T and dP^T and its P^T dO and dS^T Q
    over its slab's four column blocks, alone S^T and dP^T over every
    slice once a block."""
    n_cb = _cdiv(width, WIDE_UNIT)
    per_slab = WIDE_SLAB // WIDE_UNIT
    n_pairs = _cdiv(width, WIDE_DQ_SLABS * WIDE_SLAB)
    n_slabs = _cdiv(width, WIDE_SLAB)
    if width <= WIDE_FWD_PAIR_WIDTH:
        fwd = 2 * 2 * per_slab
    else:
        fwd = n_slabs * (n_cb + per_slab)
    dq = n_pairs * (2 * n_cb + WIDE_DQ_SLABS * per_slab)
    if wide_dkv_cluster(width, elem_bytes) > 1:
        dkv = n_slabs * 4 * per_slab
    else:
        dkv = n_slabs * (2 * n_cb + 2 * per_slab)
    return {"fwd": fwd, "dq": dq, "dkv": dkv, "fwd_least": 2 * n_cb,
            "dq_least": 3 * n_cb, "dkv_least": 4 * n_cb}

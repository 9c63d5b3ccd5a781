"""How the head_dim-256 forward and dK/dV kernels spread a launch over
the card's SMs: the split counts the wrappers pass to the C entry
points, and the grid order the kernels follow (mirrored here from
``csrc/flash_attention_{fwd,bwd}.cu``, so that tests can hold it).

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

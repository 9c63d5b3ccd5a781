// Flash-attention forward for Hopper (sm_90a): bf16, fp16 or fp32 in, fp32
// accumulate.
//
// Replaces the TPU kernel `_fwd_kernel` in ray_tpu/ops/flash_attention.py
// (launched by `_fwd`): causal or full attention with an online softmax,
// GQA through kv head h / (Hq / Hkv), and O plus the row logsumexp
// lse = m + log(l) as outputs (the backward kernels read lse).
//
// What bounds it on this card: at the prefill shapes of the serving path
// and the training shapes (T in the hundreds to thousands) the two matrix
// products per tile make it operation-bound: 4 * D flops per (query, key)
// pair against 2 * D bytes per row of Q, K, V and O. So the design feeds
// the tensor cores at their Hopper rate (wgmma) from tiles that TMA
// brings in ahead of use, and keeps the T x T scores in registers.
//
// Design (flash_attention_sm90.cuh holds the Hopper pieces):
// - one block per (q tile, q head, batch): a producer warpgroup and one
//   consumer warpgroup per 64 q rows; setmaxnreg moves registers from the
//   producer (24) to the consumers. At head_dim 128 a block is two
//   consumers (128 q rows, 384 threads, one block a SM: K/V tiles are
//   shared by twice the rows); at head_dim 64 one consumer (64 q rows,
//   256 threads, two blocks a SM, so one block's prologue and epilogue
//   overlap another's main loop, which at this width, where the
//   exponentials cost about what the products do, is the faster shape);
// - one thread of the producer's first warp loads the Q tile, then keeps
//   a ring of 2 K/V stages of 128 rows filled by TMA, K one tile ahead of
//   V; K and V of a stage each have a full and an empty barrier, so K is
//   refilled while V is still read; the other producer warps exit;
// - each consumer runs S = Q K^T (wgmma, SS form), the online softmax in
//   fp32 in the log2 domain (exp2f), then O += P V (wgmma, RS form: the
//   S accumulator rounded to bf16 is the A operand). Two consumers, or
//   two blocks, overlap one's softmax with the other's products;
// - only the causal diagonal tile and the ragged tail (keys >= T) are
//   masked; rows past T are read as zeros (TMA) and never stored, so any
//   T >= 1 runs on the kernel;
// - built for head_dim 64, 128 and 256: a narrower head_dim is read
//   through a TMA map of its true width, whose missing columns arrive as
//   zeros and add exact zeros to every product; the scale is 1/sqrt(true
//   head_dim) and only the true columns of O are stored. At 256 a K/V
//   stage is 64 keys (two stages of 64 x 256 K and V and a 128-row Q tile
//   fill 193 KB of the 227 KB a block may use), and O += P V is two
//   products of 128 columns; past 256 a consumer owns a slab of 256
//   output columns: up to 512 a block of 64 q rows both slabs, S summed
//   once from the two consumers' halves (flash_fwd_pair_kernel below),
//   past 512 a block a slab (flash_fwd_wide_kernel), any width;
// - types (flash_attention_sm90.cuh, `Elem`): bf16 and fp16 run wgmma in
//   their own type; fp32 q, k and v are rounded to bf16 once a call by
//   the split pass (flash_fwd_split_kernel, below) and the kernel loads
//   those copies by TMA, as it loads a bf16 input, and runs the bf16
//   products (P is rounded to the operand type in every case), so an fp32
//   call computes with bf16 operands and fp32 sums; O is written in the
//   input type (past 256 the slab kernels' producer warpgroups still
//   round fp32 tiles themselves, keeping 40 registers: FwdSplit);
// - up to kNarrowWidth columns (flash_attention_sm90.cuh) the <64>
//   instantiation takes P in two parts, the rounded value and what the
//   rounding left, two products where one was (kParts = 2);
// - causal blocks run longest first (the last q tiles, of every head);
// - at head_dim 256, causal, a launch under one block an SM is split over
//   keys (below); inputs are read through their [B, T, H, D] strides; no
//   atomics, and the split's halves are merged in a fixed order, so the
//   result is bitwise repeatable.
//
// Split (head_dim 256, causal). A block fills an SM (193 KB), and q tile
// i walks 2 (i + 1) key stages: at a 2k prefill of 8 heads the grid is
// 128 blocks on 132 SMs, the last tiles walking 32 stages against an
// average of 17, so the launch was bound by the longest walk. Where the
// unsplit grid is under one block an SM, the wrapper
// (ray_tpu_torch/ops/flash_schedule.py:forward_split_tiles, from the
// shape and the SM count only) names n_split, and the last n_split q
// tiles (the longest) each become two blocks, over the first half of
// their key stages and over the rest, still 128 q rows a block, so each
// K/V stage feeds as many rows as before. A half writes its fp32 o (over
// its own l) and lse to a workspace; flash_fwd_merge_kernel then weighs
// part 0 and part 1 by exp(lse_p - lse), in that order, and writes o and
// the merged lse (which the backward kernels read). The grid runs its
// units longest first (fwd_unit). What bounds it then: a stage takes
// about a fifth longer on a full card than on a partly idle one (each
// block streams 64 KB of K and V a stage from L2), so splitting more than
// the tiles whose walk is above three quarters of the longest does not
// pay; at 2k x 8/1 heads on an H100, 4 tiles split, 160 blocks, the
// longest walking 24 stages, 0.054 ms against 0.062 unsplit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"

namespace {

using namespace sm90;

constexpr unsigned kFull = 0xffffffffu;

// key rows per K/V stage
__host__ __device__ constexpr int block_n(int D) { return D > 128 ? 64 : 128; }

// the slab kernels' register split: a producer that converts fp32 tiles
// keeps 40 (flash_fwd_kernel's producer is one TMA thread for every type,
// Split<kConsumers>)
template <int kConsumers, typename In>
using FwdSplit = Split<kConsumers, Elem<In>::kTma ? 24 : 40>;

// ------------------------------------------------- fp32: the split pass
//
// fp32 inputs reach the products as bf16 tiles (Elem<float>). Before this
// pass flash_fwd_kernel's producer warpgroup converted every tile itself
// (convert_rows, no TMA, 40 registers): each block re-read and re-rounded
// in fp32 the K and V rows that every other q tile of its head also read,
// and "train f32" took about four times the bf16 forward's time. The
// split pass rounds q, k and v once a call instead, bound by bytes: it
// reads each fp32 row
// once through its strides and writes a bf16 copy [B, T, H, w8] (hi =
// RN(x); w8 the width rounded up to 8 columns, 16-byte rows, the rest
// zeros), convert_rows's rounding (split8, shared with the backward's
// flash_bwd_split_kernel). flash_fwd_kernel then loads every tile of the
// copies by TMA, so each product sees the operands its producer's
// conversion gave it, and o and lse keep their bits. A thread an
// 8-column chunk: 64 rows a block of 256 threads, four threads a row; q
// rows in the first blocks, k and v rows (both copies) after them.
constexpr int kCopyRows = 64;  // rows a block

// strides (batch, time, head) of q, k and v, in elements
struct CopyStrides {
  long long s[3][3];
};

__global__ void __launch_bounds__(4 * kCopyRows)
    flash_fwd_split_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           uint4* __restrict__ q_hi, uint4* __restrict__ k_hi,
                           uint4* __restrict__ v_hi, int B, int T, int Hq,
                           int Hkv, int d_true, int w8,
                           const CopyStrides st) {
  const int tg = threadIdx.x % 4;
  const int q_blocks = cdiv(B * T * Hq, kCopyRows);
  const bool q_sized = blockIdx.x < q_blocks;
  const int H = q_sized ? Hq : Hkv;
  // row (b, t, h), h fastest, of the copies [B, T, H, w8]
  const int64_t row = (int64_t)(q_sized ? blockIdx.x : blockIdx.x - q_blocks) *
                          kCopyRows + threadIdx.x / 4;
  if (row >= (int64_t)B * T * H) return;
  const int h = row % H, t = (row / H) % T, b = row / ((int64_t)H * T);
  const int n_ch = w8 / 8;  // 16-byte chunks of a copy's row
  auto at = [&](const float* base, int i) {
    return base + b * st.s[i][0] + t * st.s[i][1] + h * st.s[i][2];
  };
  float x[8];
  if (q_sized) {
    const float* q_row = at(q, 0);
    for (int ch = tg; ch < n_ch; ch += 4) {
      load8(q_row, 8 * ch, d_true, x);
      split8(x, q_hi + row * n_ch + ch, nullptr);
    }
  } else {
    const float *k_row = at(k, 1), *v_row = at(v, 2);
    for (int ch = tg; ch < n_ch; ch += 4) {
      const int64_t out = row * n_ch + ch;
      load8(k_row, 8 * ch, d_true, x);
      split8(x, k_hi + out, nullptr);
      load8(v_row, 8 * ch, d_true, x);
      split8(x, v_hi + out, nullptr);
    }
  }
}

// The split (head_dim 256): the key stages a causal q tile walks, and the
// unit of the grid a block takes. Units run longest first: the halves of
// the last n_split q tiles (the second half of a tile first) merged with
// the whole tiles, a half before a whole tile of its length. Mirrored by
// ray_tpu_torch/ops/flash_schedule.py:forward_units.
constexpr int kSplitRows = 128, kSplitKeys = 64;  // the D-256 tile, stage

__device__ inline int causal_walk(int qtile, int T) {
  const int end = (qtile + 1) * kSplitRows;
  return cdiv(end < T ? end : T, kSplitKeys);
}

// q tile and part (0: the first half of its stages, 1: the second, -1:
// all) of unit `rank`
__device__ inline void fwd_unit(int rank, int n_qtiles, int n_split, int T,
                                int* qtile, int* part) {
  int s = 0, w = 0;  // halves and whole tiles taken
  const int n_whole = n_qtiles - n_split;
  for (;; --rank) {
    int ls = -1, lw = -1;
    if (s < 2 * n_split) {
      const int n = causal_walk(n_qtiles - 1 - s / 2, T);
      ls = s % 2 == 0 ? n - n / 2 : n / 2;
    }
    if (w < n_whole) lw = causal_walk(n_whole - 1 - w, T);
    const bool half = ls >= lw;
    if (rank == 0) {
      *qtile = half ? n_qtiles - 1 - s / 2 : n_whole - 1 - w;
      *part = half ? 1 - s % 2 : -1;
      return;
    }
    if (half) {
      ++s;
    } else {
      ++w;
    }
  }
}

// q, k and v arrive by TMA: bf16 and fp16 as they are, fp32 as the split
// pass's bf16 copies (tm_q, tm_k and tm_v are then the copies' maps)
template <int D, int kStages, int kConsumers, typename In, int kParts = 1>
__global__ void __launch_bounds__(Split<kConsumers>::kThreads,
                                  Split<kConsumers>::kBlocksPerSm)
    flash_fwd_kernel(__grid_constant__ const CUtensorMap tm_q,
                     __grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v,
                     In* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ halves,
                     int n_split, int T, int Hq, int B, int rep, int d_true,
                     int64_t o_sb, int64_t o_st, int64_t o_sh,
                     float scale_log2, int causal) {
  using S = Split<kConsumers>;
  using Op = typename Elem<In>::Op;
  constexpr int kBlockN = block_n(D);
  constexpr int kBlockM = 64 * kConsumers;    // q rows of the block
  constexpr int kColBlocks = D / 64;          // 64-column TMA boxes per row
  constexpr int kQBytes = kBlockM * D * 2;
  constexpr int kKVBytes = kBlockN * D * 2;   // K or V of one stage
  extern __shared__ uint8_t smem_raw[];
  // per stage: K and V each have a full barrier (TMA landed) and an empty
  // one (every consumer warp is done with it), so K can be refilled while
  // V is still being read
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages], v_full[kStages],
      k_empty[kStages], v_empty[kStages];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* kv_s = q_s + kQBytes;  // stage s: K at 2s * kKVBytes, V after

  const int heads = Hq * B;
  const int n_qtiles = cdiv(T, kBlockM);
  const int rank = blockIdx.x / heads;  // heads inner: longest tiles first
  int qtile = causal ? n_qtiles - 1 - rank : rank;
  int part = -1;  // the whole key range, or a half of a split tile's
  if constexpr (D > 128) {
    if (n_split > 0) fwd_unit(rank, n_qtiles, n_split, T, &qtile, &part);
  }
  const int h = (blockIdx.x % heads) % Hq, b = (blockIdx.x % heads) / Hq;
  const int q0 = qtile * kBlockM;
  const int n_tiles = cdiv(causal ? min(q0 + kBlockM, T) : T, kBlockN);
  // the key stages [j0, j1) this block walks
  const int j0 = part == 1 ? n_tiles / 2 : 0;
  const int j1 = part == 0 ? n_tiles / 2 : n_tiles;

  if (threadIdx.x == 0) {
    // a TMA tile completes on one arrival (and its bytes)
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * kConsumers);
      mbar_init(&v_empty[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<S::kProducerRegs>();
    if (threadIdx.x == 0) {
      const int hk = h / rep;
      // tile j's K or V into its stage, once the consumers have freed it
      auto load = [&](int j, int which, uint64_t* full, uint64_t* empty) {
        const int s = (j - j0) % kStages;
        mbar_wait(&empty[s], (((j - j0) / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kKVBytes);
        uint8_t* dst = kv_s + (2 * s + which) * kKVBytes;
#pragma unroll
        for (int cb = 0; cb < kColBlocks; ++cb) {
          tma_load_4d(dst + cb * kBlockN * 128, which ? &tm_v : &tm_k,
                      &full[s], cb * 64, hk, j * kBlockN, b);
        }
      };
      mbar_arrive_expect_tx(&q_full, kQBytes);
#pragma unroll
      for (int cb = 0; cb < kColBlocks; ++cb) {
        tma_load_4d(q_s + cb * kBlockM * 128, &tm_q, &q_full, cb * 64, h, q0,
                    b);
      }
      // K runs one tile ahead of V, as the consumers use them
      load(j0, 0, k_full, k_empty);
      for (int j = j0; j < j1; ++j) {
        if (j + 1 < j1) load(j + 1, 0, k_full, k_empty);
        load(j, 1, v_full, v_empty);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<S::kConsumerRegs>();
    const int c = wg - 1;  // q rows 64c .. 64c + 63 of the tile
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = q0 + 64 * c + 16 * w + g;  // this thread's rows: row0, +8
    const uint32_t q_addr = smem_addr(q_s) + c * 64 * 128;
    const uint32_t kv_addr = smem_addr(kv_s);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
    float l[2] = {0.f, 0.f};  // this thread's share of the running sum

    mbar_wait(&q_full, 0);
    for (int j = j0; j < j1; ++j) {
      const int s = (j - j0) % kStages;
      const uint32_t parity = ((j - j0) / kStages) & 1;
      const uint32_t k_addr = kv_addr + 2 * s * kKVBytes;
      const uint32_t v_addr = k_addr + kKVBytes;

      // S = Q K^T: 64 rows x 128 keys, contracted over head_dim
      float sc[kBlockN / 2];
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;  // bytes into the column block
        wgmma_ss<kBlockN, Op>(
            sc, desc_sw128(q_addr + (ks / 4) * kBlockM * 128 + col, 16, 1024),
            desc_sw128(k_addr + (ks / 4) * kBlockN * 128 + col, 16, 1024),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&k_empty[s]);  // this warp is done with K

      // scale into the log2 domain; mask the ragged tail and the diagonal
      const int k0 = j * kBlockN;
      const bool need_mask =
          k0 + kBlockN > T || (causal && k0 + kBlockN - 1 > q0 + 64 * c);
#pragma unroll
      for (int e = 0; e < kBlockN / 2; ++e) {
        float x = sc[e] * scale_log2;
        if (need_mask) {
          const int col = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
          const int row = row0 + ((e >> 1) & 1) * 8;
          if (col >= T || (causal && col > row)) x = -CUDART_INF_F;
        }
        sc[e] = x;
      }

      // online softmax; the four threads of a quad share each row
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
          mx = fmaxf(mx, fmaxf(sc[4 * jn + 2 * r], sc[4 * jn + 2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float base = (mx == -CUDART_INF_F) ? 0.f : mx;
        corr[r] = exp2f(m[r] - base);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
          sc[4 * jn + 2 * r] = exp2f(sc[4 * jn + 2 * r] - base);
          sc[4 * jn + 2 * r + 1] = exp2f(sc[4 * jn + 2 * r + 1] - base);
          sum += sc[4 * jn + 2 * r] + sc[4 * jn + 2 * r + 1];
        }
        l[r] = l[r] * corr[r] + sum;
      }
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        acc[4 * jn + 0] *= corr[0];
        acc[4 * jn + 1] *= corr[0];
        acc[4 * jn + 2] *= corr[1];
        acc[4 * jn + 3] *= corr[1];
      }
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a<Op>(pa[kk], sc, kk);
      // narrow head_dims: P also as what its rounding left
      uint32_t pa_lo[kParts > 1 ? kBlockN / 16 : 1][4];
      if constexpr (kParts > 1) {
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          pack_a_rest<Op>(pa_lo[kk], pa[kk], sc, kk);
        }
      }

      // O += P V: V's kBlockN rows are the contraction, head_dim the
      // columns
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs_cols<D, Op>(acc, pa[kk], v_addr + kk * 16 * 128,
                             kBlockN * 128);
      }
      if constexpr (kParts > 1) {
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          wgmma_rs_cols<D, Op>(acc, pa_lo[kk], v_addr + kk * 16 * 128,
                               kBlockN * 128);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&v_empty[s]);  // and with V
    }

    // epilogue: O = acc / l in q's dtype, lse = m + log(l) in fp32
    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum = fmaxf(sum, 1e-30f);
      const float inv = 1.f / sum;
      const int row = row0 + r * 8;
      if (row >= T) continue;
      if (D > 128 && part >= 0) {
        // a half's fp32 o and lse, for flash_fwd_merge_kernel: row `at` of
        // part p's [B, Hq, n_split, kBlockM] rows of 256 columns, the lse
        // of all rows after all rows of o
        const int64_t rows = (int64_t)B * Hq * n_split * kBlockM;
        const int64_t at =
            part * rows +
            (((int64_t)b * Hq + h) * n_split + qtile - (n_qtiles - n_split)) *
                kBlockM + row - q0;
        if (tg == 0) halves[2 * rows * D + at] = m[r] * kLn2 + logf(sum);
#pragma unroll
        for (int jn = 0; jn < D / 8; ++jn) {
          const int col = 8 * jn + 2 * tg;
          if (col < d_true) {
            store2(halves + at * D + col, acc[4 * jn + 2 * r] * inv,
                   acc[4 * jn + 2 * r + 1] * inv);
          }
        }
        continue;
      }
      if (tg == 0) {
        lse[((int64_t)b * Hq + h) * T + row] = m[r] * kLn2 + logf(sum);
      }
      In* out = o + b * o_sb + h * o_sh + (int64_t)row * o_st;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        const int col = 8 * jn + 2 * tg;
        if (col < d_true) {
          store2(out + col, acc[4 * jn + 2 * r] * inv,
                 acc[4 * jn + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// The split's second pass: o and lse of the split q tiles' rows from their
// two halves, part 0 then part 1, each weighed by exp(its lse - the merged
// lse), as parallel/ring_attention.py merges the ring's blocks; a fixed
// order, so it is bitwise repeatable. Bound by bytes (two fp32 rows read,
// one row of o written): a warp a row, eight columns a lane, each lane's
// four 16-byte loads issued before any is used; 8 rows a block.
constexpr int kMergeRows = 8;

template <typename In>
__global__ void __launch_bounds__(32 * kMergeRows)
    flash_fwd_merge_kernel(const float* __restrict__ part,
                           In* __restrict__ o, float* __restrict__ lse,
                           int n_split, int T, int Hq, int B, int d_true,
                           int64_t o_sb, int64_t o_st, int64_t o_sh) {
  constexpr int kD = 256;  // the halves' row width
  const int lane = threadIdx.x % 32;
  // row `at` of part 0's [B, Hq, n_split, 128] rows; part 1's follow
  const int64_t at = (int64_t)blockIdx.x * kMergeRows + threadIdx.x / 32;
  const int64_t rows = (int64_t)B * Hq * n_split * kSplitRows;
  if (at >= rows) return;
  const int r = at % kSplitRows;
  const int64_t slot = at / kSplitRows;
  const int sj = slot % n_split, h = (slot / n_split) % Hq,
            b = slot / ((int64_t)n_split * Hq);
  const int row = (cdiv(T, kSplitRows) - n_split + sj) * kSplitRows + r;
  if (row >= T) return;
  float4 x[2][2];  // [part][column group]: columns 4 lane + 128 g
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      x[p][g] = *reinterpret_cast<const float4*>(
          part + (p * rows + at) * kD + 4 * lane + 128 * g);
    }
  }
  const float l0 = part[2 * rows * kD + at];
  const float l1 = part[2 * rows * kD + rows + at];
  const float mx = fmaxf(l0, l1);
  const float e0 = expf(l0 - mx);
  const float e1 = expf(l1 - mx);
  const float sum = e0 + e1;
  const float w0 = e0 / sum, w1 = e1 / sum;
  if (lane == 0) lse[((int64_t)b * Hq + h) * T + row] = mx + logf(sum);
  In* out = o + b * o_sb + h * o_sh + (int64_t)row * o_st;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = 4 * lane + 128 * g;
    const float4 a = x[0][g], c = x[1][g];
    if (col < d_true) store2(out + col, w0 * a.x + w1 * c.x, w0 * a.y + w1 * c.y);
    if (col + 2 < d_true) {
      store2(out + col + 2, w0 * a.z + w1 * c.z, w0 * a.w + w1 * c.w);
    }
  }
}

template <int D, int kStages, int kConsumers>
constexpr int smem_bytes() {  // + 1024: the tiles' 1024-byte alignment
  return 64 * kConsumers * D * 2 + kStages * 2 * block_n(D) * D * 2 + 1024;
}

template <int D, int kStages, int kConsumers>
int config(int* out) {  // every type and kParts alike
  using S = Split<kConsumers>;
  static_assert(smem_bytes<D, kStages, kConsumers>() <= 232448,
                "a block may use 227 KB of shared memory");
  out[0] = smem_bytes<D, kStages, kConsumers>();
  out[1] = S::kThreads;
  out[2] = S::kLaunchRegs;
  out[3] = 64 * kConsumers;
  return 0;
}

// q, k and v (qkv) are the inputs at their element strides s[0 .. 8]
// (bf16, fp16), or, given w8 > 0, the split pass's bf16 copies [B, T, H,
// w8] (fp32); o at its strides s[9 .. 11]
template <int D, int kStages, int kConsumers, typename In, int kParts = 1>
int launch(const void* const* qkv, int w8, void* o, void* lse, void* part,
           int n_split, int B, int T, int Hq, int Hkv, int d_true,
           const long long* s, float scale_log2, int causal,
           cudaStream_t stream) {
  using S = Split<kConsumers>;
  constexpr int kBlockM = 64 * kConsumers;
  constexpr int kBlockN = block_n(D);
  if (Elem<In>::kTma == (w8 > 0)) {  // fp32 runs on copies, only fp32
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm[3];  // q, k, v
  int err = 0;
  for (int i = 0; i < 3 && !err; ++i) {
    const int H = i == 0 ? Hq : Hkv, rows = i == 0 ? kBlockM : kBlockN;
    err = w8 > 0 ? encode_copy(&tm[i], qkv[i], B, T, H, w8, rows)
                 : encode_rows(&tm[i], qkv[i], B, T, H, d_true, s[3 * i],
                               s[3 * i + 1], s[3 * i + 2], rows,
                               Elem<In>::kMapType);
  }
  constexpr int kSmem = smem_bytes<D, kStages, kConsumers>();
  auto kernel = flash_fwd_kernel<D, kStages, kConsumers, In, kParts>;
  if (!err) err = prepare_launch(kernel, kSmem, S::kLaunchRegs);
  if (err) return err;
  // split: a block per half of each of the last n_split q tiles
  const int grid = (cdiv(T, kBlockM) + n_split) * Hq * B;
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      tm[0], tm[1], tm[2], static_cast<In*>(o), static_cast<float*>(lse),
      static_cast<float*>(part), n_split, T, Hq, B, Hq / Hkv, d_true, s[9],
      s[10], s[11], scale_log2, causal);
  err = static_cast<int>(cudaGetLastError());
  if (err || n_split == 0) return err;
  const int64_t rows = (int64_t)B * Hq * n_split * kSplitRows;
  flash_fwd_merge_kernel<In>
      <<<(int)((rows + kMergeRows - 1) / kMergeRows), 32 * kMergeRows, 0,
         stream>>>(static_cast<const float*>(part), static_cast<In*>(o),
                   static_cast<float*>(lse), n_split, T, Hq, B, d_true, s[9],
                   s[10], s[11]);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- head_dim above 256
//
// No whole-head_dim tile fits a block past 256 columns (a 64-row fp32
// accumulator of D columns is D / 2 registers a thread; Q, K and V tiles
// of D columns outgrow the 227 KB). Up to 512 columns the pair kernel
// below runs; past 512 each block owns one slab of kSlab output columns
// (blocks of one (q tile, head) are neighbours on the grid and read Q and
// K from L2):
// - S = Q K^T is summed over every column by streaming 64-column slices
//   of Q (128 rows) and K (64 keys) through a ring (kSliceStages), one
//   SS product group a slice into the 64 x 64 S accumulator;
// - only the slab's columns of V feed O += P V (a second ring of 64 x
//   kSlab V tiles, two RS products of 128 columns);
// - shared memory and registers are those of head_dim 256 whatever D
//   is; the price is S computed once per slab (D / 256 times, rounded
//   up), 2.5x the forward's products at D 1024;
// - every slab computes the same m, l and lse in the same order, so they
//   agree bitwise; the first slab writes lse;
// - only the column blocks inside the tensor are loaded (a V tile's
//   others keep what shared memory held, which reaches only O's columns
//   past the tensor's, never stored).
namespace wide {

constexpr int kSlab = 256;         // output columns a block owns
constexpr int kBlockN = 64;        // keys a tile
constexpr int kConsumers = 2;      // 128 q rows a block
constexpr int kSliceStages = 4;    // (Q, K) 64-column slices in flight
constexpr int kVStages = 2;
constexpr int kBlockM = 64 * kConsumers;
constexpr int kQSlice = kBlockM * 128;   // 128 rows of 64 16-bit columns
constexpr int kKSlice = kBlockN * 128;
constexpr int kSliceBytes = kQSlice + kKSlice;
constexpr int kVBytes = kBlockN * kSlab * 2;
constexpr int kSmem = kSliceStages * kSliceBytes + kVStages * kVBytes + 1024;

}  // namespace wide

template <typename In>
__global__ void __launch_bounds__(FwdSplit<wide::kConsumers, In>::kThreads,
                                  FwdSplit<wide::kConsumers, In>::kBlocksPerSm)
    flash_fwd_wide_kernel(__grid_constant__ const CUtensorMap tm_q,
                          __grid_constant__ const CUtensorMap tm_k,
                          __grid_constant__ const CUtensorMap tm_v,
                          const Src src, In* __restrict__ o,
                          float* __restrict__ lse, int T, int Hq, int B,
                          int rep, int d_true, int64_t o_sb, int64_t o_st,
                          int64_t o_sh, float scale_log2, int causal) {
  using namespace wide;
  using S = FwdSplit<kConsumers, In>;
  using Op = typename Elem<In>::Op;
  constexpr bool kTma = Elem<In>::kTma;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t sl_full[kSliceStages],
      sl_empty[kSliceStages], v_full[kVStages], v_empty[kVStages];
  uint8_t* slices = align_1024(smem_raw);  // stage s: Q, then K
  uint8_t* v_s = slices + kSliceStages * kSliceBytes;

  const int n_cb = cdiv(d_true, 64);        // 64-column slices of a row
  const int n_slabs = cdiv(d_true, kSlab);
  const int heads = Hq * B;
  const int n_qtiles = cdiv(T, kBlockM);
  // slabs innermost, then heads: the slabs of a (q tile, head) side by
  // side, and the longest tiles of every head first
  const int slab = blockIdx.x % n_slabs, tile = blockIdx.x / n_slabs;
  const int rank = tile / heads;
  const int qtile = causal ? n_qtiles - 1 - rank : rank;
  const int h = (tile % heads) % Hq, b = (tile % heads) / Hq;
  const int q0 = qtile * kBlockM, c0 = slab * kSlab;
  const int n_vcb = min(kSlab / 64, n_cb - c0 / 64);  // V boxes inside
  const int n_tiles = cdiv(causal ? min(q0 + kBlockM, T) : T, kBlockN);

  if (threadIdx.x == 0) {
    constexpr int kFillers = kTma ? 1 : 128;
    for (int s = 0; s < kSliceStages; ++s) {
      mbar_init(&sl_full[s], kFillers);
      mbar_init(&sl_empty[s], 4 * kConsumers);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&v_full[s], kFillers);
      mbar_init(&v_empty[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<S::kProducerRegs>();
    const int hk = h / rep;
    // per key tile: V of the slab first (its stage frees two tiles
    // earlier), then every slice of Q and K
    if constexpr (!kTma) {
      // fp32: the whole warpgroup converts each tile into its place
      const int tid = threadIdx.x;
      const float* q_rows = head_rows(src.ptr[0], src.stride[0], b, h);
      const float* k_rows = head_rows(src.ptr[1], src.stride[1], b, hk);
      const float* v_rows = head_rows(src.ptr[2], src.stride[2], b, hk);
      int it = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int vs = j % kVStages;
        mbar_wait(&v_empty[vs], ((j / kVStages) & 1) ^ 1);
        convert_rows<kBlockN, kSlab>(v_s + vs * kVBytes, v_rows + c0,
                                     src.stride[2][1], j * kBlockN, T,
                                     d_true - c0, tid);
        fence_proxy_async();
        mbar_arrive(&v_full[vs]);
        for (int cb = 0; cb < n_cb; ++cb, ++it) {
          const int s = it % kSliceStages;
          mbar_wait(&sl_empty[s], ((it / kSliceStages) & 1) ^ 1);
          uint8_t* stage = slices + s * kSliceBytes;
          convert_rows<kBlockM, 64>(stage, q_rows + 64 * cb,
                                    src.stride[0][1], q0, T,
                                    d_true - 64 * cb, tid);
          convert_rows<kBlockN, 64>(stage + kQSlice, k_rows + 64 * cb,
                                    src.stride[1][1], j * kBlockN, T,
                                    d_true - 64 * cb, tid);
          fence_proxy_async();
          mbar_arrive(&sl_full[s]);
        }
      }
    } else if (threadIdx.x == 0) {
      int it = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int vs = j % kVStages;
        mbar_wait(&v_empty[vs], ((j / kVStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&v_full[vs], n_vcb * kBlockN * 128);
        for (int cb = 0; cb < n_vcb; ++cb) {
          tma_load_4d(v_s + vs * kVBytes + cb * kBlockN * 128, &tm_v,
                      &v_full[vs], c0 + 64 * cb, hk, j * kBlockN, b);
        }
        for (int cb = 0; cb < n_cb; ++cb, ++it) {
          const int s = it % kSliceStages;
          mbar_wait(&sl_empty[s], ((it / kSliceStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&sl_full[s], kSliceBytes);
          uint8_t* stage = slices + s * kSliceBytes;
          tma_load_4d(stage, &tm_q, &sl_full[s], 64 * cb, h, q0, b);
          tma_load_4d(stage + kQSlice, &tm_k, &sl_full[s], 64 * cb, hk,
                      j * kBlockN, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<S::kConsumerRegs>();
    const int c = wg - 1;  // q rows 64c .. 64c + 63 of the tile
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = q0 + 64 * c + 16 * w + g;  // this thread's rows: row0, +8
    const uint32_t slices_addr = smem_addr(slices) + c * 64 * 128;
    const uint32_t v_addr0 = smem_addr(v_s);

    float acc[kSlab / 2];
#pragma unroll
    for (int i = 0; i < kSlab / 2; ++i) acc[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
    float l[2] = {0.f, 0.f};  // this thread's share of the running sum

    int it = 0;
    for (int j = 0; j < n_tiles; ++j) {
      // S = Q K^T: 64 rows x 64 keys, summed over the slices
      float sc[kBlockN / 2];
      for (int cb = 0; cb < n_cb; ++cb, ++it) {
        const int s = it % kSliceStages;
        mbar_wait(&sl_full[s], (it / kSliceStages) & 1);
        const uint32_t q_addr = slices_addr + s * kSliceBytes;
        const uint32_t k_addr = smem_addr(slices) + s * kSliceBytes + kQSlice;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_ss<kBlockN, Op>(sc, desc_sw128(q_addr + ks * 32, 16, 1024),
                                desc_sw128(k_addr + ks * 32, 16, 1024),
                                cb > 0 || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (lane == 0) mbar_arrive(&sl_empty[s]);  // this warp is done
      }

      // scale into the log2 domain; mask the ragged tail and the diagonal
      const int k0 = j * kBlockN;
      const bool need_mask =
          k0 + kBlockN > T || (causal && k0 + kBlockN - 1 > q0 + 64 * c);
#pragma unroll
      for (int e = 0; e < kBlockN / 2; ++e) {
        float x = sc[e] * scale_log2;
        if (need_mask) {
          const int col = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
          const int row = row0 + ((e >> 1) & 1) * 8;
          if (col >= T || (causal && col > row)) x = -CUDART_INF_F;
        }
        sc[e] = x;
      }

      // online softmax; the four threads of a quad share each row
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
          mx = fmaxf(mx, fmaxf(sc[4 * jn + 2 * r], sc[4 * jn + 2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float base = (mx == -CUDART_INF_F) ? 0.f : mx;
        corr[r] = exp2f(m[r] - base);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
          sc[4 * jn + 2 * r] = exp2f(sc[4 * jn + 2 * r] - base);
          sc[4 * jn + 2 * r + 1] = exp2f(sc[4 * jn + 2 * r + 1] - base);
          sum += sc[4 * jn + 2 * r] + sc[4 * jn + 2 * r + 1];
        }
        l[r] = l[r] * corr[r] + sum;
      }
#pragma unroll
      for (int jn = 0; jn < kSlab / 8; ++jn) {
        acc[4 * jn + 0] *= corr[0];
        acc[4 * jn + 1] *= corr[0];
        acc[4 * jn + 2] *= corr[1];
        acc[4 * jn + 3] *= corr[1];
      }
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a<Op>(pa[kk], sc, kk);

      // O += P V over the slab's columns
      const int vs = j % kVStages;
      mbar_wait(&v_full[vs], (j / kVStages) & 1);
      const uint32_t v_addr = v_addr0 + vs * kVBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs_cols<kSlab, Op>(acc, pa[kk], v_addr + kk * 16 * 128,
                                 kBlockN * 128);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&v_empty[vs]);
    }

    // epilogue: the slab's columns of O; lse from the first slab
    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum = fmaxf(sum, 1e-30f);
      const float inv = 1.f / sum;
      const int row = row0 + r * 8;
      if (row >= T) continue;
      if (tg == 0 && slab == 0) {
        lse[((int64_t)b * Hq + h) * T + row] = m[r] * kLn2 + logf(sum);
      }
      In* out = o + b * o_sb + h * o_sh + (int64_t)row * o_st;
#pragma unroll
      for (int jn = 0; jn < kSlab / 8; ++jn) {
        const int col = c0 + 8 * jn + 2 * tg;
        if (col < d_true) {
          store2(out + col, acc[4 * jn + 2 * r] * inv,
                 acc[4 * jn + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// ------------------------------------------------- head_dim 257 to 512
//
// The slab kernel above computes S once a slab and streams every slice of
// Q and K from L2 once a slab: at D 512 a (128 q rows, 64 keys) step of
// its two blocks reads 448 KB from L2, and "d512 train" ran at the L2's
// rate with 1.5x the products (PERF.md). Up to two slabs (D 512) a block
// of 64 q rows owns both slabs of O instead, consumer c slab c (columns
// 256 c .. 256 c + 255), and S is computed once:
// - each consumer keeps its own half of the columns of Q resident (the
//   block's 64 rows, read once) and per key tile gets its half of K and
//   its slab of V: it sums the partial S = Q K^T over its own 256
//   columns, so across the block every column of Q and K is read once a
//   step and S once (128 KB of L2 a 64-row step: K and V once);
// - the two partials meet in shared memory (a thread's elements at
//   float4 q * 128 + t, so the other warpgroup's thread t reads exactly
//   its own elements, without bank conflicts) under named barriers: a
//   consumer writes its partial and arrives on its "written" barrier,
//   waits on the other's, adds the other's partial to its own and
//   arrives on the other's "read" barrier, which the other waits on
//   before it writes its next partial. fp32 addition commutes, so both
//   consumers hold the same bits of S, and so the same m, l and lse;
//   consumer 0 writes lse;
// - then each runs the online softmax and O += P V over its own slab;
// - all four boxes of each half are loaded: boxes wholly past the
//   tensor's columns arrive as zeros (TMA; fp32 converts zeros) and add
//   exact zeros, so the partial is an unrolled loop of 16 products (a
//   loop over the boxes inside made ptxas serialise every wgmma, C7515);
//   only columns inside the tensor are stored;
// - one stage of each half of K and V (shared memory: Q 64 KB, K 64 KB,
//   V 64 KB, the partials 32 KB): K of tile j + 1 loads while the
//   consumers take the softmax and P V of tile j, V of tile j + 1 while
//   they sum S of tile j + 1.
// Past 512 columns Q no longer fits resident, and the slab kernel runs.
namespace pair {

constexpr int kRows = 64;                  // q rows a block
constexpr int kMaxWidth = 2 * wide::kSlab;  // two slabs, one a consumer
constexpr int kTile = 64 * 128;            // 64 rows of 64 16-bit columns
constexpr int kHalf = 4 * kTile;           // 64 rows of a slab's columns
constexpr int kExFloats = 32 * 128;        // a 64 x 64 fp32 partial
constexpr int kSmem = 6 * kHalf + 2 * 4 * kExFloats + 1024;
// named barriers (0 is __syncthreads), + the consumer whose partial it
// is: written, and read by the other consumer
constexpr int kBarWritten = 1, kBarRead = 3;

}  // namespace pair

template <typename In>
__global__ void __launch_bounds__(FwdSplit<2, In>::kThreads,
                                  FwdSplit<2, In>::kBlocksPerSm)
    flash_fwd_pair_kernel(__grid_constant__ const CUtensorMap tm_q,
                          __grid_constant__ const CUtensorMap tm_k,
                          __grid_constant__ const CUtensorMap tm_v,
                          const Src src, In* __restrict__ o,
                          float* __restrict__ lse, int T, int Hq, int B,
                          int rep, int d_true, int64_t o_sb, int64_t o_st,
                          int64_t o_sh, float scale_log2, int causal) {
  using namespace pair;
  using S = FwdSplit<2, In>;
  using Op = typename Elem<In>::Op;
  constexpr bool kTma = Elem<In>::kTma;
  constexpr int kSlab = wide::kSlab;
  extern __shared__ uint8_t smem_raw[];
  // Q of both halves; per consumer a full and an empty barrier of its
  // half of K and of its slab of V (one stage each)
  __shared__ __align__(8) uint64_t q_full, k_full[2], k_empty[2], v_full[2],
      v_empty[2];
  uint8_t* q_s = align_1024(smem_raw);  // consumer c's half at c * kHalf
  uint8_t* k_s = q_s + 2 * kHalf;
  uint8_t* v_s = k_s + 2 * kHalf;
  float* ex = reinterpret_cast<float*>(v_s + 2 * kHalf);

  const int heads = Hq * B;
  const int n_qtiles = cdiv(T, kRows);
  const int rank = blockIdx.x / heads;  // heads inner: longest tiles first
  const int qtile = causal ? n_qtiles - 1 - rank : rank;
  const int h = (blockIdx.x % heads) % Hq, b = (blockIdx.x % heads) / Hq;
  const int q0 = qtile * kRows;
  const int n_tiles = cdiv(causal ? min(q0 + kRows, T) : T, 64);

  if (threadIdx.x == 0) {
    constexpr int kFillers = kTma ? 1 : 128;
    mbar_init(&q_full, kFillers);
    for (int c = 0; c < 2; ++c) {
      mbar_init(&k_full[c], kFillers);
      mbar_init(&v_full[c], kFillers);
      mbar_init(&k_empty[c], 4);  // the consumer's four warps
      mbar_init(&v_empty[c], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<S::kProducerRegs>();
    const int hk = h / rep;
    // per key tile: both halves of K (freed once S of the tile before is
    // summed), then both slabs of V (freed once its P V is done)
    if constexpr (!kTma) {
      // fp32: the whole warpgroup converts each tile into its place
      const int tid = threadIdx.x;
      const float* q_rows = head_rows(src.ptr[0], src.stride[0], b, h);
      const float* k_rows = head_rows(src.ptr[1], src.stride[1], b, hk);
      const float* v_rows = head_rows(src.ptr[2], src.stride[2], b, hk);
      for (int c = 0; c < 2; ++c) {
        convert_rows<kRows, kSlab>(q_s + c * kHalf, q_rows + kSlab * c,
                                   src.stride[0][1], q0, T,
                                   d_true - kSlab * c, tid);
      }
      fence_proxy_async();
      mbar_arrive(&q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const uint32_t parity = (j & 1) ^ 1;
        for (int which = 0; which < 2; ++which) {
          for (int c = 0; c < 2; ++c) {
            mbar_wait(which ? &v_empty[c] : &k_empty[c], parity);
            convert_rows<64, kSlab>(
                (which ? v_s : k_s) + c * kHalf,
                (which ? v_rows : k_rows) + kSlab * c,
                src.stride[which + 1][1], 64 * j, T, d_true - kSlab * c,
                tid);
            fence_proxy_async();
            mbar_arrive(which ? &v_full[c] : &k_full[c]);
          }
        }
      }
    } else if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&q_full, 2 * kHalf);
      for (int cb = 0; cb < 8; ++cb) {
        tma_load_4d(q_s + cb * kTile, &tm_q, &q_full, 64 * cb, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const uint32_t parity = (j & 1) ^ 1;
        for (int which = 0; which < 2; ++which) {
          for (int c = 0; c < 2; ++c) {
            uint64_t* full = which ? &v_full[c] : &k_full[c];
            mbar_wait(which ? &v_empty[c] : &k_empty[c], parity);
            mbar_arrive_expect_tx(full, kHalf);
            uint8_t* dst = (which ? v_s : k_s) + c * kHalf;
            for (int cb = 0; cb < 4; ++cb) {
              tma_load_4d(dst + cb * kTile, which ? &tm_v : &tm_k, full,
                          kSlab * c + 64 * cb, hk, 64 * j, b);
            }
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<S::kConsumerRegs>();
    const int c = wg - 1;  // slab c of O, for all 64 q rows of the block
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, +8
    const uint32_t q_addr = smem_addr(q_s) + c * kHalf;
    const uint32_t k_addr = smem_addr(k_s) + c * kHalf;
    const uint32_t v_addr = smem_addr(v_s) + c * kHalf;
    float4* mine = reinterpret_cast<float4*>(ex + c * kExFloats);
    const float4* theirs =
        reinterpret_cast<const float4*>(ex + (1 - c) * kExFloats);

    float acc[kSlab / 2];
#pragma unroll
    for (int i = 0; i < kSlab / 2; ++i) acc[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
    float l[2] = {0.f, 0.f};  // this thread's share of the running sum

    mbar_wait(&q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const uint32_t parity = j & 1;
      // this consumer's partial S = Q K^T over its half of the columns
      float sc[32];
      mbar_wait(&k_full[c], parity);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) {
        const uint32_t at = (ks / 4) * kTile + (ks % 4) * 32;
        wgmma_ss<64, Op>(sc, desc_sw128(q_addr + at, 16, 1024),
                         desc_sw128(k_addr + at, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&k_empty[c]);  // this warp is done with K

      // the exchange: S = the two partials' sum, the same bits in both
      if (j > 0) named_barrier(kBarRead + c, 256);  // the last one is read
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        mine[q * 128 + t] =
            make_float4(sc[4 * q], sc[4 * q + 1], sc[4 * q + 2], sc[4 * q + 3]);
      }
      named_barrier_arrive(kBarWritten + c, 256);
      named_barrier(kBarWritten + 1 - c, 256);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 x = theirs[q * 128 + t];
        sc[4 * q] += x.x;
        sc[4 * q + 1] += x.y;
        sc[4 * q + 2] += x.z;
        sc[4 * q + 3] += x.w;
      }
      if (j + 1 < n_tiles) named_barrier_arrive(kBarRead + 1 - c, 256);

      // scale into the log2 domain; mask the ragged tail and the diagonal
      const int k0 = 64 * j;
      const bool need_mask = k0 + 64 > T || (causal && k0 + 63 > q0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float x = sc[e] * scale_log2;
        if (need_mask) {
          const int col = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
          const int row = row0 + ((e >> 1) & 1) * 8;
          if (col >= T || (causal && col > row)) x = -CUDART_INF_F;
        }
        sc[e] = x;
      }

      // online softmax; the four threads of a quad share each row
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          mx = fmaxf(mx, fmaxf(sc[4 * jn + 2 * r], sc[4 * jn + 2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float base = (mx == -CUDART_INF_F) ? 0.f : mx;
        corr[r] = exp2f(m[r] - base);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          sc[4 * jn + 2 * r] = exp2f(sc[4 * jn + 2 * r] - base);
          sc[4 * jn + 2 * r + 1] = exp2f(sc[4 * jn + 2 * r + 1] - base);
          sum += sc[4 * jn + 2 * r] + sc[4 * jn + 2 * r + 1];
        }
        l[r] = l[r] * corr[r] + sum;
      }
#pragma unroll
      for (int jn = 0; jn < kSlab / 8; ++jn) {
        acc[4 * jn + 0] *= corr[0];
        acc[4 * jn + 1] *= corr[0];
        acc[4 * jn + 2] *= corr[1];
        acc[4 * jn + 3] *= corr[1];
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a<Op>(pa[kk], sc, kk);

      // O += P V over this consumer's slab
      mbar_wait(&v_full[c], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_cols<kSlab, Op>(acc, pa[kk], v_addr + kk * 16 * 128, kTile);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&v_empty[c]);
    }

    // epilogue: the slab's columns of O; lse from consumer 0
    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum = fmaxf(sum, 1e-30f);
      const float inv = 1.f / sum;
      const int row = row0 + r * 8;
      if (row >= T) continue;
      if (tg == 0 && c == 0) {
        lse[((int64_t)b * Hq + h) * T + row] = m[r] * kLn2 + logf(sum);
      }
      In* out = o + b * o_sb + h * o_sh + (int64_t)row * o_st;
#pragma unroll
      for (int jn = 0; jn < kSlab / 8; ++jn) {
        const int col = kSlab * c + 8 * jn + 2 * tg;
        if (col < d_true) {
          store2(out + col, acc[4 * jn + 2 * r] * inv,
                 acc[4 * jn + 2 * r + 1] * inv);
        }
      }
    }
  }
}

template <typename In>
int config_wide(int* out) {
  static_assert(wide::kSmem <= 232448,
                "a block may use 227 KB of shared memory");
  out[0] = wide::kSmem;
  out[1] = FwdSplit<wide::kConsumers, In>::kThreads;
  out[2] = FwdSplit<wide::kConsumers, In>::kLaunchRegs;
  out[3] = wide::kBlockM;
  return 0;
}

template <typename In>
int config_pair(int* out) {
  static_assert(pair::kSmem + 64 <= 232448,
                "a block may use 227 KB of shared memory");
  out[0] = pair::kSmem;
  out[1] = FwdSplit<2, In>::kThreads;
  out[2] = FwdSplit<2, In>::kLaunchRegs;
  out[3] = pair::kRows;
  return 0;
}

template <typename In>
int launch_pair(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int T, int Hq, int Hkv, int d_true,
                const long long* s, float scale_log2, int causal,
                cudaStream_t stream) {
  using S = FwdSplit<2, In>;
  CUtensorMap tm_q, tm_k, tm_v;
  Src src = {};
  int err = prepare_input<In>(&tm_q, &src, 0, q, B, T, Hq, d_true, s,
                              pair::kRows);
  if (!err) err = prepare_input<In>(&tm_k, &src, 1, k, B, T, Hkv, d_true,
                                    s + 3, 64);
  if (!err) err = prepare_input<In>(&tm_v, &src, 2, v, B, T, Hkv, d_true,
                                    s + 6, 64);
  auto kernel = flash_fwd_pair_kernel<In>;
  if (!err) err = prepare_launch(kernel, pair::kSmem, S::kLaunchRegs);
  if (err) return err;
  const int grid = cdiv(T, pair::kRows) * Hq * B;
  kernel<<<grid, S::kThreads, pair::kSmem, stream>>>(
      tm_q, tm_k, tm_v, src, static_cast<In*>(o), static_cast<float*>(lse),
      T, Hq, B, Hq / Hkv, d_true, s[9], s[10], s[11], scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int T, int Hq, int Hkv, int d_true,
                const long long* s, float scale_log2, int causal,
                cudaStream_t stream) {
  using S = FwdSplit<wide::kConsumers, In>;
  CUtensorMap tm_q, tm_k, tm_v;
  Src src = {};
  int err = prepare_input<In>(&tm_q, &src, 0, q, B, T, Hq, d_true, s,
                              wide::kBlockM);
  if (!err) err = prepare_input<In>(&tm_k, &src, 1, k, B, T, Hkv, d_true,
                                    s + 3, wide::kBlockN);
  if (!err) err = prepare_input<In>(&tm_v, &src, 2, v, B, T, Hkv, d_true,
                                    s + 6, wide::kBlockN);
  auto kernel = flash_fwd_wide_kernel<In>;
  if (!err) err = prepare_launch(kernel, wide::kSmem, S::kLaunchRegs);
  if (err) return err;
  const int grid =
      cdiv(T, wide::kBlockM) * Hq * B * cdiv(d_true, wide::kSlab);
  kernel<<<grid, S::kThreads, wide::kSmem, stream>>>(
      tm_q, tm_k, tm_v, src, static_cast<In*>(o), static_cast<float*>(lse),
      T, Hq, B, Hq / Hkv, d_true, s[9], s[10], s[11], scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation head_dim D runs on, <built D, stages, consumer
// warpgroups>: 64 (one consumer, two blocks a SM; up to kNarrowWidth with
// P in two parts), 128 and 256 (two), on q, k and v (qkv) as launch
// takes them; 257 to 512 the pair kernel, past 512 the slab kernel above,
// on the inputs.
template <typename In>
int launch_for(const void* const* qkv, int w8, void* o, void* lse,
               void* part, int n_split, int B, int T, int Hq, int Hkv, int D,
               const long long* s, float scale_log2, int causal,
               cudaStream_t stream) {
  if (D > wide::kSlab && w8 > 0) {
    return static_cast<int>(cudaErrorInvalidValue);  // copies up to 256
  }
  if (D > wide::kSlab && D <= pair::kMaxWidth) {
    return launch_pair<In>(qkv[0], qkv[1], qkv[2], o, lse, B, T, Hq, Hkv, D,
                           s, scale_log2, causal, stream);
  }
  if (D > wide::kSlab) {
    return launch_wide<In>(qkv[0], qkv[1], qkv[2], o, lse, B, T, Hq, Hkv, D,
                           s, scale_log2, causal, stream);
  }
  if (D <= kNarrowWidth) {  // P as two parts (flash_attention_sm90.cuh)
    return launch<64, 2, 1, In, 2>(qkv, w8, o, lse, nullptr, 0, B, T, Hq,
                                   Hkv, D, s, scale_log2, causal, stream);
  }
  if (D <= 64) {
    return launch<64, 2, 1, In>(qkv, w8, o, lse, nullptr, 0, B, T, Hq, Hkv,
                                D, s, scale_log2, causal, stream);
  }
  if (D <= 128) {
    return launch<128, 2, 2, In>(qkv, w8, o, lse, nullptr, 0, B, T, Hq, Hkv,
                                 D, s, scale_log2, causal, stream);
  }
  return launch<256, 2, 2, In>(qkv, w8, o, lse, part, n_split, B, T, Hq, Hkv,
                               D, s, scale_log2, causal, stream);
}

template <typename In>
int config_for(int D, int* out) {
  if (D > wide::kSlab && D <= pair::kMaxWidth) return config_pair<In>(out);
  if (D > wide::kSlab) return config_wide<In>(out);
  return D <= 64    ? config<64, 2, 1>(out)
         : D <= 128 ? config<128, 2, 2>(out)
                    : config<256, 2, 2>(out);
}

// A forward call's arguments, checked as the entry points take them
bool bad_forward(int B, int T, int Hq, int Hkv, int D, int d_head,
                 int n_split, int dtype, int causal, const void* part) {
  return B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 ||
         dtype != FLASH_DTYPE || bad_head_dim(D, d_head, dtype) ||
         n_split < 0 || n_split > cdiv(T, kSplitRows) ||
         (n_split > 0 &&
          (!causal || D <= 128 || D > wide::kSlab || part == nullptr));
}

}  // namespace

extern "C" {

// q, o: [B, T, Hq, D]; k, v: [B, T, Hkv, D], all of the type `dtype` names
// (0 bf16, 1 fp16, 2 fp32), the one this library is built for
// (FLASH_DTYPE); lse: [B, Hq, T] fp32 contiguous. strides: 12
// element strides (batch, time, head) of q, k, v and o in that order; the
// head_dim stride is 1, every stride a multiple of 16 bytes and every
// base 16-byte aligned. D is the tensors' head_dim, any D >= 1 with rows
// a multiple of 16 bytes; d_head <= D the true head_dim (the scale is
// 1/sqrt(d_head); columns d_head .. D - 1 are zeros the wrapper padded
// with). n_split: the q tiles (the last ones) split into two halves of
// their keys, 0 or, causal at 128 < D <= 256 only, up to cdiv(T, 128)
// (ray_tpu_torch/ops/flash_schedule.py chooses it); part, fp32, holds the
// halves' o [2, B, Hq, n_split, 128, 256] and then their lse [2, B, Hq,
// n_split, 128], null when n_split is 0. fp32 up to D 256 runs on the
// split pass's copies only (flash_attention_fwd_from_split). Launches on
// `stream` (the kernel and, split, the merge); returns 0 on success, else
// a cudaError_t or one of the codes that flash_attention_error_string
// names.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, void* part, int B, int T, int Hq, int Hkv,
                        int D, int d_head, int n_split, int dtype,
                        const long long* strides, int causal, void* stream) {
  if (bad_forward(B, T, Hq, Hkv, D, d_head, n_split, dtype, causal, part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(d_head));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* qkv[3] = {q, k, v};
  return launch_for<Built>(qkv, 0, o, lse, part, n_split, B, T, Hq, Hkv, D,
                           strides, scale_log2, causal, st);
}

// The split pass of fp32 inputs (flash_fwd_split_kernel): q [B, T, Hq, D]
// and k, v [B, T, Hkv, D] fp32 (dtype 2; this library built for it), D
// any width with 16-byte rows; strides: 9 element strides (batch, time,
// head) of q, k and v. Writes q_hi [B, T, Hq, w8] and k_hi, v_hi [B, T,
// Hkv, w8] bf16 contiguous, w8 = D rounded up to 8 (the columns past D
// zeros). `causal` is not read. Launches on `stream`; returns 0 on
// success, else a cudaError_t.
int flash_attention_fwd_split(const void* q, const void* k, const void* v,
                              void* q_hi, void* k_hi, void* v_hi, int B,
                              int T, int Hq, int Hkv, int D, int dtype,
                              const long long* strides, int causal,
                              void* stream) {
  (void)causal;
#if FLASH_DTYPE != 2
  return static_cast<int>(cudaErrorInvalidValue);  // the fp32 library's
#else
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 || dtype != FLASH_DTYPE ||
      bad_head_dim(D, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CopyStrides st;
  for (int i = 0; i < 9; ++i) st.s[i / 3][i % 3] = strides[i];
  const int blocks = cdiv(B * T * Hq, kCopyRows) + cdiv(B * T * Hkv,
                                                        kCopyRows);
  flash_fwd_split_kernel<<<blocks, 4 * kCopyRows, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<uint4*>(q_hi),
      static_cast<uint4*>(k_hi), static_cast<uint4*>(v_hi), B, T, Hq, Hkv,
      D, cdiv(D, 8) * 8, st);
  return static_cast<int>(cudaGetLastError());
#endif
}

// The fp32 forward at head_dim D <= 256 from the split pass's copies
// (q_hi, k_hi, v_hi: bf16, as flash_attention_fwd_split writes them for
// inputs of width D): o [B, T, Hq, D] fp32 at the 3 element strides
// (batch, time, head) in `strides`; lse, part, n_split and the rest as
// for flash_attention_fwd. Launches on `stream`; returns 0 on success,
// else a cudaError_t or one of the codes that
// flash_attention_error_string names.
int flash_attention_fwd_from_split(const void* q_hi, const void* k_hi,
                                   const void* v_hi, void* o, void* lse,
                                   void* part, int B, int T, int Hq, int Hkv,
                                   int D, int d_head, int n_split, int dtype,
                                   const long long* strides, int causal,
                                   void* stream) {
#if FLASH_DTYPE != 2
  return static_cast<int>(cudaErrorInvalidValue);  // the fp32 library's
#else
  if (bad_forward(B, T, Hq, Hkv, D, d_head, n_split, dtype, causal, part) ||
      D > wide::kSlab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(d_head));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* qkv[3] = {q_hi, k_hi, v_hi};
  long long s[12] = {};
  for (int i = 0; i < 3; ++i) s[9 + i] = strides[i];  // o's
  return launch_for<Built>(qkv, cdiv(D, 8) * 8, o, lse, part, n_split, B, T,
                           Hq, Hkv, D, s, scale_log2, causal, st);
#endif
}

// The launch shape of the kernel that head_dim D of type `dtype` runs on:
// out[0] bytes of dynamic shared memory, out[1] threads a block, out[2]
// registers a thread at launch, out[3] q rows a block. Returns 0, or
// cudaErrorInvalidValue for a D or type the library does not take.
int flash_attention_fwd_config(int D, int dtype, int* out) {
  if (dtype != FLASH_DTYPE || bad_head_dim(D, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return config_for<Built>(D, out);
}

const char* flash_attention_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"

// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, bf16, fp16
// or fp32 in, fp32 accumulate.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// ray_tpu/ops/flash_attention.py (launched by `_bwd`). Both recompute the
// probabilities from the forward's row logsumexp instead of storing them:
//   P  = exp(S * scale - lse),   S = Q K^T
//   dP = dO V^T,   dS = P o (dP - delta) * scale,   delta = rowsum(O o dO)
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO.
// lse is in natural-log units (as the forward stores it); the kernels
// move it into the log2 domain once per row and use exp2f, so P is
// exp(S * scale - lse) exactly as in the plain version. The dQ kernel
// also computes delta (the JAX package takes it in jnp outside its
// kernels) and writes it out for the dK/dV kernel, launched next.
//
// What bounds them on this card: operations. dQ does three products per
// unmasked (query, key) pair (S, dP, dS K), 6 * D flops; dK/dV four
// (S^T, dP^T, P^T dO, dS^T Q), 8 * D flops, against a few bytes per row
// of each input. Both keep the T x T matrices out of device memory, and
// both are wgmma kernels fed by TMA (flash_attention_sm90.cuh): a
// producer warpgroup whose first warp keeps a ring of mbarrier-guarded
// stages full, and consumer warpgroups of 64 rows; setmaxnreg moves
// registers from the producer (24) to the consumers.
//
// dQ, the forward's loop with one more product:
// - one block per (q tile, q head, batch) on a 1-D grid, causal blocks
//   longest first with heads inner, so the rep q heads that share a kv
//   head run side by side and read its K/V from L2; at head_dim 128 two
//   consumers (128 q rows, 384 threads, one block a SM), at head_dim 64
//   one (64 q rows, 256 threads, two blocks a SM; see dqk::Shape);
// - Q and dO of the block arrive once by TMA and stay; the producer
//   keeps a ring of K and V stages (64 keys at head_dim 128, 128 at 64)
//   full, K one tile ahead of V, each with its own full and empty
//   barrier, up to the diagonal when causal;
// - before the loop each consumer takes delta = rowsum(O o dO) of its
//   64 rows in fp32 (O from device memory, dO from the resident tile),
//   in a fixed order, keeps it in the accumulator's row layout and
//   writes it to delta [B, Hq, T];
// - per tile: S = Q K^T and dP = dO V^T (SS form), committed as two
//   groups; P = exp2 of S while dP is still in flight; then
//   dS = P (dP - delta) scale, rounded to bf16 as the A operand of
//   dQ += dS K (RS form, the K stage read as MN-major B). V's stage is
//   freed after dP, K's after the RS product. A consumer whose rows all
//   precede a tile's keys (the diagonal's last tile of the first
//   consumer) waits for it and frees it without computing.
//
// dQ at head_dim 256 (flash_bwd_dq256_kernel, below): a block of 64 q
// rows and two consumers, one computing S and P, the other delta, dP and
// dS, each adding dS K into its own 128 columns of dQ.
//
// dK/dV:
// - one block per (64-row kv tile, kv head, batch), 384 threads: a
//   producer warpgroup and two consumer warpgroups (240 registers);
// - K and V of the tile arrive once by TMA and stay in shared memory;
//   the producer's first warp keeps a ring of stages (3 at head_dim 64,
//   2 at 128) of 128 q rows of Q and dO (TMA) plus their rows of lse
//   (moved to the log2 domain) and delta (plain loads), over the rep q
//   heads of the kv head and, when causal, the q rows from the diagonal
//   on;
// - each consumer takes 64 of a stage's q rows against all 64 keys:
//   S^T = K Q^T and dP^T = V dO^T (wgmma SS form), P^T and dS^T in fp32,
//   then dV += P^T dO and dK += dS^T Q (RS form, P^T and dS^T rounded to
//   bf16 as the A operand);
// - the GQA group-sum happens in the fp32 accumulators, and the two
//   consumers' sums meet in shared memory at the end, first plus second:
//   no per-head buffers, no atomics; splitting the q rows between two
//   consumers halves the longest block's walk (kv tile 0 under causal),
//   and blocks run longest first (low kv tiles, of every head);
// - at head_dim 256 the dK and dV accumulators of 64 kv rows (2 x 128
//   floats a thread) would not fit a consumer's 240 registers, so the two
//   consumers split the columns instead of the q rows: each computes S^T
//   and dP^T of all 64 q rows of a stage (contracted over all 256
//   columns; both compute them, 1.5x the products), then dV and dK of its
//   own 128 columns, which it writes itself. Stages are 64 q rows.
//
// dK/dV at head_dim 256, split. A block fills an SM (200 KB of shared
// memory), and the grid is cdiv(T, 64) * Hkv * B blocks: under MQA at a
// 2k prefill (Gemma-2B's 8/1 heads) 32 blocks on 132 SMs, kv tile 0
// walking 8 heads x 32 stages while the card averages 32 stages an SM,
// so the launch was bound by one SM's walk, not by operations. Where the
// unsplit grid is under one block an SM, the wrapper
// (ray_tpu_torch/ops/flash_schedule.py:dkv_split, from the shape and the
// SM count only) cuts each kv tile's (q head, q stage) pairs, in the
// head-major order a block walks them, into n_split contiguous chunks
// [n * c / n_split, n * (c + 1) / n_split), a block each, chunks innermost
// on the grid and kv tiles longest first as before. A chunk's block
// writes its fp32 partial dK and dV (the GQA group-sum of its own heads)
// to part [2, n_split, B, T, Hkv, 256]; flash_bwd_dkv_reduce_kernel then
// adds the partials of each row in chunk order, 0, 1, ..., never in the
// order the blocks ended, and writes dK and dV in the input type: no
// atomics, so the result is bitwise repeatable. At n_split 1 the block
// runs as before and writes dK and dV itself. At 2k x 8/1: 8 chunks of
// 32 stages, 256 blocks, and a pass over 33.5 MB of partials.
//
// Types (flash_attention_sm90.cuh, `Elem`): bf16 and fp16 run wgmma in
// their own type (P and dS are rounded to it as A operands); fp32 inputs
// run the bf16 products on tiles rounded to bf16: an fp32 call computes
// its products with bf16 operands and fp32 sums. Both kernels load fp32
// tiles by TMA from the bf16 copies that the split pass
// (flash_bwd_split_kernel, below) writes once a call (a whole backward
// call's dQ and dK/dV share one pass), through the one-thread producer
// of bf16 (24 registers).
// delta is taken from O and dO in fp32 as they lie in device memory, so
// dP = dO V^T, which dS sets against it, takes dO and V each as two bf16
// tiles (the rounded value and what the rounding left) in three products,
// hi hi + lo hi + hi lo: with one rounded product, dP - delta, which is 0
// where a row has one key, came out at the operands' rounding (2^-9 of
// |dO| |V|) and failed the block gate at T = 1. The extra tiles cost the
// rings stages: dQ keeps one at head_dim 256, dK/dV one at 128 and 256.
// Outputs are written in the input type.
//
// Up to kNarrowWidth columns (flash_attention_sm90.cuh) both take their A
// operands (dS; P^T and dS^T) in two parts, the rounded value and what
// the rounding left, two products where one was (kParts = 2).
//
// Both kernels are built for head_dim 64, 128 and 256; a narrower head_dim is
// read through TMA maps of its true width (missing columns arrive as
// zeros and add exact zeros to every product), scaled by 1/sqrt(true
// head_dim) and stored at its true width. A head_dim past 256 runs on the
// slab kernels (flash_bwd_dq_wide_kernel, flash_bwd_dkv_cluster_kernel
// and flash_bwd_dkv_wide_kernel below), any width. Both mask the causal
// diagonal
// and the ragged tail (positions >= T; rows past T arrive as zeros and
// are never stored), so any T >= 1 runs on them; inputs are read
// through their [B, T, H, D] strides; no atomics, and the one split over
// the reduced axis across blocks (dK/dV at head_dim 256, above) is summed
// in a fixed order, so results are bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------- fp32: the split pass
//
// fp32 inputs reach the products as bf16 tiles (Elem<float>). Before this
// pass the dQ kernel's producer warpgroup converted every tile itself
// (convert_rows, no TMA, 40 registers, each K and V tile once a q tile's
// block), and dQ of "train f32" took 7.4x the bf16 dQ's time. The split
// pass does the rounding once a call instead, bound by bytes: it reads q,
// k, v, o and dO (fp32) once and writes bf16 copies [B, T, H, w8] (w8:
// the width rounded up to 8 columns, 16-byte rows, the rest zeros) of q
// and k (hi = RN(x)), of v and dO with their rests (lo = RN(x - hi)),
// exactly convert_rows's rounding, and delta = rowsum(o o dO) in fp32 in
// the order the dQ kernel took it (the quad of a row takes its 8-column
// chunks tg, tg + 4, ... in order, each element by element, then sums
// the four partials by butterfly). The dQ kernel then loads every tile by
// TMA, the rests included, so each product sees the operands it saw when
// its producer converted them; the dK/dV kernel loads the same copies
// (q, k, v and its rest, dO and its rest), so a whole backward call
// rounds once. A thread an 8-column chunk: 64 rows a block of 256
// threads, four threads a row; q-sized rows (q, o, dO) in the first
// blocks, kv-sized rows (k, v) after them. Without o (a dK/dV call given
// delta) the pass writes the copies alone.
constexpr int kSplitRows = 64;  // rows a block

// strides (batch, time, head) of q, k, v, o and dO, in elements
struct SplitStrides {
  long long s[5][3];
};

__global__ void __launch_bounds__(4 * kSplitRows)
    flash_bwd_split_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           uint4* __restrict__ q_hi, uint4* __restrict__ k_hi,
                           uint4* __restrict__ v_hi, uint4* __restrict__ v_lo,
                           uint4* __restrict__ do_hi,
                           uint4* __restrict__ do_lo,
                           float* __restrict__ delta, int B, int T, int Hq,
                           int Hkv, int d_true, int w8,
                           const SplitStrides st) {
  const int tg = threadIdx.x % 4;
  const int q_blocks = cdiv(B * T * Hq, kSplitRows);
  const bool q_sized = blockIdx.x < q_blocks;
  const int H = q_sized ? Hq : Hkv;
  // row (b, t, h), h fastest, of the copies [B, T, H, w8]
  const int64_t row = (int64_t)(q_sized ? blockIdx.x : blockIdx.x - q_blocks) *
                          kSplitRows + threadIdx.x / 4;
  const bool live = row < (int64_t)B * T * H;
  const int h = row % H, t = (row / H) % T, b = row / ((int64_t)H * T);
  const int n_ch = w8 / 8;  // 16-byte chunks of a copy's row
  auto at = [&](const float* base, int i) {
    return base + b * st.s[i][0] + t * st.s[i][1] + h * st.s[i][2];
  };
  float x[8];
  if (q_sized) {
    float sum = 0.f;
    if (live) {
      const float *q_row = at(q, 0), *do_row = at(dout, 4);
      for (int ch = tg; ch < n_ch; ch += 4) {
        const int64_t out = row * n_ch + ch;
        load8(q_row, 8 * ch, d_true, x);
        split8(x, q_hi + out, nullptr);
        load8(do_row, 8 * ch, d_true, x);
        split8(x, do_hi + out, do_lo + out);
        if (o == nullptr) continue;  // the copies alone
        float y[8];
        load8(at(o, 3), 8 * ch, d_true, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (8 * ch + e < d_true) sum += y[e] * x[e];
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (tg == 0 && live && o != nullptr) {
      delta[((int64_t)b * Hq + h) * T + t] = sum;
    }
  } else if (live) {
    const float *k_row = at(k, 1), *v_row = at(v, 2);
    for (int ch = tg; ch < n_ch; ch += 4) {
      const int64_t out = row * n_ch + ch;
      load8(k_row, 8 * ch, d_true, x);
      split8(x, k_hi + out, nullptr);
      load8(v_row, 8 * ch, d_true, x);
      split8(x, v_hi + out, v_lo + out);
    }
  }
}

// -------------------------------------------------------------------- dQ

namespace dqk {

// The kernel's shape per head_dim: keys a K/V stage, stages, consumer
// warpgroups a block. At 128 two consumers (128 q rows, one block a SM)
// on 64-key stages (128-key S and dP would not fit the registers); at 64
// one consumer (64 q rows, two blocks a SM) on 128-key stages: on an
// H100 two consumers were no faster, and 64-key stages slower. Head_dim
// 256 runs on flash_bwd_dq256_kernel.
template <int D>
struct Shape;
template <>
struct Shape<64> {
  static constexpr int kBlockN = 128, kStages = 2, kConsumers = 1;
};
template <>
struct Shape<128> {
  static constexpr int kBlockN = 64, kStages = 3, kConsumers = 2;
};

// the register split: the producer is one TMA thread for every type
// (fp32 inputs arrive as the split pass's bf16 copies)
template <int D, typename In>
using DqSplit = Split<Shape<D>::kConsumers>;

// stages of the K/V ring: fp32 stages hold V twice (rounded, and what the
// rounding left), so two
template <int D, typename In>
__host__ __device__ constexpr int stages() {
  return Elem<In>::kTma ? Shape<D>::kStages : 2;
}

}  // namespace dqk

template <int D, typename In, int kParts = 1>
__global__ void __launch_bounds__(dqk::DqSplit<D, In>::kThreads,
                                  dqk::DqSplit<D, In>::kBlocksPerSm)
    flash_bwd_dq_kernel(__grid_constant__ const CUtensorMap tm_q,
                        __grid_constant__ const CUtensorMap tm_k,
                        __grid_constant__ const CUtensorMap tm_v,
                        __grid_constant__ const CUtensorMap tm_do,
                        const In* __restrict__ o,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, In* __restrict__ dq,
                        int T, int Hq, int B, int rep, int d_true,
                        int64_t o_sb, int64_t o_st, int64_t o_sh,
                        int64_t dq_sb, int64_t dq_st, int64_t dq_sh,
                        float scale, int causal,
                        __grid_constant__ const CUtensorMap tm_v_lo,
                        __grid_constant__ const CUtensorMap tm_do_lo) {
  constexpr int kBlockN = dqk::Shape<D>::kBlockN;  // keys a stage
  constexpr int kStages = dqk::stages<D, In>();
  constexpr int kConsumers = dqk::Shape<D>::kConsumers;
  using S = dqk::DqSplit<D, In>;
  using Op = typename Elem<In>::Op;
  // fp32: every tile arrives by TMA from the split pass's bf16 copies
  // (flash_bwd_split_kernel), dO's and V's rests in tiles of their own
  // (tm_do_lo, tm_v_lo), and delta is the split pass's
  constexpr bool kLo = !Elem<In>::kTma;
  constexpr int kBlockM = 64 * kConsumers;    // q rows of the block
  constexpr int kColBlocks = D / 64;          // 64-column TMA boxes per row
  constexpr int kQBytes = kBlockM * D * 2;    // Q or dO
  constexpr int kKVBytes = kBlockN * D * 2;   // K or V of one stage
  // a stage's tiles: K, V (fp32: and what rounding V to bf16 left)
  constexpr int kStageTiles = kLo ? 3 : 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages], v_full[kStages],
      k_empty[kStages], v_empty[kStages];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + kQBytes;
  // fp32: what rounding dO to bf16 left, a tile of its own
  uint8_t* do_lo_s = do_s + kQBytes;
  uint8_t* kv_s = do_lo_s + (kLo ? kQBytes : 0);  // the stages

  const int heads = Hq * B;
  const int n_qtiles = cdiv(T, kBlockM);
  const int rank = blockIdx.x / heads;  // heads inner: longest tiles first
  const int qtile = causal ? n_qtiles - 1 - rank : rank;
  const int h = (blockIdx.x % heads) % Hq, b = (blockIdx.x % heads) / Hq;
  const int q0 = qtile * kBlockM;
  const int n_tiles = cdiv(causal ? min(q0 + kBlockM, T) : T, kBlockN);

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
      // tile j's K or V (fp32: V with its rest) into its stage, once the
      // consumers have freed it
      auto load = [&](int j, int which, uint64_t* full, uint64_t* empty) {
        const int s = j % kStages;
        const bool lo = kLo && which;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], (lo ? 2 : 1) * kKVBytes);
        uint8_t* dst = kv_s + (kStageTiles * s + which) * kKVBytes;
#pragma unroll
        for (int cb = 0; cb < kColBlocks; ++cb) {
          tma_load_4d(dst + cb * kBlockN * 128, which ? &tm_v : &tm_k,
                      &full[s], cb * 64, hk, j * kBlockN, b);
        }
        if (lo) {
#pragma unroll
          for (int cb = 0; cb < kColBlocks; ++cb) {
            tma_load_4d(dst + kKVBytes + cb * kBlockN * 128, &tm_v_lo,
                        &full[s], cb * 64, hk, j * kBlockN, b);
          }
        }
      };
      mbar_arrive_expect_tx(&q_full, (kLo ? 3 : 2) * kQBytes);
#pragma unroll
      for (int cb = 0; cb < kColBlocks; ++cb) {
        tma_load_4d(q_s + cb * kBlockM * 128, &tm_q, &q_full, cb * 64, h, q0,
                    b);
        tma_load_4d(do_s + cb * kBlockM * 128, &tm_do, &q_full, cb * 64, h,
                    q0, b);
        if constexpr (kLo) {
          tma_load_4d(do_lo_s + cb * kBlockM * 128, &tm_do_lo, &q_full,
                      cb * 64, h, q0, b);
        }
      }
      // K runs one tile ahead of V, as the consumers use them
      load(0, 0, k_full, k_empty);
      for (int j = 0; j < n_tiles; ++j) {
        if (j + 1 < n_tiles) load(j + 1, 0, k_full, k_empty);
        load(j, 1, v_full, v_empty);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<S::kConsumerRegs>();
    const int c = wg - 1;  // q rows 64c .. 64c + 63 of the tile
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = 64 * c + 16 * w + g;  // this thread's tile rows: r0, +8
    const int row0 = q0 + r0;
    // the tiles this consumer computes: none without real rows, up to
    // its own diagonal when causal (the block's last tile may lie past
    // the first consumer's rows)
    const int n_live = q0 + 64 * c >= T ? 0
                       : causal ? cdiv(min(q0 + 64 * c + 64, T), kBlockN)
                                : n_tiles;
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_addr = smem_addr(q_s) + c * 64 * 128;
    const uint32_t do_addr = smem_addr(do_s) + c * 64 * 128;
    const uint32_t do_lo_addr = smem_addr(do_lo_s) + c * 64 * 128;
    const uint32_t kv_addr = smem_addr(kv_s);

    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < T ? lse[((int64_t)b * Hq + h) * T + row] * kLog2e : 0.f;
    }

    mbar_wait(&q_full, 0);
    if constexpr (kLo) {
      // fp32: delta as the split pass took it, from O and dO as they lie
      // in device memory
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        dlt[r] = row < T ? delta[((int64_t)b * Hq + h) * T + row] : 0.f;
      }
    } else {
      // delta = rowsum(O o dO): the quad of a row takes its 8-column
      // chunks tg, tg + 4, ... in order, then sums the four partials
      // (butterfly; every lane ends with the same bits)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tr = r0 + 8 * r, row = q0 + tr;
        float sum = 0.f;
        if (row < T) {
          const In* o_row = o + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
          for (int i = 0; i < D / 32; ++i) {
            const int ch = tg + 4 * i;  // 8 columns at 8 * ch
            if (8 * ch >= d_true) continue;
            const uint4 ov = *reinterpret_cast<const uint4*>(o_row + 8 * ch);
            // dO's chunk in the 128-byte-swizzled tile (16-byte chunk
            // index XOR the row's index within its 8-row atom)
            const uint4 dv = *reinterpret_cast<const uint4*>(
                do_s + (ch / 8) * kBlockM * 128 + tr * 128 +
                (((ch % 8) ^ (tr & 7)) << 4));
            const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
            const uint32_t* do2 = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 a = unpack2<In>(o2[e]);
              const float2 d = unpack2<In>(do2[e]);
              sum += a.x * d.x;  // 16-bit x 16-bit is exact in fp32
              sum += a.y * d.y;
            }
          }
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        dlt[r] = sum;
        if (tg == 0 && row < T) delta[((int64_t)b * Hq + h) * T + row] = sum;
      }
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < n_live; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t k_addr = kv_addr + kStageTiles * s * kKVBytes;
      const uint32_t v_addr = k_addr + kKVBytes;
      const int k0 = j * kBlockN;
      // both stages before either product: a barrier wait (a loop) while
      // S is in flight made ptxas serialise every wgmma (C7520)
      mbar_wait(&k_full[s], parity);
      mbar_wait(&v_full[s], parity);

      // S = Q K^T and dP = dO V^T: 64 rows x kBlockN keys, two groups
      float sc[kBlockN / 2], dp[kBlockN / 2];
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
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss<kBlockN, Op>(
            dp, desc_sw128(do_addr + (ks / 4) * kBlockM * 128 + col, 16, 1024),
            desc_sw128(v_addr + (ks / 4) * kBlockN * 128 + col, 16, 1024),
            ks > 0);
      }
      if constexpr (kLo) {
        // fp32: dP += dO_lo V_hi^T + dO_hi V_lo^T (the tiles' rests)
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t col = (ks % 4) * 32;
          const uint32_t a_off = (ks / 4) * kBlockM * 128 + col;
          const uint32_t b_off = (ks / 4) * kBlockN * 128 + col;
          wgmma_ss<kBlockN, Op>(dp, desc_sw128(do_lo_addr + a_off, 16, 1024),
                                desc_sw128(v_addr + b_off, 16, 1024), 1);
          wgmma_ss<kBlockN, Op>(dp, desc_sw128(do_addr + a_off, 16, 1024),
                                desc_sw128(v_addr + kKVBytes + b_off, 16,
                                           1024),
                                1);
        }
      }
      wgmma_commit();

      // P, while dP is in flight; mask the ragged tail and the diagonal
      wgmma_wait<1>();
      fence_regs(sc);
      const bool need_mask =
          k0 + kBlockN > T || (causal && k0 + kBlockN - 1 > q0 + 64 * c);
#pragma unroll
      for (int e = 0; e < kBlockN / 2; ++e) {
        float p = exp2f(sc[e] * scale_log2 - lse2[(e >> 1) & 1]);
        if (need_mask) {
          const int col = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
          const int row = row0 + ((e >> 1) & 1) * 8;
          if (col >= T || (causal && col > row)) p = 0.f;
        }
        sc[e] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      if (lane == 0) mbar_arrive(&v_empty[s]);  // this warp is done with V

      // dS = P (dP - delta) scale, as A registers of the operand type
      uint32_t dsa[kBlockN / 16][4];
#pragma unroll
      for (int e = 0; e < kBlockN / 2; ++e) {
        dp[e] = sc[e] * (dp[e] - dlt[(e >> 1) & 1]) * scale;
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a<Op>(dsa[kk], dp, kk);
      // narrow head_dims: dS also as what its rounding left
      uint32_t dsa_lo[kParts > 1 ? kBlockN / 16 : 1][4];
      if constexpr (kParts > 1) {
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          pack_a_rest<Op>(dsa_lo[kk], dsa[kk], dp, kk);
        }
      }

      // dQ += dS K: the stage's keys are the contraction
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs_cols<D, Op>(acc, dsa[kk], k_addr + kk * 16 * 128,
                             kBlockN * 128);
      }
      if constexpr (kParts > 1) {
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          wgmma_rs_cols<D, Op>(acc, dsa_lo[kk], k_addr + kk * 16 * 128,
                               kBlockN * 128);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&k_empty[s]);  // and with K
    }
    // the block's other tiles: freed once loaded (freeing a stage before
    // its load would complete the empty barrier's earlier phase, which
    // the other consumer may still be reading)
    for (int j = n_live; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      mbar_wait(&k_full[s], parity);
      mbar_wait(&v_full[s], parity);
      if (lane == 0) {
        mbar_arrive(&k_empty[s]);
        mbar_arrive(&v_empty[s]);
      }
    }

    // epilogue: dQ in q's dtype, the true columns of the real rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= T) continue;
      In* out = dq + b * dq_sb + h * dq_sh + (int64_t)row * dq_st;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        const int col = 8 * jn + 2 * tg;
        if (col < d_true) {
          store2(out + col, acc[4 * jn + 2 * r], acc[4 * jn + 2 * r + 1]);
        }
      }
    }
  }
}

// -DWIDE_TRACE=1 (chip_kernel_probe.py --trace) counts clock64 cycles by
// phase of the steps of the head_dim-256 dQ kernel and of the cluster
// dK/dV kernel (below) in wide_trace, per consumer, summed over its blocks
// (thread 0 of each consumer); off, it is nothing
#ifndef WIDE_TRACE
#define WIDE_TRACE 0
#endif
#if WIDE_TRACE
__device__ unsigned long long wide_trace[2][16];
#define TRACE_START long long tr_last = clock64();
#define TRACE(i)                                                 \
  if (t == 0) {                                                  \
    const long long now = clock64();                             \
    atomicAdd(&wide_trace[c][i], (unsigned long long)(now - tr_last)); \
    tr_last = now;                                               \
  }
#else
#define TRACE_START
#define TRACE(i)
#endif

// ------------------------------------------------------ dQ at head_dim 256
//
// flash_bwd_dq256_kernel replaces flash_bwd_dq_kernel at head_dim 256 (any
// head_dim 129-256 is read at 256) for bf16, fp16 and fp32; same function,
// same bits. With one consumer warpgroup a block (Q and dO of 64 rows and
// two stages of 64-key K and V filled 193 KB, one block an SM) that one
// warpgroup issued S, dP and dQ += dS K in turn and did every elementwise
// step between them, its 64 x 256 fp32 accumulator (128 registers a
// thread) leaving no room to keep one product in flight behind another: a
// step of three 64 x 64 x 256 products took about 3.3x their time on an
// H100 (PERF.md). Here a block of 64 q rows has two consumer warpgroups
// (and the one-thread producer, 240 registers a consumer), dividing the
// work as the slab dQ kernel does (flash_bwd_dq_wide_kernel, below):
// - consumer 0 computes S = Q K^T over all 256 columns, masks it, forms P
//   with the lse and hands P to consumer 1 in fp32 through shared memory,
//   in the accumulator's fragment order (thread t's element e at float
//   e * 128 + t), behind named barrier kBarP;
// - consumer 1 takes delta (16-bit inputs: rowsum(O o dO) as
//   flash_bwd_dq_kernel takes it; fp32: the split pass's), computes dP =
//   dO V^T (fp32: with the products of the rests), reads P, forms dS = P
//   (dP - delta) scale and hands dS, rounded to the operand type, to
//   consumer 0 behind kBarDs;
// - each adds dQ[:, 128c : 128c + 128] += dS K[:, 128c : 128c + 128] over
//   its own half of the columns (a 64-register accumulator);
// - each holds the A operand of its product, Q or dO of the block's rows,
//   in registers (64 a thread) and runs S and dP in the RS form: the
//   products read only K or V from shared memory, and with bf16 and fp16
//   inputs the rows of Q and dO take a third K/V stage once both
//   consumers hold them. With three stages each consumer issues the next
//   tile's S or dP as soon as this tile's is consumed (consumer 0: P
//   written; consumer 1: dS written), so it runs under the rest of the
//   hand-off and under dS K; fp32 (whose stages hold V's rest, and whose
//   dO rest stays in shared memory for dP) keeps one stage and issues the
//   next product after dS K. V's stage is freed once dP has completed,
//   K's once both halves of dS K have.
// Every product has the operands, roundings and k-order of
// flash_bwd_dq_kernel's (its dS K was two 128-column products of the same
// descriptors, one a half; its S and dP read Q and dO from shared memory,
// the same bf16 values), P and dS are formed from the same fp32 values in
// the same expressions, and each dQ column sums the same keys in the same
// order: dq and delta are bitwise flash_bwd_dq_kernel's.
namespace dq256 {

constexpr int kD = 256;
constexpr int kRows = 64;                // q rows of a block
constexpr int kKeys = 64;                // keys of a K/V stage
constexpr int kHalf = kD / 2;            // dQ columns a consumer owns
constexpr int kColBytes = 64 * 128;      // 64 rows of 64 16-bit columns
constexpr int kTileBytes = 4 * kColBytes;  // 64 rows of 256 columns
// P of a tile, 64 x 64 fp32, and dS, 64 x 64 in the operand type, both in
// the accumulator's fragment order
constexpr int kPBytes = 4 * 32 * 128;
constexpr int kDsBytes = 4 * 16 * 128;
// named barriers of the hand-offs (0 is __syncthreads): P written, dS
// written
constexpr int kBarP = 1, kBarDs = 2;
using DqSplit = Split<2>;

// The tiles of a K/V stage (K, V; fp32: V's rest), and of the resident
// rows (Q, dO; fp32: dO's rest). K/V stages: 16-bit three, two of their
// own and the third over the rows of Q and dO, free once the consumers
// hold Q and dO in registers; fp32 one (its stages hold V's rest, and dO's
// rest stays in shared memory for dP).
template <typename In>
__host__ __device__ constexpr int tiles() {
  return Elem<In>::kTma ? 2 : 3;
}
template <typename In>
__host__ __device__ constexpr int stages() {
  return Elem<In>::kTma ? 3 : 1;
}
template <typename In>
__host__ __device__ constexpr int own_stages() {
  return Elem<In>::kTma ? 2 : 1;
}
template <typename In>
__host__ __device__ constexpr int smem() {  // + 1024: tile alignment
  return tiles<In>() * kTileBytes * (1 + own_stages<In>()) + kPBytes +
         kDsBytes + 1024;
}

}  // namespace dq256

template <typename In>
__global__ void __launch_bounds__(dq256::DqSplit::kThreads, 1)
    flash_bwd_dq256_kernel(__grid_constant__ const CUtensorMap tm_q,
                           __grid_constant__ const CUtensorMap tm_k,
                           __grid_constant__ const CUtensorMap tm_v,
                           __grid_constant__ const CUtensorMap tm_do,
                           const In* __restrict__ o,
                           const float* __restrict__ lse,
                           float* __restrict__ delta, In* __restrict__ dq,
                           int T, int Hq, int B, int rep, int d_true,
                           int64_t o_sb, int64_t o_st, int64_t o_sh,
                           int64_t dq_sb, int64_t dq_st, int64_t dq_sh,
                           float scale, int causal,
                           __grid_constant__ const CUtensorMap tm_v_lo,
                           __grid_constant__ const CUtensorMap tm_do_lo) {
  using namespace dq256;
  using S = DqSplit;
  using Op = typename Elem<In>::Op;
  constexpr bool kLo = !Elem<In>::kTma;  // fp32: the rests of dO and V
  constexpr int kStages = stages<In>();
  constexpr int kOwn = own_stages<In>();
  constexpr int kStageTiles = tiles<In>();
  // 16-bit: the next tile's S or dP is issued as soon as this tile's
  // is consumed (consumer 0: P written; consumer 1: dS written), and runs
  // under the rest of the hand-off and dS K; fp32 (one stage): after this
  // tile's dS K
  constexpr bool kAhead = kStages > 1;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, qdo_free;
  __shared__ __align__(8) uint64_t k_full[kStages], v_full[kStages],
      k_empty[kStages], v_empty[kStages];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + kTileBytes;
  uint8_t* do_lo_s = do_s + kTileBytes;  // fp32 only
  uint8_t* kv_s = do_s + (kLo ? 2 : 1) * kTileBytes;
  float* ex_p =
      reinterpret_cast<float*>(kv_s + kOwn * kStageTiles * kTileBytes);
  uint32_t* ex_ds = reinterpret_cast<uint32_t*>(ex_p + kPBytes / 4);
  // K (which 0) or V (1) of stage s; a stage past the block's own lies
  // over Q and dO
  auto stage_tile = [&](int s, int which) -> uint8_t* {
    return s < kOwn ? kv_s + (kStageTiles * s + which) * kTileBytes
                    : which ? do_s : q_s;
  };

  const int heads = Hq * B;
  const int n_qtiles = cdiv(T, kRows);
  const int rank = blockIdx.x / heads;  // heads inner: longest tiles first
  const int qtile = causal ? n_qtiles - 1 - rank : rank;
  const int h = (blockIdx.x % heads) % Hq, b = (blockIdx.x % heads) / Hq;
  const int q0 = qtile * kRows;
  const int n_tiles = cdiv(causal ? min(q0 + kRows, T) : T, kKeys);

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&qdo_free, 8);  // both consumers' warps
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // both consumers' warps (dS K)
      mbar_init(&v_empty[s], 4);  // consumer 1's (dP)
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
      // tile j's K or V (fp32: V with its rest) into its stage, once the
      // consumers have freed it
      auto load = [&](int j, int which, uint64_t* full, uint64_t* empty) {
        const int s = j % kStages;
        const bool lo = kLo && which;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], (lo ? 2 : 1) * kTileBytes);
        uint8_t* dst = stage_tile(s, which);
#pragma unroll
        for (int cb = 0; cb < 4; ++cb) {
          tma_load_4d(dst + cb * kColBytes, which ? &tm_v : &tm_k, &full[s],
                      cb * 64, hk, j * kKeys, b);
        }
        if (lo) {
#pragma unroll
          for (int cb = 0; cb < 4; ++cb) {
            tma_load_4d(dst + kTileBytes + cb * kColBytes, &tm_v_lo,
                        &full[s], cb * 64, hk, j * kKeys, b);
          }
        }
      };
      mbar_arrive_expect_tx(&q_full, (kLo ? 3 : 2) * kTileBytes);
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) {
        tma_load_4d(q_s + cb * kColBytes, &tm_q, &q_full, cb * 64, h, q0, b);
        tma_load_4d(do_s + cb * kColBytes, &tm_do, &q_full, cb * 64, h, q0,
                    b);
        if constexpr (kLo) {
          tma_load_4d(do_lo_s + cb * kColBytes, &tm_do_lo, &q_full, cb * 64,
                      h, q0, b);
        }
      }
      // V before K: V's stage is freed a step before K's (dP completes
      // before dS K)
      for (int j = 0; j < n_tiles; ++j) {
        // the stage over Q and dO, once the consumers hold them
        if (kStages > kOwn && j == kOwn) mbar_wait(&qdo_free, 0);
        load(j, 1, v_full, v_empty);
        load(j, 0, k_full, k_empty);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<S::kConsumerRegs>();
    // 0: S and P; 1: delta, dP and dS; consumer c adds dS K into dQ's
    // columns 128c .. 128c + 127
    const int c = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = 16 * w + g;  // this thread's tile rows: r0, r0 + 8
    const int row0 = q0 + r0;
    const float scale_log2 = scale * kLog2e;
    const uint32_t do_lo_addr = smem_addr(do_lo_s);

    // consumer 0: lse in the log2 domain; consumer 1: delta
    float rowv[2];
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        rowv[r] = row < T ? lse[((int64_t)b * Hq + h) * T + row] * kLog2e
                          : 0.f;
      }
    }
    mbar_wait(&q_full, 0);
    if (c == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tr = r0 + 8 * r, row = q0 + tr;
        const int64_t at = ((int64_t)b * Hq + h) * T + row;
        if constexpr (kLo) {
          // the split pass's, from O and dO as they lie in device memory
          rowv[r] = row < T ? delta[at] : 0.f;
          continue;
        }
        // rowsum(O o dO): the quad of a row takes its 8-column chunks tg,
        // tg + 4, ... in order, then sums the four partials (butterfly),
        // as flash_bwd_dq_kernel does
        float sum = 0.f;
        if (row < T) {
          const In* o_row = o + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
          for (int i = 0; i < kD / 32; ++i) {
            const int ch = tg + 4 * i;  // 8 columns at 8 * ch
            if (8 * ch >= d_true) continue;
            const uint4 ov = *reinterpret_cast<const uint4*>(o_row + 8 * ch);
            // dO's chunk in the 128-byte-swizzled tile
            const uint4 dv = *reinterpret_cast<const uint4*>(
                do_s + (ch / 8) * kColBytes + tr * 128 +
                (((ch % 8) ^ (tr & 7)) << 4));
            const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
            const uint32_t* do2 = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 x = unpack2<In>(o2[e]);
              const float2 y = unpack2<In>(do2[e]);
              sum += x.x * y.x;  // exact in fp32
              sum += x.y * y.y;
            }
          }
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        rowv[r] = sum;
        if (tg == 0 && row < T) delta[at] = sum;
      }
    }

    // the A operand of this consumer's product, Q (S) or dO (dP), held in
    // registers for the block: slice ks (columns 16 ks .. 16 ks + 15) as
    // pack_a lays it out, read from the 128-byte-swizzled tile
    uint32_t af[kD / 16][4];
    {
      const uint8_t* tile = c ? do_s : q_s;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + 8 * (r & 1);
          const int col = 16 * ks + 8 * (r >> 1) + 2 * tg;
          af[ks][r] = *reinterpret_cast<const uint32_t*>(
              tile + (col / 64) * kColBytes + row * 128 +
              ((((col % 64) / 8) ^ (row & 7)) << 4) + (col % 8) * 2);
        }
      }
    }
    if constexpr (kStages > kOwn) {
      // Q and dO are read: their rows may take a K/V stage (a TMA write)
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&qdo_free);
    }

    float acc[kHalf / 2];  // dQ of this consumer's half
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) acc[i] = 0.f;
    float x[kKeys / 2];  // S (consumer 0) or dP (consumer 1) of a tile
    uint32_t dsa[kKeys / 16][4];  // dS, the A registers of dS K
    TRACE_START

    // tile j's S = Q K^T (consumer 0) or dP = dO V^T (consumer 1), 64 rows
    // x 64 keys over 256 columns, once its stage has arrived. Both
    // consumers issue the same products on their own operands.
    auto issue = [&](int j) {
      const int s = j % kStages;
      const uint32_t b_addr = smem_addr(stage_tile(s, c));
      mbar_wait(c ? &v_full[s] : &k_full[s], (j / kStages) & 1);
      TRACE(4)
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        const uint32_t at = (ks / 4) * kColBytes + (ks % 4) * 32;
        wgmma_rs_k64<Op>(x, af[ks], desc_sw128(b_addr + at, 16, 1024),
                         ks > 0);
      }
      if constexpr (kLo) {
        if (c == 1) {
          // fp32: dP also takes dO_lo V_hi^T + dO_hi V_lo^T
#pragma unroll
          for (int ks = 0; ks < kD / 16; ++ks) {
            const uint32_t at = (ks / 4) * kColBytes + (ks % 4) * 32;
            wgmma_ss<kKeys, Op>(x, desc_sw128(do_lo_addr + at, 16, 1024),
                                desc_sw128(b_addr + at, 16, 1024), 1);
            wgmma_rs_k64<Op>(x, af[ks],
                             desc_sw128(b_addr + kTileBytes + at, 16, 1024),
                             1);
          }
        }
      }
      wgmma_commit();
    };

    issue(0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const bool more = j + 1 < n_tiles;
      wgmma_wait<0>();  // this tile's S or dP
      fence_regs(x);
      if (c == 1 && lane == 0) mbar_arrive(&v_empty[s]);  // dP read V
      TRACE(0)

      // the hand-offs: P from consumer 0, dS from consumer 1
      if (c == 0) {
        // P; mask the ragged tail and the diagonal
        const int k0 = j * kKeys;
        const bool need_mask =
            k0 + kKeys > T || (causal && k0 + kKeys - 1 > q0);
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) {
          float p = exp2f(x[e] * scale_log2 - rowv[(e >> 1) & 1]);
          if (need_mask) {
            const int col = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
            const int row = row0 + ((e >> 1) & 1) * 8;
            if (col >= T || (causal && col > row)) p = 0.f;
          }
          ex_p[e * 128 + t] = p;
        }
        named_barrier_arrive(kBarP, 256);
      } else {
        named_barrier(kBarP, 256);  // consumer 0's P of this tile
        TRACE(2)
        // dS = P (dP - delta) scale, as A registers of the operand type
        // (not written over dP, the accumulator of the next tile's
        // product: writing it between a product's issue and its wait
        // makes ptxas serialise every wgmma, C7515)
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          float ds[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = 8 * kk + i;
            ds[i] = ex_p[e * 128 + t] * (x[e] - rowv[(e >> 1) & 1]) * scale;
          }
          pack_a<Op>(dsa[kk], ds, 0);
#pragma unroll
          for (int r = 0; r < 4; ++r) ex_ds[(4 * kk + r) * 128 + t] = dsa[kk][r];
        }
        named_barrier_arrive(kBarDs, 256);
      }
      TRACE(1)
      // 16-bit: the next tile's S or dP, its stage two tiles ahead, runs
      // under the rest of the hand-off and this tile's dS K
      if (kAhead && more) issue(j + 1);
      if (c == 0) {
        named_barrier(kBarDs, 256);  // consumer 1's dS of this tile
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) dsa[kk][r] = ex_ds[(4 * kk + r) * 128 + t];
        }
        TRACE(2)
      }

      // dQ[:, 128c ..] += dS K[:, 128c ..]: the stage's keys are the
      // contraction, K's column blocks 2c and 2c + 1 (consumer 1 meets K's
      // barrier here; consumer 0 passed it for S)
      const uint32_t k_addr = smem_addr(stage_tile(s, 0));
      mbar_wait(&k_full[s], (j / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs_cols<kHalf, Op>(
            acc, dsa[kk], k_addr + 2 * c * kColBytes + kk * 16 * 128,
            kColBytes);
      }
      wgmma_commit();
      TRACE(3)
      wgmma_wait<0>();  // dS K (16-bit: and the next tile's product)
      fence_regs(acc);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(&k_empty[s]);  // this warp is done with K
      // one stage: the next tile's K and V follow this tile's dS K
      if (!kAhead && more) issue(j + 1);
      TRACE(5)
    }

    // epilogue: this consumer's half of dQ in q's dtype, the true columns
    // of the real rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= T) continue;
      In* out = dq + b * dq_sb + h * dq_sh + (int64_t)row * dq_st;
#pragma unroll
      for (int jn = 0; jn < kHalf / 8; ++jn) {
        const int col = kHalf * c + 8 * jn + 2 * tg;
        if (col < d_true) {
          store2(out + col, acc[4 * jn + 2 * r], acc[4 * jn + 2 * r + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ dK/dV

namespace dkv {

constexpr int kKvRows = 64;   // kv rows of a block; both consumers own them
constexpr int kConsumerWarps = 8;
constexpr int kThreads = Split<2>::kThreads;  // producer + 2 consumers
constexpr int kLaunchRegs = Split<2>::kLaunchRegs;

// the slab kernels' register split: a producer that converts fp32 tiles
// keeps 40 (flash_bwd_dkv_kernel's producer is one TMA thread and the
// first warp's lanes for every type, Split<2>)
template <typename In>
using DkvSplit = Split<2, Elem<In>::kTma ? 24 : 40>;

// The consumers' division of the work: up to head_dim 128 each takes 64 of
// a stage's 128 q rows against every column (their partial sums meet at
// the end); at 256 each takes all 64 q rows of a stage against its own
// half of the columns.
template <int D, typename In>
struct Shape {
  static constexpr bool kSplitCols = D > 128;
  static constexpr int kQRows = kSplitCols ? 64 : 128;  // q rows a stage
  static constexpr int kAccCols = kSplitCols ? D / 2 : D;  // a consumer's
  // a stage: Q, dO (fp32: and what rounding dO left), then its rows of
  // lse (log2 domain) and delta, padded to 1024 bytes so the next
  // stage's tiles keep their alignment
  static constexpr int kTiles = Elem<In>::kTma ? 2 : 3;
  static constexpr int kStageBytes =
      kTiles * kQRows * D * 2 + cdiv(2 * kQRows * 4, 1024) * 1024;
};

}  // namespace dkv

// fp32: every tile arrives by TMA from the split pass's bf16 copies
// (flash_bwd_split_kernel), V's and dO's rests in tiles of their own
// (tm_v_lo, tm_do_lo); bf16 and fp16 tiles as they are
template <int D, int kStages, typename In, int kParts = 1>
__global__ void __launch_bounds__(dkv::kThreads, 1)
    flash_bwd_dkv_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         In* __restrict__ dk, In* __restrict__ dv,
                         float* __restrict__ part, int n_split, int T,
                         int Hq, int Hkv, int B, int rep, int d_true,
                         int64_t dk_sb, int64_t dk_st, int64_t dk_sh,
                         int64_t dv_sb, int64_t dv_st, int64_t dv_sh,
                         float scale, int causal,
                         __grid_constant__ const CUtensorMap tm_v_lo,
                         __grid_constant__ const CUtensorMap tm_do_lo) {
  using dkv::kConsumerWarps;
  using dkv::kKvRows;
  using sm90::desc_sw128;
  using sm90::mbar_arrive;
  using sm90::mbar_arrive_expect_tx;
  using sm90::mbar_wait;
  using sm90::smem_addr;
  using sm90::tma_load_4d;
  using S = Split<2>;
  using Op = typename Elem<In>::Op;
  // fp32: the rests of V and dO, a tile each beside V and dO
  constexpr bool kLo = !Elem<In>::kTma;
  using Sh = dkv::Shape<D, In>;
  constexpr bool kSplitCols = Sh::kSplitCols;
  constexpr int kQRows = Sh::kQRows;
  constexpr int kAccCols = Sh::kAccCols;
  constexpr int kColBlocks = D / 64;           // 64-column TMA boxes per row
  constexpr int kKvBytes = kKvRows * D * 2;    // K or V
  constexpr int kTileBytes = kQRows * D * 2;   // Q or dO of a stage
  constexpr int kStageBytes = Sh::kStageBytes;
  constexpr int kRowsAt = Sh::kTiles * kTileBytes;  // lse, delta of a stage
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* k_s = sm90::align_1024(smem_raw);
  uint8_t* v_s = k_s + kKvBytes;
  // fp32: what rounding V to bf16 left, after V
  uint8_t* ring = v_s + (kLo ? 2 : 1) * kKvBytes;

  // causal: kv tile 0 sees every q row, so low tiles are the longest;
  // heads inner, so the longest tiles of every head are scheduled first;
  // split (head_dim 256), a block a chunk of a tile's pairs, chunks
  // innermost
  const int heads = Hkv * B;
  const int kvtile = blockIdx.x / (kSplitCols ? heads * n_split : heads);
  const unsigned hb = kSplitCols ? blockIdx.x % (heads * n_split) / n_split
                                 : blockIdx.x % heads;
  const int chunk = kSplitCols ? blockIdx.x % n_split : 0;
  const int hk = hb % Hkv, b = hb / Hkv;
  const int k0 = kvtile * kKvRows;
  // the stages of one q head start at the diagonal when causal
  const int q_start = causal ? k0 : 0;
  const int n_qs = cdiv(T - q_start, kQRows);
  // (q head, stage) pairs, head-major: the tile's rep * n_qs, or split,
  // chunk `chunk` of n_split contiguous ones, [it0, it0 + n_iter)
  const int it0 = kSplitCols ? rep * n_qs * chunk / n_split : 0;
  const int n_iter =
      kSplitCols ? rep * n_qs * (chunk + 1) / n_split - it0 : rep * n_qs;

  if (threadIdx.x == 0) {
    // one expect_tx arrival (the TMA tiles' bytes) plus the 32 lanes that
    // write lse, delta
    sm90::mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    sm90::setmaxnreg_dec<S::kProducerRegs>();
    // the threads that fill the ring: warp 0 (lane 0 the TMA)
    constexpr int kFillThreads = 32;
    if (threadIdx.x < kFillThreads) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        // K and V (fp32: and V's rest)
        mbar_arrive_expect_tx(&kv_full, (kLo ? 3 : 2) * kKvBytes);
#pragma unroll
        for (int cb = 0; cb < kColBlocks; ++cb) {
          tma_load_4d(k_s + cb * kKvRows * 128, &tm_k, &kv_full, cb * 64, hk,
                      k0, b);
          tma_load_4d(v_s + cb * kKvRows * 128, &tm_v, &kv_full, cb * 64, hk,
                      k0, b);
          if constexpr (kLo) {
            tma_load_4d(v_s + kKvBytes + cb * kKvRows * 128, &tm_v_lo,
                        &kv_full, cb * 64, hk, k0, b);
          }
        }
      }
      for (int i = 0; i < n_iter; ++i) {
        const int it = it0 + i;
        const int h = hk * rep + it / n_qs;
        const int qs0 = q_start + (it % n_qs) * kQRows;
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* stage = ring + s * kStageBytes;
        if (lane == 0) {
          // Q and dO (fp32: and dO's rest)
          mbar_arrive_expect_tx(&full[s], Sh::kTiles * kTileBytes);
#pragma unroll
          for (int cb = 0; cb < kColBlocks; ++cb) {
            tma_load_4d(stage + cb * kQRows * 128, &tm_q, &full[s], cb * 64,
                        h, qs0, b);
            tma_load_4d(stage + kTileBytes + cb * kQRows * 128, &tm_do,
                        &full[s], cb * 64, h, qs0, b);
            if constexpr (kLo) {
              tma_load_4d(stage + 2 * kTileBytes + cb * kQRows * 128,
                          &tm_do_lo, &full[s], cb * 64, h, qs0, b);
            }
          }
        }
        float* lse_s = reinterpret_cast<float*>(stage + kRowsAt);
        const int64_t row = ((int64_t)b * Hq + h) * T;
        for (int i = lane; i < kQRows; i += kFillThreads) {
          const int t = qs0 + i;
          lse_s[i] = t < T ? lse[row + t] * kLog2e : 0.f;
          lse_s[kQRows + i] = t < T ? delta[row + t] : 0.f;
        }
        mbar_arrive(&full[s]);  // release: this lane's rows are visible
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    sm90::setmaxnreg_inc<S::kConsumerRegs>();
    const int c = wg - 1;
    // this consumer's q rows within a stage (64 cq .. 64 cq + 63) and
    // first column of dK and dV
    const int cq = kSplitCols ? 0 : c;
    const int col0 = kSplitCols ? c * kAccCols : 0;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int key0 = k0 + 16 * w + g;  // this thread's keys: key0, key0 + 8
    const float scale_log2 = scale * 1.4426950408889634f;
    const uint32_t k_addr = smem_addr(k_s), v_addr = smem_addr(v_s);

    float dk_acc[kAccCols / 2], dv_acc[kAccCols / 2];
#pragma unroll
    for (int i = 0; i < kAccCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(&kv_full, 0);
    for (int i = 0; i < n_iter; ++i) {
      const int jq = (it0 + i) % n_qs;
      const int wq0 = q_start + jq * kQRows + 64 * cq;  // this warpgroup's
      const int s = i % kStages;                        // first q row
      uint8_t* stage = ring + s * kStageBytes;
      const uint32_t q_addr = smem_addr(stage) + cq * 64 * 128;
      const uint32_t do_addr = q_addr + kTileBytes;
      const float* lse_s =
          reinterpret_cast<const float*>(stage + kRowsAt) + 64 * cq;
      const float* dlt_s = lse_s + kQRows;
      mbar_wait(&full[s], (i / kStages) & 1);

      if (wq0 < T) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
        float st[32], dpt[32];
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t col = (ks % 4) * 32;  // bytes into the column block
          const uint32_t a_off = (ks / 4) * kKvRows * 128 + col;
          const uint32_t b_off = (ks / 4) * kQRows * 128 + col;
          sm90::wgmma_ss<64, Op>(st, desc_sw128(k_addr + a_off, 16, 1024),
                                 desc_sw128(q_addr + b_off, 16, 1024), ks > 0);
          sm90::wgmma_ss<64, Op>(dpt, desc_sw128(v_addr + a_off, 16, 1024),
                                 desc_sw128(do_addr + b_off, 16, 1024),
                                 ks > 0);
          if constexpr (kLo) {
            // fp32: dP^T += V_hi dO_lo^T + V_lo dO_hi^T (the tiles' rests)
            sm90::wgmma_ss<64, Op>(
                dpt, desc_sw128(v_addr + a_off, 16, 1024),
                desc_sw128(do_addr + kTileBytes + b_off, 16, 1024), 1);
            sm90::wgmma_ss<64, Op>(
                dpt, desc_sw128(v_addr + kKvBytes + a_off, 16, 1024),
                desc_sw128(do_addr + b_off, 16, 1024), 1);
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);

        // P^T and dS^T; mask the ragged tail and, on the diagonal, the
        // queries before each key (keys past T are never stored)
        const bool need_mask =
            wq0 + 64 > T || (causal && jq == 0 && cq == 0);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qi = 8 * (e / 4) + 2 * tg + (e & 1);  // in the 64 rows
          float p = exp2f(st[e] * scale_log2 - lse_s[qi]);
          if (need_mask) {
            const int col = wq0 + qi;
            const int key = key0 + ((e >> 1) & 1) * 8;
            if (col >= T || (causal && col < key)) p = 0.f;
          }
          st[e] = p;
          dpt[e] = p * (dpt[e] - dlt_s[qi]) * scale;
        }
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::pack_a<Op>(pa[kk], st, kk);
          sm90::pack_a<Op>(dsa[kk], dpt, kk);
        }

        // dV += P^T dO and dK += dS^T Q over this consumer's columns: the
        // 64 queries are the contraction
        const uint32_t cols = (col0 / 64) * kQRows * 128;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t rows = kk * 16 * 128;
          sm90::wgmma_rs<kAccCols, Op>(
              dv_acc, pa[kk],
              desc_sw128(do_addr + cols + rows, kQRows * 128, 1024));
          sm90::wgmma_rs<kAccCols, Op>(
              dk_acc, dsa[kk],
              desc_sw128(q_addr + cols + rows, kQRows * 128, 1024));
        }
        if constexpr (kParts > 1) {
          // narrow head_dims: P^T and dS^T also as what rounding left
          uint32_t pa_lo[4][4], dsa_lo[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            sm90::pack_a_rest<Op>(pa_lo[kk], pa[kk], st, kk);
            sm90::pack_a_rest<Op>(dsa_lo[kk], dsa[kk], dpt, kk);
          }
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t rows = kk * 16 * 128;
            sm90::wgmma_rs<kAccCols, Op>(
                dv_acc, pa_lo[kk],
                desc_sw128(do_addr + cols + rows, kQRows * 128, 1024));
            sm90::wgmma_rs<kAccCols, Op>(
                dk_acc, dsa_lo[kk],
                desc_sw128(q_addr + cols + rows, kQRows * 128, 1024));
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
      }
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
    }

    // the stores of this consumer's columns of the key rows it holds;
    // red(i) adds the other consumer's partial sum of accumulator entry i
    auto store = [&](auto red) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= T) continue;
        In* dk_row = dk + b * dk_sb + hk * dk_sh + key * dk_st;
        In* dv_row = dv + b * dv_sb + hk * dv_sh + key * dv_st;
#pragma unroll
        for (int jn = 0; jn < kAccCols / 8; ++jn) {
          const int col = col0 + 8 * jn + 2 * tg;
          if (col >= d_true) continue;
          const int i0 = 4 * jn + 2 * r, i1 = i0 + 1;
          sm90::store2(dk_row + col, dk_acc[i0] + red(i0),
                       dk_acc[i1] + red(i1));
          sm90::store2(dv_row + col, dv_acc[i0] + red(kAccCols / 2 + i0),
                       dv_acc[i1] + red(kAccCols / 2 + i1));
        }
      }
    };
    if constexpr (kSplitCols) {
      if (n_split == 1) {
        store([](int) { return 0.f; });  // the columns are this consumer's
      } else {
        // this chunk's fp32 partial sums, for flash_bwd_dkv_reduce_kernel:
        // part [2 (dK, dV), n_split, B, T, Hkv, D]
        const int64_t plane = (int64_t)n_split * B * T * Hkv * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = key0 + 8 * r;
          if (key >= T) continue;
          float* dk_row =
              part + ((((int64_t)chunk * B + b) * T + key) * Hkv + hk) * D;
#pragma unroll
          for (int jn = 0; jn < kAccCols / 8; ++jn) {
            const int col = col0 + 8 * jn + 2 * tg;
            if (col >= d_true) continue;
            const int i0 = 4 * jn + 2 * r;
            sm90::store2(dk_row + col, dk_acc[i0], dk_acc[i0 + 1]);
            sm90::store2(dk_row + plane + col, dv_acc[i0], dv_acc[i0 + 1]);
          }
        }
      }
    } else {
      // the two consumers' partial sums meet in shared memory (K, V and
      // the ring are idle now): the second writes, the first adds in a
      // fixed order
      float* red = reinterpret_cast<float*>(k_s);
      sm90::fence_proxy_async();
      sm90::named_barrier(1, 256);
      if (c == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          red[i * 128 + t] = dk_acc[i];
          red[(D / 2 + i) * 128 + t] = dv_acc[i];
        }
      }
      sm90::named_barrier(1, 256);
      if (c == 0) store([&](int i) { return red[i * 128 + t]; });
    }
  }
}

// The split's second pass (head_dim 256): dK and dV from the chunks' fp32
// partial sums, added in chunk order (chunk 0, then 1, ...) whatever order
// the chunks ended in, so the result is bitwise repeatable; no atomics.
// A warp a (dK or dV, b, key, kv head) row, 8 rows a block. Bound by
// bytes: n_split fp32 rows read, one row written in the input type.
constexpr int kReduceRows = 8;  // rows a block, a warp each

template <typename In>
__global__ void __launch_bounds__(32 * kReduceRows)
    flash_bwd_dkv_reduce_kernel(const float* __restrict__ part,
                                In* __restrict__ dk, In* __restrict__ dv,
                                int n_split, int T, int Hkv, int B,
                                int d_true, int64_t dk_sb, int64_t dk_st,
                                int64_t dk_sh, int64_t dv_sb, int64_t dv_st,
                                int64_t dv_sh) {
  constexpr int kD = 256;  // the partials' row width
  const int lane = threadIdx.x % 32;
  const int64_t rows = (int64_t)B * T * Hkv;  // a plane's rows, a chunk's
  const int64_t at = (int64_t)blockIdx.x * kReduceRows + threadIdx.x / 32;
  if (at >= 2 * rows) return;
  const int which = at / rows;  // 0: dK, 1: dV
  const int64_t row = at % rows;
  const int hk = row % Hkv, t = (row / Hkv) % T, b = row / ((int64_t)Hkv * T);
  const float* src = part + ((int64_t)which * n_split * rows + row) * kD;
  In* out = which ? dv + b * dv_sb + t * dv_st + hk * dv_sh
                  : dk + b * dk_sb + t * dk_st + hk * dk_sh;
  for (int col = 2 * lane; col < d_true; col += 64) {
    float2 sum = *reinterpret_cast<const float2*>(src + col);
    for (int c = 1; c < n_split; ++c) {
      const float2 x =
          *reinterpret_cast<const float2*>(src + c * rows * kD + col);
      sum.x += x.x;
      sum.y += x.y;
    }
    sm90::store2(out + col, sum.x, sum.y);
  }
}

// The dQ kernel head_dim D runs on, with its launch shape: its register
// split, q rows a block, keys a K/V stage and shared memory
template <int D, typename In, int kParts>
struct DqKernel {
  using S = dqk::DqSplit<D, In>;
  static constexpr int kRows = 64 * dqk::Shape<D>::kConsumers;
  static constexpr int kKeys = dqk::Shape<D>::kBlockN;
  // Q and dO, and a stage's K and V; fp32 has dO's and V's rests too;
  // + 1024: the tiles' 1024-byte alignment
  static constexpr int kTiles = Elem<In>::kTma ? 2 : 3;
  static constexpr int kSmem = kTiles * kRows * D * 2 +
                               dqk::stages<D, In>() * kTiles * kKeys * D * 2 +
                               1024;
  static constexpr auto kernel = flash_bwd_dq_kernel<D, In, kParts>;
};
template <typename In, int kParts>
struct DqKernel<256, In, kParts> {
  static_assert(kParts == 1, "the narrow head_dims run at 64");
  using S = dq256::DqSplit;
  static constexpr int kRows = dq256::kRows;
  static constexpr int kKeys = dq256::kKeys;
  static constexpr int kSmem = dq256::smem<In>();
  static constexpr auto kernel = flash_bwd_dq256_kernel<In>;
};

template <int D, typename In>
int dq_config(int* out) {
  using K = DqKernel<D, In, 1>;
  static_assert(K::kSmem <= 232448, "a block may use 227 KB of shared memory");
  out[0] = K::kSmem;
  out[1] = K::S::kThreads;
  out[2] = K::S::kLaunchRegs;
  out[3] = K::kRows;
  return 0;
}

// bf16 and fp16 inputs as they are; fp32 inputs as the split pass's bf16
// copies (launch_dq_split below)
template <int D, typename In, int kParts = 1>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq, int B,
              int T, int Hq, int Hkv, int d_true, const long long* s,
              float scale, int causal, cudaStream_t stream) {
  static_assert(Elem<In>::kTma, "fp32 dQ runs on the split pass's copies");
  using K = DqKernel<D, In, kParts>;
  using S = typename K::S;
  constexpr int kBlockM = K::kRows;
  constexpr int kBlockN = K::kKeys;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const CUtensorMap none = {};  // the rests' maps: fp32 only
  constexpr CUtensorMapDataType kType = Elem<In>::kMapType;
  int err = encode_rows(&tm_q, q, B, T, Hq, d_true, s[0], s[1], s[2],
                        kBlockM, kType);
  if (!err) err = encode_rows(&tm_k, k, B, T, Hkv, d_true, s[3], s[4], s[5],
                              kBlockN, kType);
  if (!err) err = encode_rows(&tm_v, v, B, T, Hkv, d_true, s[6], s[7], s[8],
                              kBlockN, kType);
  if (!err) err = encode_rows(&tm_do, dout, B, T, Hq, d_true, s[12], s[13],
                              s[14], kBlockM, kType);
  constexpr int kSmem = K::kSmem;
  auto kernel = K::kernel;
  if (!err) err = prepare_launch(kernel, kSmem, S::kLaunchRegs);
  if (err) return err;
  const int grid = cdiv(T, kBlockM) * Hq * B;
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const In*>(o),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<In*>(dq), T, Hq, B, Hq / Hkv, d_true, s[9], s[10], s[11],
      s[15], s[16], s[17], scale, causal, none, none);
  return static_cast<int>(cudaGetLastError());
}

// fp32 dQ from the split pass's copies: q_hi, k_hi, v_hi, v_lo, do_hi and
// do_lo bf16 [B, T, H, w8] contiguous (w8: the width rounded up to 8
// columns, the rest zeros), delta as that pass wrote it; dq fp32 at its
// element strides s[0 .. 2], its true columns d_true
template <int D, int kParts = 1>
int launch_dq_split(const void* const* hi_lo, const void* lse,
                    const void* delta, void* dq, int B, int T, int Hq,
                    int Hkv, int d_true, int w8, const long long* s,
                    float scale, int causal, cudaStream_t stream) {
  using K = DqKernel<D, float, kParts>;
  using S = typename K::S;
  constexpr int kBlockM = K::kRows;
  constexpr int kBlockN = K::kKeys;
  // q_hi, k_hi, v_hi, v_lo, do_hi, do_lo
  CUtensorMap maps[6];
  int err = 0;
  for (int i = 0; i < 6 && !err; ++i) {
    const bool q_sized = i == 0 || i >= 4;
    err = encode_copy(&maps[i], hi_lo[i], B, T, q_sized ? Hq : Hkv, w8,
                      q_sized ? kBlockM : kBlockN);
  }
  constexpr int kSmem = K::kSmem;
  auto kernel = K::kernel;
  if (!err) err = prepare_launch(kernel, kSmem, S::kLaunchRegs);
  if (err) return err;
  const int grid = cdiv(T, kBlockM) * Hq * B;
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[4], nullptr,
      static_cast<const float*>(lse),
      const_cast<float*>(static_cast<const float*>(delta)),
      static_cast<float*>(dq), T, Hq, B, Hq / Hkv, d_true, 0, 0, 0, s[0],
      s[1], s[2], scale, causal, maps[3], maps[5]);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kStages, typename In>
constexpr int dkv_smem_bytes() {  // + 1024: the tiles' 1024-byte alignment
  // K and V (fp32: and V's rest), then the ring
  return (Elem<In>::kTma ? 2 : 3) * dkv::kKvRows * D * 2 +
         kStages * dkv::Shape<D, In>::kStageBytes + 1024;
}

template <int D, int kStages, typename In>
int dkv_config(int* out) {
  static_assert(dkv_smem_bytes<D, kStages, In>() <= 232448,
                "a block may use 227 KB of shared memory");
  // the two consumers' partial sums meet over K, V and the ring
  static_assert(dkv::Shape<D, In>::kSplitCols ||
                    D * 1024 <= dkv_smem_bytes<D, kStages, In>() - 1024,
                "no room for the consumers' partial sums");
  out[0] = dkv_smem_bytes<D, kStages, In>();
  out[1] = dkv::kThreads;
  out[2] = dkv::kLaunchRegs;
  out[3] = dkv::kKvRows;
  return 0;
}

// in: q, k, v, dO at their element strides s[0 .. 11] (bf16, fp16), or,
// given w8 > 0, the split pass's bf16 copies q_hi, k_hi, v_hi, v_lo,
// do_hi, do_lo [B, T, H, w8] (fp32); dk and dv at their strides s[12 ..
// 17]
template <int D, int kStages, typename In, int kParts = 1>
int launch_dkv(const void* const* in, int w8, const void* lse,
               const void* delta, void* dk, void* dv, void* part,
               int n_split, int B, int T, int Hq, int Hkv, int d_true,
               const long long* s, float scale, int causal,
               cudaStream_t stream) {
  using dkv::kKvRows;
  constexpr int kQRows = dkv::Shape<D, In>::kQRows;
  if (Elem<In>::kTma == (w8 > 0)) {  // fp32 runs on copies, only fp32
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm[6] = {};  // q, k, v, dO (fp32: then V's and dO's rests)
  // where each map's copy is in `in` (q, k, v, v_lo, dO, dO_lo)
  constexpr int kCopyAt[6] = {0, 1, 2, 4, 3, 5};
  int err = 0;
  for (int i = 0; i < (w8 > 0 ? 6 : 4) && !err; ++i) {
    const int at = w8 > 0 ? kCopyAt[i] : i;
    const bool q_sized = i == 0 || i == 3 || i == 5;
    const int H = q_sized ? Hq : Hkv, rows = q_sized ? kQRows : kKvRows;
    err = w8 > 0 ? encode_copy(&tm[i], in[at], B, T, H, w8, rows)
                 : encode_rows(&tm[i], in[i], B, T, H, d_true, s[3 * i],
                               s[3 * i + 1], s[3 * i + 2], rows,
                               Elem<In>::kMapType);
  }
  constexpr int kSmem = dkv_smem_bytes<D, kStages, In>();
  auto kernel = flash_bwd_dkv_kernel<D, kStages, In, kParts>;
  if (!err) err = sm90::prepare_launch(kernel, kSmem, dkv::kLaunchRegs);
  if (err) return err;
  // split: n_split blocks a (kv tile, kv head, batch)
  const int grid = cdiv(T, kKvRows) * Hkv * B * n_split;
  kernel<<<grid, dkv::kThreads, kSmem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<In*>(dk),
      static_cast<In*>(dv), static_cast<float*>(part), n_split, T, Hq, Hkv,
      B, Hq / Hkv, d_true, s[12], s[13], s[14], s[15], s[16], s[17], scale,
      causal, tm[4], tm[5]);
  err = static_cast<int>(cudaGetLastError());
  if (err || n_split == 1) return err;
  const int64_t rows = 2 * (int64_t)B * T * Hkv;
  flash_bwd_dkv_reduce_kernel<In>
      <<<(int)((rows + kReduceRows - 1) / kReduceRows), 32 * kReduceRows, 0,
         stream>>>(static_cast<const float*>(part), static_cast<In*>(dk),
                   static_cast<In*>(dv), n_split, T, Hkv, B, d_true, s[12],
                   s[13], s[14], s[15], s[16], s[17]);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- head_dim above 256
//
// Past 256 columns no whole-head_dim tile fits (a 64-row fp32 accumulator
// of D columns is D / 2 registers a thread; the tiles outgrow the 227 KB),
// so each consumer warpgroup owns a 256-column slab of the output (a
// 64 x 256 fp32 accumulator, 128 registers). S = Q K^T and dP = dO V^T
// contract over every column; the two consumers of a block split them by
// product, not by columns, so that each is computed once a block (a
// block a slab that computed both itself, in dK/dV in both of its
// consumers, would issue 2.14x the backward's products at head_dim 512).
// The
// probabilities pass between the consumers through shared memory in fp32,
// in the accumulator's fragment order (thread t's element e at float
// e * 128 + t, or float4 q * 128 + t for elements 4q .. 4q + 3), so the
// thread of the other warpgroup with the same index reads exactly its own
// elements, without bank conflicts, under named barriers.
//
// What bounds them on an H100: L2. A block streaming every 64-column
// slice of its operands reads 256-320 KB from L2 at each (row tile, row
// tile) step at head_dim 512, against 12-16 MFLOP of products: a block a
// slab read about 6 TB/s from L2 at "d512 train" (PERF.md), where the
// products take a fifth of the time. So the designs below cut what a
// step reads as well as what it computes:
// - dQ (flash_bwd_dq_wide_kernel): a (64-row q tile, q head, batch, pair)
//   block owns two slabs, 512 output columns (a D of 264-512 is one
//   pair; past 512 a row takes cdiv(D, 512) blocks, which compute S and
//   dP again). Consumer 0 sums S over 64-column slices and takes P;
//   consumer 1 sums dP, takes delta = rowsum(O o dO) over every column
//   (once a block; the first pair's blocks write it), reads P, forms dS
//   = P (dP - delta) scale and writes it back, rounded to the operand
//   type, over the P it read; then both run dQ += dS K over their own
//   slab. K of the whole key tile stays in shared memory for the tile
//   (two stages; fp32 one), the B operand of S's slices inside the pair
//   and of both dS K products, so K is read once a tile; a ring slot holds
//   a slice's Q, dO and V (fp32: the rests of dO and V), and K where the
//   slice lies outside the pair (D > 512). A consumer keeps one wgmma
//   group in flight behind the one it issues and frees a slot when the
//   group that read it completes; K's stage is freed once the first slice
//   of the next tile has retired dS K. 256 KB of L2 a step at D 512,
//   against 576 KB for two blocks of a slab each.
// - dK/dV (flash_bwd_dkv_cluster_kernel): a thread-block cluster of
//   n_slabs blocks per (64-row kv tile, kv head, batch), a block a slab
//   (slabs innermost on the grid, so a cluster's blocks are neighbours).
//   A block keeps its slab's columns of K and V, and a step (q head of
//   the group, 64 q rows) brings only the slab's columns of Q and dO: its
//   consumer 0 sums the block's partial S^T = K Q^T over the slab's
//   columns, consumer 1 the partial dP^T = V dO^T. Each sends its partial
//   to every peer with st.async (bytes counted on the peer's mbarrier, as
//   TMA's are: no fence), and every block sums the cluster's partials in
//   rank order (its own from registers), so every block holds the same
//   bits of S^T and dP^T. Consumer 0 takes P^T, hands it to consumer 1
//   over its consumed receive slot and runs dV += P^T dO over the slab;
//   consumer 1 forms dS^T and runs dK += dS^T Q over the slab. Each
//   product is computed once per (kv tile, step) across the cluster, and
//   a block reads 64 KB of L2 a step, against 320 KB streaming slices. A
//   receiver frees its slots with a remote arrival on the sender's
//   barrier; no block exits before every peer has freed its last partial.
//   The receive slots take (n_slabs - 1) x 32 KB, so clusters are of at
//   most four blocks (fp32, whose tiles keep their rests, two);
// - dK/dV past that (flash_bwd_dkv_wide_kernel: D > 1024, fp32 D > 512):
//   a (64-row kv tile, kv head, batch, slab) block on its own, consumer 0
//   summing S^T over a ring of 64-column slices of K, V, Q and dO and
//   running dV += P^T dO, consumer 1 summing dP^T, reading P^T (two
//   buffers, so consumer 0 runs a step ahead) and running dK += dS^T Q;
//   the slab's dO (with lse) and Q (with delta) come through two rings,
//   one a consumer. S and dP are computed once a slab;
// - the GQA group-sum stays in the accumulators: no atomics, and every sum
//   is taken in a fixed order, so results are bitwise repeatable;
// - a tile's column blocks past the tensor's columns are zeros (TMA fills
//   a box outside the tensor with zeros; fp32 converts zeros) or keep what
//   shared memory held, which reaches only output columns past the
//   tensor's, never stored.
namespace wide {

constexpr int kSlab = 256;                 // output columns a consumer owns
constexpr int kTile = 64 * 128;            // 64 rows of 64 16-bit columns
constexpr int kSlabTile = 64 * kSlab * 2;  // 64 rows of a slab's columns
constexpr int kPair = 2 * kSlab;           // dQ: output columns a block owns
constexpr int kPairTile = 2 * kSlabTile;   // 64 rows of a pair's columns
// a 64 x 64 fp32 tile in the accumulator's fragment order (P, dS)
constexpr int kExFloats = 32 * 128;
constexpr int kExBytes = 4 * kExFloats;

// named barriers of the exchange (0 is __syncthreads): dQ's P and dS
// hand-offs; dK/dV's two P buffers, full and free
constexpr int kBarP = 1, kBarDs = 2;
constexpr int kBarPFull = 1, kBarPFree = 3;
// the cluster dK/dV kernel: each consumer's threads meet before its one
// thread's remote arrivals (ids 5 and 6)
constexpr int kBarConsumer = 5;

// dQ: K stages of a pair's columns (fp32 rings hold the rests of dO and
// V, so one), and the bytes of the slice ring after them
template <typename In>
__host__ __device__ constexpr int dq_k_stages() {
  return Elem<In>::kTma ? 2 : 1;
}
template <typename In>
__host__ __device__ constexpr int dq_ring_bytes() {
  return Elem<In>::kTma ? 80 * 1024 : 144 * 1024;
}
constexpr int kDqMaxSlots = 4;
// a dQ slot's tiles: Q, dO, V (fp32: and the rests of dO and V), then K
// where the slice lies outside the block's pair
template <typename In>
__host__ __device__ constexpr int dq_slot_tiles() {
  return Elem<In>::kTma ? 3 : 5;
}
template <typename In>
__host__ __device__ constexpr int dq_smem() {
  return dq_k_stages<In>() * kPairTile + kExBytes + dq_ring_bytes<In>() +
         1024;
}
template <typename In>
using DqSplit = Split<2, Elem<In>::kTma ? 24 : 40>;

// dK/dV: a slice slot holds K, V, Q, dO (fp32: and the rests of V, dO)
template <typename In>
__host__ __device__ constexpr int slice_bytes() {
  return (Elem<In>::kTma ? 4 : 6) * kTile;
}
constexpr int kDkvSliceStages = 2;
// stages of each slab ring (dO's with lse, Q's with delta)
template <typename In>
__host__ __device__ constexpr int dkv_slab_stages() {
  return Elem<In>::kTma ? 2 : 1;
}
template <typename In>
__host__ __device__ constexpr int dkv_smem() {
  // slices, the two slab rings, two P buffers, the rows of lse and
  // delta (1024 bytes), the tiles' 1024-byte alignment
  return kDkvSliceStages * slice_bytes<In>() +
         2 * dkv_slab_stages<In>() * kSlabTile + 2 * kExBytes + 1024 + 1024;
}

// dK/dV in a cluster of n_slabs blocks, one a slab: the slab's K and V
// (fp32: and V's rest) stay; a stage holds the slab's Q and dO (fp32: and
// dO's rest) of a step; each peer's partial S^T and dP^T land in receive
// slots of their own. Two stages at two slabs, one at three or four
// (their receive slots take the room); past four slabs (fp32: two) the
// slots do not fit and the slab kernel above runs instead.
template <typename In>
__host__ __device__ constexpr int dkc_max_slabs() {
  return Elem<In>::kTma ? 4 : 2;
}
template <typename In>
__host__ __device__ constexpr int dkc_stages(int n_slabs) {
  return Elem<In>::kTma && n_slabs == 2 ? 2 : 1;
}
template <typename In>
__host__ __device__ constexpr int dkc_kv_tiles() {
  return Elem<In>::kTma ? 2 : 3;
}
template <typename In>
__host__ __device__ constexpr int dkc_stage_tiles() {
  return Elem<In>::kTma ? 2 : 3;
}
template <typename In>
__host__ __device__ constexpr int dkc_smem_for(int n_slabs) {
  // K, V, the stages, two receive slots a peer, the rows (1024 bytes),
  // alignment
  return (dkc_kv_tiles<In>() + dkc_stages<In>(n_slabs) * dkc_stage_tiles<In>()) *
             kSlabTile +
         2 * (n_slabs - 1) * kExBytes + 1024 + 1024;
}
template <typename In>
__host__ __device__ constexpr int dkc_smem() {  // the most of any cluster
  return dkc_smem_for<In>(2) > dkc_smem_for<In>(dkc_max_slabs<In>())
             ? dkc_smem_for<In>(2)
             : dkc_smem_for<In>(dkc_max_slabs<In>());
}

}  // namespace wide

template <typename In>
__global__ void __launch_bounds__(wide::DqSplit<In>::kThreads, 1)
    flash_bwd_dq_wide_kernel(__grid_constant__ const CUtensorMap tm_q,
                             __grid_constant__ const CUtensorMap tm_k,
                             __grid_constant__ const CUtensorMap tm_v,
                             __grid_constant__ const CUtensorMap tm_do,
                             const Src src, const In* __restrict__ o,
                             const In* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ delta, In* __restrict__ dq,
                             int T, int Hq, int B, int rep, int d_true,
                             int64_t o_sb, int64_t o_st, int64_t o_sh,
                             int64_t do_sb, int64_t do_st, int64_t do_sh,
                             int64_t dq_sb, int64_t dq_st, int64_t dq_sh,
                             float scale, int causal) {
  using namespace wide;
  using S = DqSplit<In>;
  using Op = typename Elem<In>::Op;
  constexpr bool kTma = Elem<In>::kTma;
  constexpr int kKStages = dq_k_stages<In>();
  // with two K stages a consumer frees tile j's K once dQ += dS K of tile
  // j has completed behind the first slice of tile j + 1; with one, the
  // producer needs it back before tile j + 1 starts
  constexpr bool kDeferK = kKStages > 1;
  constexpr int kBaseTiles = dq_slot_tiles<In>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t sl_full[kDqMaxSlots],
      sl_empty[kDqMaxSlots], k_full[kKStages], k_empty[kKStages];
  uint8_t* k_s = align_1024(smem_raw);  // kKStages x a pair's K columns
  float* ex = reinterpret_cast<float*>(k_s + kKStages * kPairTile);
  uint8_t* ring = reinterpret_cast<uint8_t*>(ex) + kExBytes;

  const int n_cb = cdiv(d_true, 64);  // 64-column slices of a row
  const int n_pairs = cdiv(d_true, kPair);
  const int heads = Hq * B;
  const int n_qtiles = cdiv(T, 64);
  // pairs innermost, then heads: longest tiles first
  const int pair = blockIdx.x % n_pairs, tile = blockIdx.x / n_pairs;
  const int rank = tile / heads;
  const int qtile = causal ? n_qtiles - 1 - rank : rank;
  const int h = (tile % heads) % Hq, b = (tile % heads) / Hq;
  const int q0 = qtile * 64, c0 = pair * kPair, cb0 = c0 / 64;
  const int n_kcb = min(kPair / 64, n_cb - cb0);  // the pair's K boxes
  const int n_tiles = cdiv(causal ? min(q0 + 64, T) : T, 64);
  // slices outside the pair bring their own K (D > 512 only)
  const int slot_bytes = (kBaseTiles + (n_cb > kPair / 64)) * kTile;
  const int n_slots = min(kDqMaxSlots, dq_ring_bytes<In>() / slot_bytes);

  if (threadIdx.x == 0) {
    constexpr int kFillers = kTma ? 1 : 128;
    for (int s = 0; s < n_slots; ++s) {
      mbar_init(&sl_full[s], kFillers);
      mbar_init(&sl_empty[s], 8);  // both consumers' warps
    }
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&k_full[s], kFillers);
      mbar_init(&k_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<S::kProducerRegs>();
    const int hk = h / rep;
    // per key tile: the pair's columns of K (a stage freed two tiles
    // earlier), then every slice of Q, dO and V, with K outside the pair
    if constexpr (!kTma) {
      const int tid = threadIdx.x;
      const float* q_rows = head_rows(src.ptr[0], src.stride[0], b, h);
      const float* k_rows = head_rows(src.ptr[1], src.stride[1], b, hk);
      const float* v_rows = head_rows(src.ptr[2], src.stride[2], b, hk);
      const float* do_rows = head_rows(src.ptr[3], src.stride[3], b, h);
      int slot = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int ks = j % kKStages;
        mbar_wait(&k_empty[ks], ((j / kKStages) & 1) ^ 1);
        convert_rows<64, kPair>(k_s + ks * kPairTile, k_rows + c0,
                                src.stride[1][1], 64 * j, T, d_true - c0,
                                tid);
        fence_proxy_async();
        mbar_arrive(&k_full[ks]);
        for (int cb = 0; cb < n_cb; ++cb) {
          mbar_wait(&sl_empty[slot], phase ^ 1);
          uint8_t* st = ring + slot * slot_bytes;
          const int left = d_true - 64 * cb;
          convert_rows<64, 64>(st, q_rows + 64 * cb, src.stride[0][1], q0, T,
                               left, tid);
          convert_rows<64, 64>(st + kTile, do_rows + 64 * cb,
                               src.stride[3][1], q0, T, left, tid,
                               st + 3 * kTile);
          convert_rows<64, 64>(st + 2 * kTile, v_rows + 64 * cb,
                               src.stride[2][1], 64 * j, T, left, tid,
                               st + 4 * kTile);
          if (cb < cb0 || cb >= cb0 + n_kcb) {
            convert_rows<64, 64>(st + kBaseTiles * kTile, k_rows + 64 * cb,
                                 src.stride[1][1], 64 * j, T, left, tid);
          }
          fence_proxy_async();
          mbar_arrive(&sl_full[slot]);
          if (++slot == n_slots) slot = 0, phase ^= 1;
        }
      }
    } else if (threadIdx.x == 0) {
      int slot = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int ks = j % kKStages;
        mbar_wait(&k_empty[ks], ((j / kKStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[ks], n_kcb * kTile);
        for (int cb = 0; cb < n_kcb; ++cb) {
          tma_load_4d(k_s + ks * kPairTile + cb * kTile, &tm_k, &k_full[ks],
                      c0 + 64 * cb, hk, 64 * j, b);
        }
        for (int cb = 0; cb < n_cb; ++cb) {
          const bool outer = cb < cb0 || cb >= cb0 + n_kcb;
          mbar_wait(&sl_empty[slot], phase ^ 1);
          mbar_arrive_expect_tx(&sl_full[slot], (outer ? 4 : 3) * kTile);
          uint8_t* st = ring + slot * slot_bytes;
          tma_load_4d(st, &tm_q, &sl_full[slot], 64 * cb, h, q0, b);
          tma_load_4d(st + kTile, &tm_do, &sl_full[slot], 64 * cb, h, q0, b);
          tma_load_4d(st + 2 * kTile, &tm_v, &sl_full[slot], 64 * cb, hk,
                      64 * j, b);
          if (outer) {
            tma_load_4d(st + kBaseTiles * kTile, &tm_k, &sl_full[slot],
                        64 * cb, hk, 64 * j, b);
          }
          if (++slot == n_slots) slot = 0, phase ^= 1;
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<S::kConsumerRegs>();
    // 0: S and P; 1: dP, delta and dS. Consumer c owns output columns
    // c0 + 256 c .. c0 + 256 c + 255.
    const int c = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, +8
    const int col0 = c0 + kSlab * c;
    const bool has_cols = col0 < d_true;
    const float scale_log2 = scale * kLog2e;
    uint32_t* exu = reinterpret_cast<uint32_t*>(ex);

    // consumer 0: lse in the log2 domain; consumer 1: delta =
    // rowsum(O o dO) over every column, the quad of a row taking its
    // 8-column chunks tg, tg + 4, ... in order, then summing the four
    // partials (every lane, every pair, the same bits)
    float rowv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (c == 0) {
        rowv[r] =
            row < T ? lse[((int64_t)b * Hq + h) * T + row] * kLog2e : 0.f;
        continue;
      }
      float sum = 0.f;
      if (row < T) {
        const In* o_row = o + b * o_sb + h * o_sh + row * o_st;
        const In* do_row = dout + b * do_sb + h * do_sh + row * do_st;
        for (int ch = tg; 8 * ch < d_true; ch += 4) {
          if constexpr (!kTma) {
            // fp32: a chunk the row's end cuts is read element by element
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int col = 8 * ch + e;
              if (col < d_true) sum += o_row[col] * do_row[col];
            }
          } else {
            const uint4 ov = *reinterpret_cast<const uint4*>(o_row + 8 * ch);
            const uint4 dv = *reinterpret_cast<const uint4*>(do_row + 8 * ch);
            const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
            const uint32_t* do2 = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 a = unpack2<In>(o2[e]);
              const float2 d = unpack2<In>(do2[e]);
              sum += a.x * d.x;  // 16-bit x 16-bit is exact in fp32
              sum += a.y * d.y;
            }
          }
        }
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      rowv[r] = sum;
      if (pair == 0 && tg == 0 && row < T) {
        delta[((int64_t)b * Hq + h) * T + row] = sum;
      }
    }

    float acc[kSlab / 2];
#pragma unroll
    for (int i = 0; i < kSlab / 2; ++i) acc[i] = 0.f;

    // the A registers of dQ += dS K, kept until the product completes
    uint32_t dsa[4][4];
    int slot = 0, phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int ks = j % kKStages;
      const uint32_t kpar = (j / kKStages) & 1;
      const uint32_t k_addr = smem_addr(k_s) + ks * kPairTile;
      // S reads the pair's K (and so does dQ += dS K of either consumer)
      mbar_wait(&k_full[ks], kpar);
      // consumer 0: S = Q K^T; consumer 1: dP = dO V^T; 64 rows x 64
      // keys, over the slices. Both issue the same products on their own
      // operands (a product in a branch of one consumer's would make
      // ptxas serialise every wgmma, C7520).
      float x[32];
      int prev = -1;  // the slot the group before the last one read
      for (int cb = 0; cb < n_cb; ++cb) {
        mbar_wait(&sl_full[slot], phase);
        const uint32_t base = smem_addr(ring) + slot * slot_bytes;
        const bool outer = cb < cb0 || cb >= cb0 + n_kcb;
        const uint32_t a_t = base + c * kTile;  // Q or dO
        const uint32_t b_t = c ? base + 2 * kTile  // V
                             : outer ? base + kBaseTiles * kTile
                                     : k_addr + (cb - cb0) * kTile;  // K
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          wgmma_ss<64, Op>(x, desc_sw128(a_t + 32 * kq, 16, 1024),
                           desc_sw128(b_t + 32 * kq, 16, 1024),
                           cb > 0 || kq > 0);
        }
        if constexpr (!kTma) {
          if (c == 1) {
            // fp32: dP += dO_lo V_hi^T + dO_hi V_lo^T (the tiles' rests)
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
              wgmma_ss<64, Op>(x, desc_sw128(base + 3 * kTile + 32 * kq, 16,
                                             1024),
                               desc_sw128(b_t + 32 * kq, 16, 1024), 1);
              wgmma_ss<64, Op>(x, desc_sw128(a_t + 32 * kq, 16, 1024),
                               desc_sw128(base + 4 * kTile + 32 * kq, 16,
                                          1024),
                               1);
            }
          }
        }
        wgmma_commit();
        // the group before this one has completed: free what it read
        wgmma_wait<1>();
        if (cb == 0) fence_regs(dsa);
        if (lane == 0) {
          if (prev >= 0) {
            mbar_arrive(&sl_empty[prev]);
          } else if (kDeferK && j > 0) {
            mbar_arrive(&k_empty[(j - 1) % kKStages]);  // dQ of tile j - 1
          }
        }
        prev = slot;
        if (++slot == n_slots) slot = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(x);
      if (lane == 0) mbar_arrive(&sl_empty[prev]);

      // the exchange: P from consumer 0, dS back from consumer 1, each
      // thread's elements at float (or 16-bit pair) e * 128 + t
      if (c == 0) {
        // P; mask the ragged tail and the diagonal
        const int k0 = 64 * j;
        const bool need_mask = k0 + 64 > T || (causal && k0 + 63 > q0);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          float p = exp2f(x[e] * scale_log2 - rowv[(e >> 1) & 1]);
          if (need_mask) {
            const int col = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
            const int row = row0 + ((e >> 1) & 1) * 8;
            if (col >= T || (causal && col > row)) p = 0.f;
          }
          ex[e * 128 + t] = p;
        }
        named_barrier_arrive(kBarP, 256);
        named_barrier(kBarDs, 256);  // dS of this tile is in ex
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) dsa[kk][r] = exu[(4 * kk + r) * 128 + t];
        }
      } else {
        named_barrier(kBarP, 256);  // P of this tile is in ex
        // dS = P (dP - delta) scale, every P read before dS overwrites it
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          x[e] = ex[e * 128 + t] * (x[e] - rowv[(e >> 1) & 1]) * scale;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pack_a<Op>(dsa[kk], x, kk);
#pragma unroll
          for (int r = 0; r < 4; ++r) exu[(4 * kk + r) * 128 + t] = dsa[kk][r];
        }
        named_barrier_arrive(kBarDs, 256);
      }

      // dQ += dS K over this consumer's slab: the tile's keys are the
      // contraction (a slab wholly past the tensor's columns computes
      // what is never stored)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_cols<kSlab, Op>(acc, dsa[kk],
                                 k_addr + 4 * c * kTile + kk * 16 * 128,
                                 kTile);
      }
      wgmma_commit();
      if constexpr (!kDeferK) {
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(dsa);
        if (lane == 0) mbar_arrive(&k_empty[ks]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dsa);

    // epilogue: this consumer's columns of dQ, the real rows
    if (has_cols) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row >= T) continue;
        In* out = dq + b * dq_sb + h * dq_sh + (int64_t)row * dq_st;
#pragma unroll
        for (int jn = 0; jn < kSlab / 8; ++jn) {
          const int col = col0 + 8 * jn + 2 * tg;
          if (col < d_true) {
            store2(out + col, acc[4 * jn + 2 * r], acc[4 * jn + 2 * r + 1]);
          }
        }
      }
    }
  }
}

template <typename In>
__global__ void __launch_bounds__(dkv::kThreads, 1)
    flash_bwd_dkv_wide_kernel(__grid_constant__ const CUtensorMap tm_q,
                              __grid_constant__ const CUtensorMap tm_k,
                              __grid_constant__ const CUtensorMap tm_v,
                              __grid_constant__ const CUtensorMap tm_do,
                              const Src src, const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              In* __restrict__ dk, In* __restrict__ dv,
                              int T, int Hq, int Hkv, int B, int rep,
                              int d_true, int64_t dk_sb, int64_t dk_st,
                              int64_t dk_sh, int64_t dv_sb, int64_t dv_st,
                              int64_t dv_sh, float scale, int causal) {
  using namespace wide;
  using S = dkv::DkvSplit<In>;
  using Op = typename Elem<In>::Op;
  constexpr bool kTma = Elem<In>::kTma;
  constexpr int kStages = kDkvSliceStages;
  constexpr int kSlabStages = dkv_slab_stages<In>();
  constexpr int kSliceBytes = slice_bytes<In>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t sl_full[kStages], sl_empty[kStages],
      do_full[kSlabStages], do_empty[kSlabStages], q_full[kSlabStages],
      q_empty[kSlabStages];
  uint8_t* slices = align_1024(smem_raw);  // slot: K, V, Q, dO (, rests)
  // the slab's columns of dO (consumer 0's) and of Q (consumer 1's)
  uint8_t* do_ring = slices + kStages * kSliceBytes;
  uint8_t* q_ring = do_ring + kSlabStages * kSlabTile;
  float* ex = reinterpret_cast<float*>(q_ring + kSlabStages * kSlabTile);
  // each slab stage's 64 rows of lse (log2 domain; dO's ring) and delta
  // (Q's ring)
  float* lse_rows = ex + 2 * kExFloats;
  float* dlt_rows = lse_rows + kSlabStages * 64;

  const int n_cb = cdiv(d_true, 64);
  const int n_slabs = cdiv(d_true, kSlab);
  // slabs innermost, then heads: under causal kv tile 0 sees every q row,
  // so low tiles, of every head, run first
  const int heads = Hkv * B;
  const int slab = blockIdx.x % n_slabs, tile = blockIdx.x / n_slabs;
  const int kvtile = tile / heads;
  const int hk = (tile % heads) % Hkv, b = (tile % heads) / Hkv;
  const int k0 = 64 * kvtile, c0 = slab * kSlab;
  const int n_scb = min(kSlab / 64, n_cb - c0 / 64);  // slab boxes inside
  // 64 q rows a step; a q head's steps start at the diagonal when causal
  const int q_start = causal ? k0 : 0;
  const int n_qs = cdiv(T - q_start, 64);
  const int n_iter = rep * n_qs;  // (q head, step) pairs, head-major

  if (threadIdx.x == 0) {
    // TMA: one expect_tx arrival (plus, on a slab stage, the 32 lanes that
    // write lse or delta); fp32: every producer thread
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sl_full[s], kTma ? 1 : 128);
      mbar_init(&sl_empty[s], dkv::kConsumerWarps);
    }
    for (int s = 0; s < kSlabStages; ++s) {
      mbar_init(&do_full[s], kTma ? 1 + 32 : 128);
      mbar_init(&q_full[s], kTma ? 1 + 32 : 128);
      mbar_init(&do_empty[s], 4);  // one consumer's warps
      mbar_init(&q_empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<S::kProducerRegs>();
    constexpr int kFillThreads = kTma ? 32 : 128;
    if (threadIdx.x < kFillThreads) {
      const int lane = threadIdx.x;
      const float* k_rows = nullptr;
      const float* v_rows = nullptr;
      if constexpr (!kTma) {
        k_rows = head_rows(src.ptr[1], src.stride[1], b, hk);
        v_rows = head_rows(src.ptr[2], src.stride[2], b, hk);
      }
      int sit = 0;
      for (int it = 0; it < n_iter; ++it) {
        const int h = hk * rep + it / n_qs;
        const int qs0 = q_start + (it % n_qs) * 64;
        const int64_t row = ((int64_t)b * Hq + h) * T;
        // the slab stages first (the consumers read them after the
        // slices): dO with lse, then Q with delta
        const int bs = it % kSlabStages;
        const uint32_t bpar = ((it / kSlabStages) & 1) ^ 1;
        for (int which = 0; which < 2; ++which) {
          uint64_t* full = which ? &q_full[bs] : &do_full[bs];
          mbar_wait(which ? &q_empty[bs] : &do_empty[bs], bpar);
          uint8_t* stage = (which ? q_ring : do_ring) + bs * kSlabTile;
          if constexpr (!kTma) {
            // Q is input 0, dO input 3
            const void* ptr = which ? src.ptr[0] : src.ptr[3];
            const long long* st = which ? src.stride[0] : src.stride[3];
            convert_rows<64, kSlab>(stage, head_rows(ptr, st, b, h) + c0,
                                    st[1], qs0, T, d_true - c0, lane);
            fence_proxy_async();
          } else if (lane == 0) {
            mbar_arrive_expect_tx(full, n_scb * kTile);
            for (int cb = 0; cb < n_scb; ++cb) {
              tma_load_4d(stage + cb * kTile, which ? &tm_q : &tm_do, full,
                          c0 + 64 * cb, h, qs0, b);
            }
          }
          float* rows_s = (which ? dlt_rows : lse_rows) + bs * 64;
          for (int i = lane; i < 64; i += kFillThreads) {
            const int t = qs0 + i;
            rows_s[i] = t >= T ? 0.f
                        : which ? delta[row + t]
                                : lse[row + t] * kLog2e;
          }
          mbar_arrive(full);  // release: this lane's rows are visible
        }

        // then every 64-column slice of K, V, Q and dO
        for (int cb = 0; cb < n_cb; ++cb, ++sit) {
          const int s = sit % kStages;
          uint8_t* sl = slices + s * kSliceBytes;
          if constexpr (!kTma) {
            mbar_wait(&sl_empty[s], ((sit / kStages) & 1) ^ 1);
            const int left = d_true - 64 * cb;
            convert_rows<64, 64>(sl, k_rows + 64 * cb, src.stride[1][1], k0,
                                 T, left, lane);
            convert_rows<64, 64>(sl + kTile, v_rows + 64 * cb,
                                 src.stride[2][1], k0, T, left, lane,
                                 sl + 4 * kTile);
            convert_rows<64, 64>(
                sl + 2 * kTile,
                head_rows(src.ptr[0], src.stride[0], b, h) + 64 * cb,
                src.stride[0][1], qs0, T, left, lane);
            convert_rows<64, 64>(
                sl + 3 * kTile,
                head_rows(src.ptr[3], src.stride[3], b, h) + 64 * cb,
                src.stride[3][1], qs0, T, left, lane, sl + 5 * kTile);
            fence_proxy_async();
            mbar_arrive(&sl_full[s]);
          } else if (lane == 0) {
            mbar_wait(&sl_empty[s], ((sit / kStages) & 1) ^ 1);
            mbar_arrive_expect_tx(&sl_full[s], 4 * kTile);
            tma_load_4d(sl, &tm_k, &sl_full[s], 64 * cb, hk, k0, b);
            tma_load_4d(sl + kTile, &tm_v, &sl_full[s], 64 * cb, hk, k0, b);
            tma_load_4d(sl + 2 * kTile, &tm_q, &sl_full[s], 64 * cb, h, qs0,
                        b);
            tma_load_4d(sl + 3 * kTile, &tm_do, &sl_full[s], 64 * cb, h, qs0,
                        b);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<S::kConsumerRegs>();
    // 0: S^T, P^T and dV; 1: dP^T, dS^T and dK; each over the whole slab
    const int c = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int key0 = k0 + 16 * w + g;  // this thread's keys: key0, key0 + 8
    const float scale_log2 = scale * kLog2e;
    uint64_t* slab_full = c == 0 ? do_full : q_full;
    uint64_t* slab_empty = c == 0 ? do_empty : q_empty;
    uint8_t* slab_ring = c == 0 ? do_ring : q_ring;
    const float* slab_rows = c == 0 ? lse_rows : dlt_rows;

    float acc[kSlab / 2];  // dV (consumer 0) or dK (consumer 1)
#pragma unroll
    for (int i = 0; i < kSlab / 2; ++i) acc[i] = 0.f;

    int sit = 0;
    for (int it = 0; it < n_iter; ++it) {
      const int jq = it % n_qs;
      const int wq0 = q_start + 64 * jq;  // the step's first q row
      const int bs = it % kSlabStages;
      // consumer 0: S^T = K Q^T; consumer 1: dP^T = V dO^T; 64 keys x 64
      // queries, over the slices
      float x[32];
      int prev = -1;  // the slot the group before the last one read
      for (int cb = 0; cb < n_cb; ++cb, ++sit) {
        const int s = sit % kStages;
        mbar_wait(&sl_full[s], (sit / kStages) & 1);
        const uint32_t base = smem_addr(slices) + s * kSliceBytes;
        const uint32_t a_t = base + c * kTile;            // K or V
        const uint32_t b_t = base + (2 + c) * kTile;      // Q or dO
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          wgmma_ss<64, Op>(x, desc_sw128(a_t + 32 * kq, 16, 1024),
                           desc_sw128(b_t + 32 * kq, 16, 1024),
                           cb > 0 || kq > 0);
        }
        if constexpr (!kTma) {
          if (c == 1) {
            // fp32: dP^T also takes V_hi dO_lo^T + V_lo dO_hi^T
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
              wgmma_ss<64, Op>(x, desc_sw128(a_t + 32 * kq, 16, 1024),
                               desc_sw128(base + 5 * kTile + 32 * kq, 16,
                                          1024),
                               1);
              wgmma_ss<64, Op>(x, desc_sw128(base + 4 * kTile + 32 * kq, 16,
                                             1024),
                               desc_sw128(b_t + 32 * kq, 16, 1024), 1);
            }
          }
        }
        wgmma_commit();
        // the group before this one has completed: free what it read
        wgmma_wait<1>();
        if (lane == 0 && prev >= 0) mbar_arrive(&sl_empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(x);
      if (lane == 0) mbar_arrive(&sl_empty[prev]);

      mbar_wait(&slab_full[bs], (it / kSlabStages) & 1);
      const float* rows_s = slab_rows + bs * 64;
      uint32_t a[4][4];
      if (c == 0) {
        // P^T; mask the ragged tail and, on the diagonal, the queries
        // before each key (keys past T are never stored)
        const bool need_mask = wq0 + 64 > T || (causal && jq == 0);
        float* p_out = ex + (it & 1) * kExFloats;
        if (it >= 2) named_barrier(kBarPFree + (it & 1), 256);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qi = 8 * (e / 4) + 2 * tg + (e & 1);  // in the 64 rows
          float p = exp2f(x[e] * scale_log2 - rows_s[qi]);
          if (need_mask) {
            const int col = wq0 + qi;
            const int key = key0 + ((e >> 1) & 1) * 8;
            if (col >= T || (causal && col < key)) p = 0.f;
          }
          x[e] = p;
          p_out[e * 128 + t] = p;
        }
        named_barrier_arrive(kBarPFull + (it & 1), 256);
      } else {
        // dS^T = P^T (dP^T - delta) scale, P^T from consumer 0
        named_barrier(kBarPFull + (it & 1), 256);
        const float* p_in = ex + (it & 1) * kExFloats;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qi = 8 * (e / 4) + 2 * tg + (e & 1);
          x[e] = p_in[e * 128 + t] * (x[e] - rows_s[qi]) * scale;
        }
        if (it + 2 < n_iter) named_barrier_arrive(kBarPFree + (it & 1), 256);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a<Op>(a[kk], x, kk);

      // dV += P^T dO or dK += dS^T Q over the slab: the 64 queries are
      // the contraction
      const uint32_t slab_addr = smem_addr(slab_ring) + bs * kSlabTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_cols<kSlab, Op>(acc, a[kk], slab_addr + kk * 16 * 128,
                                 kTile);
      }
      wgmma_commit();
      // waited for here, not behind the next step's slices (a product in
      // flight across the loop made ptxas serialise every wgmma, C7515)
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&slab_empty[bs]);
    }

    // epilogue: this consumer's output (dV or dK), the slab's columns of
    // the key rows it holds
    In* out = c == 0 ? dv : dk;
    const int64_t o_sb = c == 0 ? dv_sb : dk_sb;
    const int64_t o_st = c == 0 ? dv_st : dk_st;
    const int64_t o_sh = c == 0 ? dv_sh : dk_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= T) continue;
      In* o_row = out + b * o_sb + hk * o_sh + (int64_t)key * o_st;
#pragma unroll
      for (int jn = 0; jn < kSlab / 8; ++jn) {
        const int col = c0 + 8 * jn + 2 * tg;
        if (col >= d_true) continue;
        store2(o_row + col, acc[4 * jn + 2 * r], acc[4 * jn + 2 * r + 1]);
      }
    }
  }
}

template <typename In>
__global__ void __launch_bounds__(dkv::kThreads, 1)
    flash_bwd_dkv_cluster_kernel(__grid_constant__ const CUtensorMap tm_q,
                                 __grid_constant__ const CUtensorMap tm_k,
                                 __grid_constant__ const CUtensorMap tm_v,
                                 __grid_constant__ const CUtensorMap tm_do,
                                 const Src src, const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 In* __restrict__ dk, In* __restrict__ dv,
                                 int T, int Hq, int Hkv, int B, int rep,
                                 int d_true, int64_t dk_sb, int64_t dk_st,
                                 int64_t dk_sh, int64_t dv_sb, int64_t dv_st,
                                 int64_t dv_sh, float scale, int causal) {
  using namespace wide;
  using S = dkv::DkvSplit<In>;
  using Op = typename Elem<In>::Op;
  constexpr bool kTma = Elem<In>::kTma;
  constexpr int kStageBytes = dkc_stage_tiles<In>() * kSlabTile;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, st_full[2], st_empty[2],
      s_recv_full, dp_recv_full, s_sent_free, dp_sent_free;

  // the cluster: the n_slabs blocks of one (kv tile, kv head, batch), a
  // slab each, side by side on the grid
  const int n_slabs = cdiv(d_true, kSlab);
  const int n_peers = n_slabs - 1;
  const int n_stages = dkc_stages<In>(n_slabs);
  // the slab's K and V (fp32: and V's rest), resident; the stages, each
  // the slab's Q and dO (fp32: and dO's rest) of a step; a receive slot
  // for each peer's partial S^T and dP^T; the rows of lse and delta
  uint8_t* kv_s = align_1024(smem_raw);
  uint8_t* ring = kv_s + dkc_kv_tiles<In>() * kSlabTile;
  float* s_recv = reinterpret_cast<float*>(ring + n_stages * kStageBytes);
  float* dp_recv = s_recv + n_peers * kExFloats;
  float* lse_rows = dp_recv + n_peers * kExFloats;
  float* dlt_rows = lse_rows + 2 * 64;

  const int slab = cluster_ctarank(), tile = blockIdx.x / n_slabs;
  const int heads = Hkv * B;
  const int kvtile = tile / heads;
  const int hk = (tile % heads) % Hkv, b = (tile % heads) / Hkv;
  const int k0 = 64 * kvtile, c0 = slab * kSlab;
  // all four boxes of the slab are loaded: those wholly past the tensor's
  // columns arrive as zeros (TMA; fp32 converts zeros), so the partials
  // run over all four column blocks, an unrolled loop (a loop over the
  // boxes inside made ptxas serialise every wgmma, C7515)
  const int q_start = causal ? k0 : 0;
  const int n_qs = cdiv(T - q_start, 64);
  const int n_iter = rep * n_qs;  // (q head, step) pairs, head-major

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, kTma ? 1 : 128);
    for (int s = 0; s < n_stages; ++s) {
      // TMA: one expect_tx arrival plus the 32 lanes that write the rows
      mbar_init(&st_full[s], kTma ? 1 + 32 : 128);
      mbar_init(&st_empty[s], dkv::kConsumerWarps);
    }
    // a receive slot fills when this block's consumer has announced the
    // bytes it expects and every peer's bytes have landed; a peer may
    // send the next partial once every receiver has freed its slot
    mbar_init(&s_recv_full, 1);
    mbar_init(&dp_recv_full, 1);
    mbar_init(&s_sent_free, n_peers);
    mbar_init(&dp_sent_free, n_peers);
    mbar_fence_init();
  }
  // no block sends to a peer's barriers before the peer has made them
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<S::kProducerRegs>();
    constexpr int kFillThreads = kTma ? 32 : 128;
    if (threadIdx.x < kFillThreads) {
      const int lane = threadIdx.x;
      // the slab's K and V, once
      if constexpr (!kTma) {
        convert_rows<64, kSlab>(
            kv_s, head_rows(src.ptr[1], src.stride[1], b, hk) + c0,
            src.stride[1][1], k0, T, d_true - c0, lane);
        convert_rows<64, kSlab>(
            kv_s + kSlabTile, head_rows(src.ptr[2], src.stride[2], b, hk) + c0,
            src.stride[2][1], k0, T, d_true - c0, lane,
            kv_s + 2 * kSlabTile);
        fence_proxy_async();
        mbar_arrive(&kv_full);
      } else if (lane == 0) {
        mbar_arrive_expect_tx(&kv_full, 2 * kSlabTile);
        for (int cb = 0; cb < kSlab / 64; ++cb) {
          tma_load_4d(kv_s + cb * kTile, &tm_k, &kv_full, c0 + 64 * cb, hk,
                      k0, b);
          tma_load_4d(kv_s + kSlabTile + cb * kTile, &tm_v, &kv_full,
                      c0 + 64 * cb, hk, k0, b);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int h = hk * rep + it / n_qs;
        const int qs0 = q_start + (it % n_qs) * 64;
        const int bs = it % n_stages;
        mbar_wait(&st_empty[bs], ((it / n_stages) & 1) ^ 1);
        uint8_t* stage = ring + bs * kStageBytes;
        if constexpr (!kTma) {
          convert_rows<64, kSlab>(
              stage, head_rows(src.ptr[0], src.stride[0], b, h) + c0,
              src.stride[0][1], qs0, T, d_true - c0, lane);
          convert_rows<64, kSlab>(
              stage + kSlabTile,
              head_rows(src.ptr[3], src.stride[3], b, h) + c0,
              src.stride[3][1], qs0, T, d_true - c0, lane,
              stage + 2 * kSlabTile);
          fence_proxy_async();
        } else if (lane == 0) {
          mbar_arrive_expect_tx(&st_full[bs], 2 * kSlabTile);
          for (int cb = 0; cb < kSlab / 64; ++cb) {
            tma_load_4d(stage + cb * kTile, &tm_q, &st_full[bs],
                        c0 + 64 * cb, h, qs0, b);
            tma_load_4d(stage + kSlabTile + cb * kTile, &tm_do, &st_full[bs],
                        c0 + 64 * cb, h, qs0, b);
          }
        }
        const int64_t row = ((int64_t)b * Hq + h) * T;
        for (int i = lane; i < 64; i += kFillThreads) {
          const int t = qs0 + i;
          lse_rows[bs * 64 + i] = t < T ? lse[row + t] * kLog2e : 0.f;
          dlt_rows[bs * 64 + i] = t < T ? delta[row + t] : 0.f;
        }
        mbar_arrive(&st_full[bs]);  // release: this lane's rows are visible
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<S::kConsumerRegs>();
    // 0: the partial S^T, the sum S^T, P^T (passed to consumer 1 through
    // its first receive slot) and dV; 1: the partial dP^T, the sum dP^T,
    // dS^T and dK; each over the block's slab
    const int c = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int key0 = k0 + 16 * w + g;  // this thread's keys: key0, key0 + 8
    const float scale_log2 = scale * kLog2e;
    // K (consumer 0) or V (consumer 1) of the slab: the A operand of the
    // partial; Q or dO of a stage its B operand
    const uint32_t a_slab = smem_addr(kv_s) + c * kSlabTile;
    float* recv = c == 0 ? s_recv : dp_recv;
    uint64_t* recv_full = c == 0 ? &s_recv_full : &dp_recv_full;
    uint64_t* sent_free = c == 0 ? &s_sent_free : &dp_sent_free;
    // a block's receive slots: one a peer, in rank order, the receiving
    // block's own rank left out
    const uint32_t recv_a = smem_addr(recv) + 16 * t;
    const uint32_t peer_full = smem_addr(recv_full);

    float acc[kSlab / 2];  // dV (consumer 0) or dK (consumer 1)
#pragma unroll
    for (int i = 0; i < kSlab / 2; ++i) acc[i] = 0.f;

    mbar_wait(&kv_full, 0);
    TRACE_START
    for (int it = 0; it < n_iter; ++it) {
      const int jq = it % n_qs;
      const int wq0 = q_start + 64 * jq;  // the step's first q row
      const int bs = it % n_stages;
      const uint32_t stage = smem_addr(ring) + bs * kStageBytes;
      mbar_wait(&st_full[bs], (it / n_stages) & 1);
      TRACE(0)
      // the bytes this step's receive slots expect, announced early
      if (t == 0) mbar_arrive_expect_tx(recv_full, n_peers * kExBytes);

      // this block's partial S^T = K Q^T (consumer 0) or dP^T = V dO^T
      // (consumer 1) over the slab's columns: 64 keys x 64 queries
      float x[32];
      const uint32_t b_slab = stage + c * kSlabTile;  // Q or dO
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < kSlab / 64; ++cb) {
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          wgmma_ss<64, Op>(
              x, desc_sw128(a_slab + cb * kTile + 32 * kq, 16, 1024),
              desc_sw128(b_slab + cb * kTile + 32 * kq, 16, 1024),
              cb > 0 || kq > 0);
        }
        if constexpr (!kTma) {
          if (c == 1) {
            // fp32: dP^T also takes V_hi dO_lo^T + V_lo dO_hi^T
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
              wgmma_ss<64, Op>(
                  x, desc_sw128(a_slab + cb * kTile + 32 * kq, 16, 1024),
                  desc_sw128(stage + 2 * kSlabTile + cb * kTile + 32 * kq, 16,
                             1024),
                  1);
              wgmma_ss<64, Op>(
                  x,
                  desc_sw128(smem_addr(kv_s) + 2 * kSlabTile + cb * kTile +
                                 32 * kq,
                             16, 1024),
                  desc_sw128(b_slab + cb * kTile + 32 * kq, 16, 1024), 1);
            }
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      TRACE(1)

      // send the partial to every peer once every peer has freed this
      // block's slot (its last one read): asynchronous stores that land
      // in the peer's slot and count their bytes on its barrier, in
      // fragment order (thread t's elements 4 q .. 4 q + 3 at float4
      // q * 128 + t)
      if (it > 0) mbar_wait_cluster(sent_free, (it - 1) & 1);
      TRACE(2)
      for (int r = 0; r < n_slabs; ++r) {
        if (r == slab) continue;
        const uint32_t to =
            mapa(recv_a + (slab < r ? slab : slab - 1) * kExBytes, r);
        const uint32_t bar = mapa(peer_full, r);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          st_async_f4(to + q * 128 * 16, x[4 * q], x[4 * q + 1],
                      x[4 * q + 2], x[4 * q + 3], bar);
        }
      }
      TRACE(3)

      // the sum over the cluster's blocks in rank order (this block's own
      // partial from its registers): every block the same bits
      float sum[32];
      mbar_wait(recv_full, it & 1);
      TRACE(4)
      for (int r = 0; r < n_slabs; ++r) {
        const float4* from = reinterpret_cast<const float4*>(
                                 recv + (r < slab ? r : r - 1) * kExFloats) +
                             t;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float4 v = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                                 x[4 * q + 3]);
          if (r != slab) v = from[q * 128];
          if (r == 0) {
            sum[4 * q] = v.x, sum[4 * q + 1] = v.y;
            sum[4 * q + 2] = v.z, sum[4 * q + 3] = v.w;
          } else {
            sum[4 * q] += v.x, sum[4 * q + 1] += v.y;
            sum[4 * q + 2] += v.z, sum[4 * q + 3] += v.w;
          }
        }
      }
      TRACE(5)

      const float* lse_s = lse_rows + bs * 64;
      const float* dlt_s = dlt_rows + bs * 64;
      if (c == 0) {
        // P^T; mask the ragged tail and, on the diagonal, the queries
        // before each key (keys past T are never stored)
        const bool need_mask = wq0 + 64 > T || (causal && jq == 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * tg);
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int e = 4 * j + e4;
            float p = exp2f(sum[e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
            if (need_mask) {
              const int col = wq0 + 8 * j + 2 * tg + (e & 1);
              const int key = key0 + ((e >> 1) & 1) * 8;
              if (col >= T || (causal && col < key)) p = 0.f;
            }
            sum[e] = p;
          }
        }
        // P^T to consumer 1 over the first receive slot, read now
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          reinterpret_cast<float4*>(s_recv)[q * 128 + t] =
              make_float4(sum[4 * q], sum[4 * q + 1], sum[4 * q + 2],
                          sum[4 * q + 3]);
        }
        named_barrier_arrive(kBarPFull, 256);
      } else {
        // every thread has its dP^T: the peers may send the next
        named_barrier(kBarConsumer, 128);
        if (t == 0) {
          for (int r = 0; r < n_slabs; ++r) {
            if (r != slab) mbar_arrive_remote(mapa(smem_addr(sent_free), r));
          }
        }
        // dS^T = P^T (dP^T - delta) scale, P^T from consumer 0
        named_barrier(kBarPFull, 256);
        const float4* p_in = reinterpret_cast<const float4*>(s_recv) + t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(dlt_s + 8 * j + 2 * tg);
          const float4 p = p_in[j * 128];
          sum[4 * j] = p.x * (sum[4 * j] - d2.x) * scale;
          sum[4 * j + 1] = p.y * (sum[4 * j + 1] - d2.y) * scale;
          sum[4 * j + 2] = p.z * (sum[4 * j + 2] - d2.x) * scale;
          sum[4 * j + 3] = p.w * (sum[4 * j + 3] - d2.y) * scale;
        }
        // every thread has its P^T: the peers may send the next S^T
        named_barrier(kBarConsumer, 128);
        if (t == 0) {
          for (int r = 0; r < n_slabs; ++r) {
            if (r != slab) mbar_arrive_remote(mapa(smem_addr(&s_sent_free), r));
          }
        }
      }
      TRACE(6)
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a<Op>(a[kk], sum, kk);

      // dV += P^T dO or dK += dS^T Q over the slab: the 64 queries are
      // the contraction
      const uint32_t slab_b = stage + (1 - c) * kSlabTile;  // dO or Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_cols<kSlab, Op>(acc, a[kk], slab_b + kk * 16 * 128, kTile);
      }
      wgmma_commit();
      // waited for here, not behind the next step's partial (a product in
      // flight across the loop made ptxas serialise every wgmma, C7515)
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&st_empty[bs]);
      TRACE(7)
    }
    // no peer sends to or arrives on this block after it exits: every
    // receiver has freed the last partial this block sent
    mbar_wait_cluster(sent_free, (n_iter - 1) & 1);

    // epilogue: this consumer's output (dV or dK), the slab's columns of
    // the key rows it holds
    In* out = c == 0 ? dv : dk;
    const int64_t o_sb = c == 0 ? dv_sb : dk_sb;
    const int64_t o_st = c == 0 ? dv_st : dk_st;
    const int64_t o_sh = c == 0 ? dv_sh : dk_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= T) continue;
      In* o_row = out + b * o_sb + hk * o_sh + (int64_t)key * o_st;
#pragma unroll
      for (int jn = 0; jn < kSlab / 8; ++jn) {
        const int col = c0 + 8 * jn + 2 * tg;
        if (col >= d_true) continue;
        store2(o_row + col, acc[4 * jn + 2 * r], acc[4 * jn + 2 * r + 1]);
      }
    }
  }
}

template <typename In>
int dq_config_wide(int* out) {
  static_assert(wide::dq_smem<In>() <= 232448 - 256,
                "a block may use 227 KB of shared memory");
  out[0] = wide::dq_smem<In>();
  out[1] = wide::DqSplit<In>::kThreads;
  out[2] = wide::DqSplit<In>::kLaunchRegs;
  out[3] = 64;
  return 0;
}

template <typename In>
int dkv_config_wide(int* out) {
  static_assert(wide::dkv_smem<In>() <= 232448 - 256,
                "a block may use 227 KB of shared memory");
  out[0] = wide::dkv_smem<In>();
  out[1] = dkv::kThreads;
  out[2] = dkv::kLaunchRegs;
  out[3] = dkv::kKvRows;
  return 0;
}

template <typename In>
int launch_dq_wide(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, int B, int T, int Hq, int Hkv,
                   int d_true, const long long* s, float scale, int causal,
                   cudaStream_t stream) {
  using S = wide::DqSplit<In>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  Src src = {};
  int err = prepare_input<In>(&tm_q, &src, 0, q, B, T, Hq, d_true, s, 64);
  if (!err) err = prepare_input<In>(&tm_k, &src, 1, k, B, T, Hkv, d_true,
                                    s + 3, 64);
  if (!err) err = prepare_input<In>(&tm_v, &src, 2, v, B, T, Hkv, d_true,
                                    s + 6, 64);
  if (!err) err = prepare_input<In>(&tm_do, &src, 3, dout, B, T, Hq, d_true,
                                    s + 12, 64);
  constexpr int kSmem = wide::dq_smem<In>();
  auto kernel = flash_bwd_dq_wide_kernel<In>;
  if (!err) err = prepare_launch(kernel, kSmem, S::kLaunchRegs);
  if (err) return err;
  // a block a (q tile, q head, batch, pair of slabs), pairs innermost
  const int grid = cdiv(T, 64) * Hq * B * cdiv(d_true, wide::kPair);
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, src, static_cast<const In*>(o),
      static_cast<const In*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<In*>(dq), T, Hq, B, Hq / Hkv,
      d_true, s[9], s[10], s[11], s[12], s[13], s[14], s[15], s[16], s[17],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_dkv_wide(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int T, int Hq, int Hkv,
                    int d_true, const long long* s, float scale, int causal,
                    cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  Src src = {};
  int err = prepare_input<In>(&tm_q, &src, 0, q, B, T, Hq, d_true, s, 64);
  if (!err) err = prepare_input<In>(&tm_k, &src, 1, k, B, T, Hkv, d_true,
                                    s + 3, 64);
  if (!err) err = prepare_input<In>(&tm_v, &src, 2, v, B, T, Hkv, d_true,
                                    s + 6, 64);
  if (!err) err = prepare_input<In>(&tm_do, &src, 3, dout, B, T, Hq, d_true,
                                    s + 9, 64);
  constexpr int kSmem = wide::dkv_smem<In>();
  auto kernel = flash_bwd_dkv_wide_kernel<In>;
  if (!err) err = prepare_launch(kernel, kSmem, dkv::kLaunchRegs);
  if (err) return err;
  const int grid = cdiv(T, 64) * Hkv * B * cdiv(d_true, wide::kSlab);
  kernel<<<grid, dkv::kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, src, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<In*>(dk),
      static_cast<In*>(dv), T, Hq, Hkv, B, Hq / Hkv, d_true, s[12], s[13],
      s[14], s[15], s[16], s[17], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int dkv_config_cluster(int* out) {
  static_assert(wide::dkc_smem<In>() <= 232448 - 256,
                "a block may use 227 KB of shared memory");
  out[0] = wide::dkc_smem<In>();
  out[1] = dkv::kThreads;
  out[2] = dkv::kLaunchRegs;
  out[3] = dkv::kKvRows;
  return 0;
}

template <typename In>
int launch_dkv_cluster(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int T, int Hq, int Hkv,
                       int d_true, const long long* s, float scale,
                       int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  Src src = {};
  int err = prepare_input<In>(&tm_q, &src, 0, q, B, T, Hq, d_true, s, 64);
  if (!err) err = prepare_input<In>(&tm_k, &src, 1, k, B, T, Hkv, d_true,
                                    s + 3, 64);
  if (!err) err = prepare_input<In>(&tm_v, &src, 2, v, B, T, Hkv, d_true,
                                    s + 6, 64);
  if (!err) err = prepare_input<In>(&tm_do, &src, 3, dout, B, T, Hq, d_true,
                                    s + 9, 64);
  constexpr int kSmem = wide::dkc_smem<In>();
  auto kernel = flash_bwd_dkv_cluster_kernel<In>;
  if (!err) err = prepare_launch(kernel, kSmem, dkv::kLaunchRegs);
  if (err) return err;
  // a cluster a (kv tile, kv head, batch), a block a slab
  const int n_slabs = cdiv(d_true, wide::kSlab);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cdiv(T, 64) * Hkv * B * n_slabs);
  config.blockDim = dim3(dkv::kThreads);
  config.dynamicSmemBytes = kSmem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_slabs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &config, kernel, tm_q, tm_k, tm_v, tm_do, src,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<In*>(dk), static_cast<In*>(dv), T, Hq, Hkv, B, Hq / Hkv,
      d_true, (int64_t)s[12], (int64_t)s[13], (int64_t)s[14], (int64_t)s[15],
      (int64_t)s[16], (int64_t)s[17], scale, causal));
  return err ? err : static_cast<int>(cudaGetLastError());
}

// The instantiations head_dim D runs on: dQ at 64, 128 or 256 (see
// dqk::Shape); dK/dV at <64, 3 stages>, <128, 2> or <256, 2>, and for
// fp32, whose stages hold a third tile, <64, 3>, <128, 1> or <256, 1>;
// past 256 the slab kernels above.
template <typename In>
constexpr int dkv_stages(int D) {
  return D <= 64 ? 3 : Elem<In>::kTma ? 2 : 1;
}

template <typename In>
int launch_dq_for(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta, void* dq,
                  int B, int T, int Hq, int Hkv, int D, const long long* s,
                  float scale, int causal, cudaStream_t st) {
  if (D > wide::kSlab) {
    return launch_dq_wide<In>(q, k, v, o, dout, lse, delta, dq, B, T, Hq,
                              Hkv, D, s, scale, causal, st);
  }
  if constexpr (!Elem<In>::kTma) {
    // fp32 up to 256 columns: flash_attention_bwd_dq_split
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (D <= kNarrowWidth) {  // dS as two parts (flash_attention_sm90.cuh)
      return launch_dq<64, In, 2>(q, k, v, o, dout, lse, delta, dq, B, T,
                                  Hq, Hkv, D, s, scale, causal, st);
    }
    if (D <= 64) {
      return launch_dq<64, In>(q, k, v, o, dout, lse, delta, dq, B, T, Hq,
                               Hkv, D, s, scale, causal, st);
    }
    if (D <= 128) {
      return launch_dq<128, In>(q, k, v, o, dout, lse, delta, dq, B, T, Hq,
                                Hkv, D, s, scale, causal, st);
    }
    return launch_dq<256, In>(q, k, v, o, dout, lse, delta, dq, B, T, Hq,
                              Hkv, D, s, scale, causal, st);
  }
}

// in: q, k, v, dO (w8 0), or up to 256 columns the split pass's six
// copies (w8 > 0), as launch_dkv takes them
template <typename In>
int launch_dkv_for(const void* const* in, int w8, const void* lse,
                   const void* delta, void* dk, void* dv, void* part,
                   int n_split, int B, int T, int Hq, int Hkv, int D,
                   const long long* s, float scale, int causal,
                   cudaStream_t st) {
  if (D > wide::kSlab && w8 > 0) {
    return static_cast<int>(cudaErrorInvalidValue);  // copies up to 256
  }
  if (D > wide::dkc_max_slabs<In>() * wide::kSlab) {
    return launch_dkv_wide<In>(in[0], in[1], in[2], in[3], lse, delta, dk,
                               dv, B, T, Hq, Hkv, D, s, scale, causal, st);
  }
  if (D > wide::kSlab) {
    return launch_dkv_cluster<In>(in[0], in[1], in[2], in[3], lse, delta, dk,
                                  dv, B, T, Hq, Hkv, D, s, scale, causal, st);
  }
  if (D <= kNarrowWidth) {  // P^T, dS^T as two parts (sm90.cuh)
    return launch_dkv<64, dkv_stages<In>(64), In, 2>(
        in, w8, lse, delta, dk, dv, nullptr, 1, B, T, Hq, Hkv, D, s, scale,
        causal, st);
  }
  if (D <= 64) {
    return launch_dkv<64, dkv_stages<In>(64), In>(
        in, w8, lse, delta, dk, dv, nullptr, 1, B, T, Hq, Hkv, D, s, scale,
        causal, st);
  }
  if (D <= 128) {
    return launch_dkv<128, dkv_stages<In>(128), In>(
        in, w8, lse, delta, dk, dv, nullptr, 1, B, T, Hq, Hkv, D, s, scale,
        causal, st);
  }
  return launch_dkv<256, dkv_stages<In>(256), In>(
      in, w8, lse, delta, dk, dv, part, n_split, B, T, Hq, Hkv, D, s, scale,
      causal, st);
}

template <typename In>
int dq_config_for(int D, int* out) {
  if (D > wide::kSlab) return dq_config_wide<In>(out);
  return D <= 64    ? dq_config<64, In>(out)
         : D <= 128 ? dq_config<128, In>(out)
                    : dq_config<256, In>(out);
}

template <typename In>
int dkv_config_for(int D, int* out) {
  if (D > wide::dkc_max_slabs<In>() * wide::kSlab) {
    return dkv_config_wide<In>(out);
  }
  if (D > wide::kSlab) return dkv_config_cluster<In>(out);
  return D <= 64    ? dkv_config<64, dkv_stages<In>(64), In>(out)
         : D <= 128 ? dkv_config<128, dkv_stages<In>(128), In>(out)
                    : dkv_config<256, dkv_stages<In>(256), In>(out);
}

bool bad_shape(int B, int T, int Hq, int Hkv) {
  return B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0;
}

// A dK/dV call's arguments, checked as the entry points take them
bool bad_dkv(int B, int T, int Hq, int Hkv, int D, int d_head, int n_split,
             int dtype, const void* part) {
  return bad_shape(B, T, Hq, Hkv) || dtype != FLASH_DTYPE ||
         bad_head_dim(D, d_head, dtype) || n_split < 1 || n_split > 64 ||
         (n_split > 1 && (D <= 128 || D > wide::kSlab || part == nullptr));
}

}  // namespace

extern "C" {

// q, o, dout, dq: [B, T, Hq, D]; k, v: [B, T, Hkv, D], all of the type
// `dtype` names (0 bf16, 1 fp16, 2 fp32), the one this library is built
// for (FLASH_DTYPE); lse: [B, Hq, T] fp32 contiguous, in natural-log
// units. Writes dq and delta = rowsum(o *
// dout), [B, Hq, T] fp32 contiguous (the dK/dV kernel reads it). strides:
// 18 element strides (batch, time, head) of q, k, v, o, dout and dq in
// that order; the head_dim stride is 1, every stride a multiple of 16
// bytes and every base 16-byte aligned (TMA). D is the tensors' head_dim,
// any D >= 1 with rows a multiple of 16 bytes; d_head <= D the true
// head_dim (the scale is 1/sqrt(d_head); columns d_head .. D - 1 are
// zeros the wrapper padded with). Launches on `stream`; returns 0 on
// success, else a cudaError_t or one of the codes that
// flash_attention_error_string names.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* delta, void* dq, int B, int T, int Hq,
                           int Hkv, int D, int d_head, int dtype,
                           const long long* strides, int causal,
                           void* stream) {
  if (bad_shape(B, T, Hq, Hkv) || dtype != FLASH_DTYPE ||
      bad_head_dim(D, d_head, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale = 1.f / sqrtf(static_cast<float>(d_head));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_dq_for<Built>(q, k, v, o, dout, lse, delta, dq, B, T, Hq,
                              Hkv, D, strides, scale, causal, st);
}

// The split pass of fp32 inputs (flash_bwd_split_kernel): q, o, dout [B,
// T, Hq, D] and k, v [B, T, Hkv, D] fp32 (dtype 2; this library built for
// it), D any width with 16-byte rows; strides: 15 element strides (batch,
// time, head) of q, k, v, o and dout. Writes q_hi, do_hi, do_lo [B, T,
// Hq, w8] and k_hi, v_hi, v_lo [B, T, Hkv, w8] bf16 contiguous, w8 = D
// rounded up to 8 (the columns past D zeros), and delta = rowsum(o *
// dout) [B, Hq, T] fp32; o and delta null: the copies alone (a dK/dV
// call given delta; o's strides are not read). `causal` is not read.
// Launches on `stream`; returns 0 on success, else a cudaError_t.
int flash_attention_bwd_split(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, void* q_hi,
                              void* k_hi, void* v_hi, void* v_lo,
                              void* do_hi, void* do_lo, void* delta, int B,
                              int T, int Hq, int Hkv, int D, int dtype,
                              const long long* strides, int causal,
                              void* stream) {
  (void)causal;
#if FLASH_DTYPE != 2
  return static_cast<int>(cudaErrorInvalidValue);  // the fp32 library's
#else
  if (bad_shape(B, T, Hq, Hkv) || dtype != FLASH_DTYPE ||
      bad_head_dim(D, D, dtype) || (o == nullptr) != (delta == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SplitStrides st;
  for (int i = 0; i < 15; ++i) st.s[i / 3][i % 3] = strides[i];
  const int blocks = cdiv(B * T * Hq, kSplitRows) + cdiv(B * T * Hkv,
                                                         kSplitRows);
  flash_bwd_split_kernel<<<blocks, 4 * kSplitRows, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<uint4*>(q_hi),
      static_cast<uint4*>(k_hi), static_cast<uint4*>(v_hi),
      static_cast<uint4*>(v_lo), static_cast<uint4*>(do_hi),
      static_cast<uint4*>(do_lo), static_cast<float*>(delta), B, T, Hq, Hkv,
      D, cdiv(D, 8) * 8, st);
  return static_cast<int>(cudaGetLastError());
#endif
}

// fp32 dQ at head_dim D <= 256 from the split pass's copies (q_hi, k_hi,
// v_hi, v_lo, do_hi, do_lo: bf16, as flash_attention_bwd_split writes
// them, for inputs of width D) and its delta: dq [B, T, Hq, D] fp32 at
// the 3 element strides (batch, time, head) in `strides`; lse as for
// flash_attention_bwd_dq. Launches on `stream`; returns 0 on success,
// else a cudaError_t or one of the codes that
// flash_attention_error_string names.
int flash_attention_bwd_dq_split(const void* q_hi, const void* k_hi,
                                 const void* v_hi, const void* v_lo,
                                 const void* do_hi, const void* do_lo,
                                 const void* lse, const void* delta,
                                 void* dq, int B, int T, int Hq, int Hkv,
                                 int D, int d_head, int dtype,
                                 const long long* strides, int causal,
                                 void* stream) {
#if FLASH_DTYPE != 2
  return static_cast<int>(cudaErrorInvalidValue);  // the fp32 library's
#else
  if (bad_shape(B, T, Hq, Hkv) || dtype != FLASH_DTYPE ||
      bad_head_dim(D, d_head, dtype) || D > wide::kSlab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale = 1.f / sqrtf(static_cast<float>(d_head));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* hi_lo[6] = {q_hi, k_hi, v_hi, v_lo, do_hi, do_lo};
  const int w8 = cdiv(D, 8) * 8;
  if (D <= kNarrowWidth) {  // dS as two parts (flash_attention_sm90.cuh)
    return launch_dq_split<64, 2>(hi_lo, lse, delta, dq, B, T, Hq, Hkv, D,
                                  w8, strides, scale, causal, st);
  }
  if (D <= 64) {
    return launch_dq_split<64>(hi_lo, lse, delta, dq, B, T, Hq, Hkv, D, w8,
                               strides, scale, causal, st);
  }
  if (D <= 128) {
    return launch_dq_split<128>(hi_lo, lse, delta, dq, B, T, Hq, Hkv, D, w8,
                                strides, scale, causal, st);
  }
  return launch_dq_split<256>(hi_lo, lse, delta, dq, B, T, Hq, Hkv, D, w8,
                              strides, scale, causal, st);
#endif
}

// The launch shape of the dQ kernel that head_dim D of type `dtype` runs
// on: out[0] bytes of dynamic shared memory, out[1] threads a block,
// out[2] registers a thread at launch, out[3] q rows a block. Returns 0,
// or cudaErrorInvalidValue for a D or type the library does not take.
int flash_attention_bwd_dq_config(int D, int dtype, int* out) {
  if (dtype != FLASH_DTYPE || bad_head_dim(D, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dq_config_for<Built>(D, out);
}

// As above, writing dk and dv [B, T, Hkv, D] in the input type (summed
// over the rep q heads of each kv head). strides: 18 element strides
// (batch, time, head) of q, k, v, dout, dk and dv in that order; every
// base is 16-byte aligned (TMA). n_split: the chunks each kv tile's (q
// head, q stage) pairs are cut into, 1 or, at 128 < D <= 256 only, up to
// 64 (ray_tpu_torch/ops/flash_schedule.py chooses it); part [2, n_split,
// B, T, Hkv, 256] fp32 holds the chunks' partial dK and dV (null when
// n_split is 1). fp32 up to D 256 runs on the split pass's copies only
// (flash_attention_bwd_dkv_split). Launches on `stream` (the kernel and,
// split, the reduction); returns 0 on success, else a cudaError_t or one
// of the codes that flash_attention_error_string names.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            void* part, int B, int T, int Hq, int Hkv, int D,
                            int d_head, int n_split, int dtype,
                            const long long* strides, int causal,
                            void* stream) {
  if (bad_dkv(B, T, Hq, Hkv, D, d_head, n_split, dtype, part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale = 1.f / sqrtf(static_cast<float>(d_head));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* in[4] = {q, k, v, dout};
  return launch_dkv_for<Built>(in, 0, lse, delta, dk, dv, part, n_split, B,
                               T, Hq, Hkv, D, strides, scale, causal, st);
}

// fp32 dK/dV at head_dim D <= 256 from the split pass's copies (q_hi,
// k_hi, v_hi, v_lo, do_hi, do_lo: bf16, as flash_attention_bwd_split
// writes them, with or without delta, for inputs of width D): dk and dv
// [B, T, Hkv, D] fp32 at the 6 element strides (batch, time, head) of dk
// and dv in `strides`; lse, delta, part, n_split and the rest as for
// flash_attention_bwd_dkv. Launches on `stream` (the kernel and, split,
// the reduction); returns 0 on success, else a cudaError_t or one of the
// codes that flash_attention_error_string names.
int flash_attention_bwd_dkv_split(const void* q_hi, const void* k_hi,
                                  const void* v_hi, const void* v_lo,
                                  const void* do_hi, const void* do_lo,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, void* part, int B,
                                  int T, int Hq, int Hkv, int D, int d_head,
                                  int n_split, int dtype,
                                  const long long* strides, int causal,
                                  void* stream) {
#if FLASH_DTYPE != 2
  return static_cast<int>(cudaErrorInvalidValue);  // the fp32 library's
#else
  if (bad_dkv(B, T, Hq, Hkv, D, d_head, n_split, dtype, part) ||
      D > wide::kSlab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale = 1.f / sqrtf(static_cast<float>(d_head));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* in[6] = {q_hi, k_hi, v_hi, v_lo, do_hi, do_lo};
  long long s[18] = {};
  for (int i = 0; i < 6; ++i) s[12 + i] = strides[i];  // dk's, dv's
  return launch_dkv_for<Built>(in, cdiv(D, 8) * 8, lse, delta, dk, dv, part,
                               n_split, B, T, Hq, Hkv, D, s, scale, causal,
                               st);
#endif
}

// The launch shape of the dK/dV kernel that head_dim D of type `dtype`
// runs on: out[0] bytes of dynamic shared memory, out[1] threads a block,
// out[2] registers a thread at launch, out[3] kv rows a block. Returns 0,
// or cudaErrorInvalidValue for a D or type the library does not take.
int flash_attention_bwd_dkv_config(int D, int dtype, int* out) {
  if (dtype != FLASH_DTYPE || bad_head_dim(D, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dkv_config_for<Built>(D, out);
}

#if WIDE_TRACE
int flash_wide_trace(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, wide_trace, sizeof(wide_trace));
  unsigned long long zero[2][16] = {};
  return (int)cudaMemcpyToSymbol(wide_trace, zero, sizeof(zero));
}
#endif

const char* flash_attention_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"

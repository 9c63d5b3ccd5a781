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
// dQ at head_dim 256: one consumer on 64-key stages, two of them (Q and
// dO of 64 rows and two stages of K and V fill 193 KB of the 227 KB a
// block may use); dQ += dS K is two products of 128 columns.
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
// their own type (P and dS are rounded to it as A operands); fp32 tiles are
// loaded by all four producer warps (which keep 40 registers), rounded to
// bf16 into the same swizzled tiles, and run the bf16 products: an fp32
// call computes its products with bf16 operands and fp32 sums. delta is
// taken from O and dO in fp32 as they lie in device memory, so dP = dO
// V^T, which dS sets against it, takes dO and V each as two bf16 tiles
// (the rounded value and what the rounding left) in three products, hi
// hi + lo hi + hi lo: with one rounded product, dP - delta, which is 0
// where a row has one key, came out at the operands' rounding (2^-9 of
// |dO| |V|) and failed the block gate at T = 1. The extra tiles cost the
// rings stages: dQ keeps one at head_dim 256 (its producer then loads K
// and V of a tile in turn), dK/dV one at 128 and 256. Outputs are written
// in the input type.
//
// Both kernels are built for head_dim 64, 128 and 256; a narrower head_dim is
// read through TMA maps of its true width (missing columns arrive as
// zeros and add exact zeros to every product), scaled by 1/sqrt(true
// head_dim) and stored at its true width. A head_dim past 256 runs on the
// slab kernels (flash_bwd_dq_wide_kernel, flash_bwd_dkv_wide_kernel
// below), any width. Both mask the causal diagonal
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

// -------------------------------------------------------------------- dQ

namespace dqk {

// The kernel's shape per head_dim: keys a K/V stage, stages, consumer
// warpgroups a block. At 128 two consumers (128 q rows, one block a SM)
// on 64-key stages (128-key S and dP would not fit the registers); at 64
// one consumer (64 q rows, two blocks a SM) on 128-key stages: on an
// H100 two consumers were no faster, and 64-key stages slower.
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
template <>
struct Shape<256> {
  static constexpr int kBlockN = 64, kStages = 2, kConsumers = 1;
};

// the register split: a producer that converts fp32 tiles keeps 40
template <int D, typename In>
using DqSplit = Split<Shape<D>::kConsumers, Elem<In>::kTma ? 24 : 40>;

// stages of the K/V ring: fp32 stages hold V twice (rounded, and what the
// rounding left), so two up to head_dim 128 and one at 256
template <int D, typename In>
__host__ __device__ constexpr int stages() {
  return Elem<In>::kTma ? Shape<D>::kStages : D > 128 ? 1 : 2;
}

}  // namespace dqk

template <int D, typename In>
__global__ void __launch_bounds__(dqk::DqSplit<D, In>::kThreads,
                                  dqk::DqSplit<D, In>::kBlocksPerSm)
    flash_bwd_dq_kernel(__grid_constant__ const CUtensorMap tm_q,
                        __grid_constant__ const CUtensorMap tm_k,
                        __grid_constant__ const CUtensorMap tm_v,
                        __grid_constant__ const CUtensorMap tm_do,
                        const Src src, const In* __restrict__ o,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, In* __restrict__ dq,
                        int T, int Hq, int B, int rep, int d_true,
                        int64_t o_sb, int64_t o_st, int64_t o_sh,
                        int64_t dq_sb, int64_t dq_st, int64_t dq_sh,
                        float scale, int causal) {
  constexpr int kBlockN = dqk::Shape<D>::kBlockN;  // keys a stage
  constexpr int kStages = dqk::stages<D, In>();
  constexpr int kConsumers = dqk::Shape<D>::kConsumers;
  using S = dqk::DqSplit<D, In>;
  using Op = typename Elem<In>::Op;
  constexpr bool kTma = Elem<In>::kTma;
  constexpr int kBlockM = 64 * kConsumers;    // q rows of the block
  constexpr int kColBlocks = D / 64;          // 64-column TMA boxes per row
  constexpr int kQBytes = kBlockM * D * 2;    // Q or dO
  constexpr int kKVBytes = kBlockN * D * 2;   // K or V of one stage
  // a stage's tiles: K, V (fp32: and what rounding V to bf16 left)
  constexpr int kStageTiles = kTma ? 2 : 3;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages], v_full[kStages],
      k_empty[kStages], v_empty[kStages];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + kQBytes;
  // fp32: what rounding dO to bf16 left, a tile of its own
  uint8_t* do_lo_s = do_s + kQBytes;
  uint8_t* kv_s = do_lo_s + (kTma ? 0 : kQBytes);  // the stages

  const int heads = Hq * B;
  const int n_qtiles = cdiv(T, kBlockM);
  const int rank = blockIdx.x / heads;  // heads inner: longest tiles first
  const int qtile = causal ? n_qtiles - 1 - rank : rank;
  const int h = (blockIdx.x % heads) % Hq, b = (blockIdx.x % heads) / Hq;
  const int q0 = qtile * kBlockM;
  const int n_tiles = cdiv(causal ? min(q0 + kBlockM, T) : T, kBlockN);

  if (threadIdx.x == 0) {
    // a TMA tile completes on one arrival (and its bytes), a converted one
    // on each producer thread's
    constexpr int kFillers = kTma ? 1 : 128;
    mbar_init(&q_full, kFillers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], kFillers);
      mbar_init(&v_full[s], kFillers);
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
    if constexpr (!kTma) {
      // fp32: the whole warpgroup converts each tile into its place
      const int tid = threadIdx.x, hk = h / rep;
      const float* k_rows = head_rows(src.ptr[1], src.stride[1], b, hk);
      const float* v_rows = head_rows(src.ptr[2], src.stride[2], b, hk);
      auto load = [&](int j, int which, uint64_t* full, uint64_t* empty) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* dst = kv_s + (kStageTiles * s + which) * kKVBytes;
        convert_rows<kBlockN, D>(dst, which ? v_rows : k_rows,
                                 src.stride[which + 1][1], j * kBlockN, T,
                                 d_true, tid,
                                 which ? dst + kKVBytes : nullptr);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      };
      convert_rows<kBlockM, D>(q_s, head_rows(src.ptr[0], src.stride[0], b, h),
                               src.stride[0][1], q0, T, d_true, tid);
      convert_rows<kBlockM, D>(do_s,
                               head_rows(src.ptr[3], src.stride[3], b, h),
                               src.stride[3][1], q0, T, d_true, tid,
                               do_lo_s);
      fence_proxy_async();
      mbar_arrive(&q_full);
      if constexpr (kStages == 1) {
        // one stage: K of the next tile can only follow this tile's V
        for (int j = 0; j < n_tiles; ++j) {
          load(j, 0, k_full, k_empty);
          load(j, 1, v_full, v_empty);
        }
      } else {
        load(0, 0, k_full, k_empty);
        for (int j = 0; j < n_tiles; ++j) {
          if (j + 1 < n_tiles) load(j + 1, 0, k_full, k_empty);
          load(j, 1, v_full, v_empty);
        }
      }
    } else if (threadIdx.x == 0) {
      const int hk = h / rep;
      // tile j's K or V into its stage, once the consumers have freed it
      auto load = [&](int j, int which, uint64_t* full, uint64_t* empty) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kKVBytes);
        uint8_t* dst = kv_s + (2 * s + which) * kKVBytes;
#pragma unroll
        for (int cb = 0; cb < kColBlocks; ++cb) {
          tma_load_4d(dst + cb * kBlockN * 128, which ? &tm_v : &tm_k,
                      &full[s], cb * 64, hk, j * kBlockN, b);
        }
      };
      mbar_arrive_expect_tx(&q_full, 2 * kQBytes);
#pragma unroll
      for (int cb = 0; cb < kColBlocks; ++cb) {
        tma_load_4d(q_s + cb * kBlockM * 128, &tm_q, &q_full, cb * 64, h, q0,
                    b);
        tma_load_4d(do_s + cb * kBlockM * 128, &tm_do, &q_full, cb * 64, h,
                    q0, b);
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

    // delta = rowsum(O o dO): the quad of a row takes its 8-column chunks
    // tg, tg + 4, ... in order, then sums the four partials
    // (butterfly; every lane ends with the same bits)
    mbar_wait(&q_full, 0);
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
          if constexpr (!kTma) {
            // fp32: O and dO as they lie in device memory (the dO tile
            // holds them rounded to bf16); a chunk the row's end cuts is
            // read element by element
            const float* do_row =
                head_rows(src.ptr[3], src.stride[3], b, h) +
                (int64_t)row * src.stride[3][1];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int col = 8 * ch + e;
              if (col < d_true) sum += o_row[col] * do_row[col];
            }
          } else {
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
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      dlt[r] = sum;
      if (tg == 0 && row < T) delta[((int64_t)b * Hq + h) * T + row] = sum;
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
      if constexpr (!kTma) {
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

      // dQ += dS K: the stage's keys are the contraction
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs_cols<D, Op>(acc, dsa[kk], k_addr + kk * 16 * 128,
                             kBlockN * 128);
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

// ------------------------------------------------------------------ dK/dV

namespace dkv {

constexpr int kKvRows = 64;   // kv rows of a block; both consumers own them
constexpr int kConsumerWarps = 8;
constexpr int kThreads = Split<2>::kThreads;  // producer + 2 consumers
constexpr int kLaunchRegs = Split<2>::kLaunchRegs;

// the register split: a producer that converts fp32 tiles keeps 40
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

template <int D, int kStages, typename In>
__global__ void __launch_bounds__(dkv::kThreads, 1)
    flash_bwd_dkv_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_do,
                         const Src src, const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         In* __restrict__ dk, In* __restrict__ dv,
                         float* __restrict__ part, int n_split, int T,
                         int Hq, int Hkv, int B, int rep, int d_true,
                         int64_t dk_sb, int64_t dk_st, int64_t dk_sh,
                         int64_t dv_sb, int64_t dv_st, int64_t dv_sh,
                         float scale, int causal) {
  using dkv::kConsumerWarps;
  using dkv::kKvRows;
  using sm90::desc_sw128;
  using sm90::mbar_arrive;
  using sm90::mbar_arrive_expect_tx;
  using sm90::mbar_wait;
  using sm90::smem_addr;
  using sm90::tma_load_4d;
  using S = dkv::DkvSplit<In>;
  using Op = typename Elem<In>::Op;
  constexpr bool kTma = Elem<In>::kTma;
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
  uint8_t* ring = v_s + (kTma ? 1 : 2) * kKvBytes;

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
    // TMA: one expect_tx arrival plus the 32 lanes that write lse, delta;
    // fp32: every producer thread (each converts and writes its share)
    sm90::mbar_init(&kv_full, kTma ? 1 : 128);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], kTma ? 1 + 32 : 128);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    sm90::setmaxnreg_dec<S::kProducerRegs>();
    // the threads that fill the ring: warp 0 (TMA), or all four (fp32)
    constexpr int kFillThreads = kTma ? 32 : 128;
    if (threadIdx.x < kFillThreads) {
      const int lane = threadIdx.x;
      if constexpr (!kTma) {
        sm90::convert_rows<kKvRows, D>(
            k_s, sm90::head_rows(src.ptr[1], src.stride[1], b, hk),
            src.stride[1][1], k0, T, d_true, lane);
        sm90::convert_rows<kKvRows, D>(
            v_s, sm90::head_rows(src.ptr[2], src.stride[2], b, hk),
            src.stride[2][1], k0, T, d_true, lane, v_s + kKvBytes);
        sm90::fence_proxy_async();
        mbar_arrive(&kv_full);
      } else if (lane == 0) {
        mbar_arrive_expect_tx(&kv_full, 2 * kKvBytes);
#pragma unroll
        for (int cb = 0; cb < kColBlocks; ++cb) {
          tma_load_4d(k_s + cb * kKvRows * 128, &tm_k, &kv_full, cb * 64, hk,
                      k0, b);
          tma_load_4d(v_s + cb * kKvRows * 128, &tm_v, &kv_full, cb * 64, hk,
                      k0, b);
        }
      }
      for (int i = 0; i < n_iter; ++i) {
        const int it = it0 + i;
        const int h = hk * rep + it / n_qs;
        const int qs0 = q_start + (it % n_qs) * kQRows;
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* stage = ring + s * kStageBytes;
        if constexpr (!kTma) {
          sm90::convert_rows<kQRows, D>(
              stage, sm90::head_rows(src.ptr[0], src.stride[0], b, h),
              src.stride[0][1], qs0, T, d_true, lane);
          sm90::convert_rows<kQRows, D>(
              stage + kTileBytes,
              sm90::head_rows(src.ptr[3], src.stride[3], b, h),
              src.stride[3][1], qs0, T, d_true, lane,
              stage + 2 * kTileBytes);
          sm90::fence_proxy_async();
        } else if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
#pragma unroll
          for (int cb = 0; cb < kColBlocks; ++cb) {
            tma_load_4d(stage + cb * kQRows * 128, &tm_q, &full[s], cb * 64,
                        h, qs0, b);
            tma_load_4d(stage + kTileBytes + cb * kQRows * 128, &tm_do,
                        &full[s], cb * 64, h, qs0, b);
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
          if constexpr (!kTma) {
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

template <int D, typename In>
constexpr int dq_smem_bytes() {  // + 1024: the tiles' 1024-byte alignment
  using Sh = dqk::Shape<D>;
  // Q and dO, and a stage's K and V; fp32 has dO's and V's rests too
  constexpr int kTiles = Elem<In>::kTma ? 2 : 3;
  return kTiles * 64 * Sh::kConsumers * D * 2 +
         dqk::stages<D, In>() * kTiles * Sh::kBlockN * D * 2 + 1024;
}

template <int D, typename In>
int dq_config(int* out) {
  using S = dqk::DqSplit<D, In>;
  static_assert(dq_smem_bytes<D, In>() <= 232448,
                "a block may use 227 KB of shared memory");
  out[0] = dq_smem_bytes<D, In>();
  out[1] = S::kThreads;
  out[2] = S::kLaunchRegs;
  out[3] = 64 * dqk::Shape<D>::kConsumers;
  return 0;
}

template <int D, typename In>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq, int B,
              int T, int Hq, int Hkv, int d_true, const long long* s,
              float scale, int causal, cudaStream_t stream) {
  using S = dqk::DqSplit<D, In>;
  constexpr int kBlockM = 64 * dqk::Shape<D>::kConsumers;
  constexpr int kBlockN = dqk::Shape<D>::kBlockN;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  Src src = {};
  int err = prepare_input<In>(&tm_q, &src, 0, q, B, T, Hq, d_true, s,
                              kBlockM);
  if (!err) err = prepare_input<In>(&tm_k, &src, 1, k, B, T, Hkv, d_true,
                                    s + 3, kBlockN);
  if (!err) err = prepare_input<In>(&tm_v, &src, 2, v, B, T, Hkv, d_true,
                                    s + 6, kBlockN);
  if (!err) err = prepare_input<In>(&tm_do, &src, 3, dout, B, T, Hq, d_true,
                                    s + 12, kBlockM);
  constexpr int kSmem = dq_smem_bytes<D, In>();
  auto kernel = flash_bwd_dq_kernel<D, In>;
  if (!err) err = prepare_launch(kernel, kSmem, S::kLaunchRegs);
  if (err) return err;
  const int grid = cdiv(T, kBlockM) * Hq * B;
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, src, static_cast<const In*>(o),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<In*>(dq), T, Hq, B, Hq / Hkv, d_true, s[9], s[10], s[11],
      s[15], s[16], s[17], scale, causal);
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

template <int D, int kStages, typename In>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               void* part, int n_split, int B, int T, int Hq, int Hkv,
               int d_true, const long long* s, float scale, int causal,
               cudaStream_t stream) {
  using dkv::kKvRows;
  constexpr int kQRows = dkv::Shape<D, In>::kQRows;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  Src src = {};
  int err = prepare_input<In>(&tm_q, &src, 0, q, B, T, Hq, d_true, s,
                              kQRows);
  if (!err) err = prepare_input<In>(&tm_k, &src, 1, k, B, T, Hkv, d_true,
                                    s + 3, kKvRows);
  if (!err) err = prepare_input<In>(&tm_v, &src, 2, v, B, T, Hkv, d_true,
                                    s + 6, kKvRows);
  if (!err) err = prepare_input<In>(&tm_do, &src, 3, dout, B, T, Hq, d_true,
                                    s + 9, kQRows);
  constexpr int kSmem = dkv_smem_bytes<D, kStages, In>();
  auto kernel = flash_bwd_dkv_kernel<D, kStages, In>;
  if (!err) err = sm90::prepare_launch(kernel, kSmem, dkv::kLaunchRegs);
  if (err) return err;
  // split: n_split blocks a (kv tile, kv head, batch)
  const int grid = cdiv(T, kKvRows) * Hkv * B * n_split;
  kernel<<<grid, dkv::kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, src, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<In*>(dk),
      static_cast<In*>(dv), static_cast<float*>(part), n_split, T, Hq, Hkv,
      B, Hq / Hkv, d_true, s[12], s[13], s[14], s[15], s[16], s[17], scale,
      causal);
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
// so each block owns one slab of kSlab output columns, the blocks of one
// row tile side by side on the grid (slabs innermost):
// - dQ: a (64-row q tile, q head, batch, slab) block, one consumer. Per
//   key tile, S = Q K^T and dP = dO V^T are summed over every column from
//   a ring of 64-column slices of Q, dO, K and V (fp32: and the rests of
//   dO and V, dP in three products as above); dQ += dS K reads the slab's
//   columns of K from a second ring. delta = rowsum(O o dO) over every
//   column comes from O and dO in device memory;
// - dK/dV: a (64-row kv tile, kv head, batch, slab) block, two consumers
//   that split the slab's columns (128 each, as at head_dim 256). Per
//   (q head of the group, 64 q rows), both compute S^T = K Q^T and dP^T =
//   V dO^T over every column from a ring of 64-column slices of K, V, Q
//   and dO; dV += P^T dO and dK += dS^T Q read the slab's columns of dO
//   and Q from a second ring whose stages also carry the rows of lse and
//   delta. The GQA group-sum stays in the accumulators: no atomics;
// - shared memory and registers are those of head_dim 256 whatever D is;
//   the price is S and dP computed once per slab (and in dK/dV by both
//   consumers), D / 256 times rounded up;
// - every slab computes the same P, dS and delta in the same order, so
//   they agree bitwise; the first slab writes delta;
// - only the column blocks inside the tensor are loaded (a slab tile's
//   others keep what shared memory held, which reaches only output
//   columns past the tensor's, never stored).
namespace wide {

constexpr int kSlab = 256;                 // output columns a block owns
constexpr int kTile = 64 * 128;            // 64 rows of 64 16-bit columns
constexpr int kSlabTile = 64 * kSlab * 2;  // 64 rows of the slab's columns

// a slice stage: Q, dO, K, V (dK/dV: K, V, Q, dO), and for fp32 the rests
// of dO and V (dK/dV: of V and dO)
template <typename In>
__host__ __device__ constexpr int slice_bytes() {
  return (Elem<In>::kTma ? 4 : 6) * kTile;
}
template <typename In>
__host__ __device__ constexpr int dq_slice_stages() {
  return Elem<In>::kTma ? 3 : 2;
}
constexpr int kDqKStages = 2;  // the slab's columns of K
template <typename In>
__host__ __device__ constexpr int dq_smem() {
  return dq_slice_stages<In>() * slice_bytes<In>() + kDqKStages * kSlabTile +
         1024;
}
template <typename In>
using DqSplit = Split<1, Elem<In>::kTma ? 24 : 40>;

constexpr int kDkvSliceStages = 2;
// a slab stage of dK/dV: the slab's columns of Q and of dO, then the 64
// rows of lse (log2 domain) and delta, padded to 1024 bytes
constexpr int kSlabStageBytes = 2 * kSlabTile + 1024;
template <typename In>
__host__ __device__ constexpr int dkv_slab_stages() {
  return Elem<In>::kTma ? 2 : 1;
}
template <typename In>
__host__ __device__ constexpr int dkv_smem() {
  return kDkvSliceStages * slice_bytes<In>() +
         dkv_slab_stages<In>() * kSlabStageBytes + 1024;
}

}  // namespace wide

template <typename In>
__global__ void __launch_bounds__(wide::DqSplit<In>::kThreads,
                                  wide::DqSplit<In>::kBlocksPerSm)
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
  constexpr int kStages = dq_slice_stages<In>();
  constexpr int kSliceBytes = slice_bytes<In>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t sl_full[kStages], sl_empty[kStages],
      k_full[kDqKStages], k_empty[kDqKStages];
  uint8_t* slices = align_1024(smem_raw);
  uint8_t* k_s = slices + kStages * kSliceBytes;

  const int n_cb = cdiv(d_true, 64);  // 64-column slices of a row
  const int n_slabs = cdiv(d_true, kSlab);
  const int heads = Hq * B;
  const int n_qtiles = cdiv(T, 64);
  // slabs innermost, then heads: longest tiles first
  const int slab = blockIdx.x % n_slabs, tile = blockIdx.x / n_slabs;
  const int rank = tile / heads;
  const int qtile = causal ? n_qtiles - 1 - rank : rank;
  const int h = (tile % heads) % Hq, b = (tile % heads) / Hq;
  const int q0 = qtile * 64, c0 = slab * kSlab;
  const int n_kcb = min(kSlab / 64, n_cb - c0 / 64);  // K boxes inside
  const int n_tiles = cdiv(causal ? min(q0 + 64, T) : T, 64);

  if (threadIdx.x == 0) {
    constexpr int kFillers = kTma ? 1 : 128;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sl_full[s], kFillers);
      mbar_init(&sl_empty[s], 4);
    }
    for (int s = 0; s < kDqKStages; ++s) {
      mbar_init(&k_full[s], kFillers);
      mbar_init(&k_empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<S::kProducerRegs>();
    const int hk = h / rep;
    // per key tile: the slab's columns of K first (their stage frees two
    // tiles earlier), then every slice of Q, dO, K and V
    if constexpr (!kTma) {
      const int tid = threadIdx.x;
      const float* q_rows = head_rows(src.ptr[0], src.stride[0], b, h);
      const float* k_rows = head_rows(src.ptr[1], src.stride[1], b, hk);
      const float* v_rows = head_rows(src.ptr[2], src.stride[2], b, hk);
      const float* do_rows = head_rows(src.ptr[3], src.stride[3], b, h);
      int it = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int ks = j % kDqKStages;
        mbar_wait(&k_empty[ks], ((j / kDqKStages) & 1) ^ 1);
        convert_rows<64, kSlab>(k_s + ks * kSlabTile, k_rows + c0,
                                src.stride[1][1], 64 * j, T, d_true - c0,
                                tid);
        fence_proxy_async();
        mbar_arrive(&k_full[ks]);
        for (int cb = 0; cb < n_cb; ++cb, ++it) {
          const int s = it % kStages;
          mbar_wait(&sl_empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* stage = slices + s * kSliceBytes;
          const int left = d_true - 64 * cb;
          convert_rows<64, 64>(stage, q_rows + 64 * cb, src.stride[0][1], q0,
                               T, left, tid);
          convert_rows<64, 64>(stage + kTile, do_rows + 64 * cb,
                               src.stride[3][1], q0, T, left, tid,
                               stage + 4 * kTile);
          convert_rows<64, 64>(stage + 2 * kTile, k_rows + 64 * cb,
                               src.stride[1][1], 64 * j, T, left, tid);
          convert_rows<64, 64>(stage + 3 * kTile, v_rows + 64 * cb,
                               src.stride[2][1], 64 * j, T, left, tid,
                               stage + 5 * kTile);
          fence_proxy_async();
          mbar_arrive(&sl_full[s]);
        }
      }
    } else if (threadIdx.x == 0) {
      int it = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int ks = j % kDqKStages;
        mbar_wait(&k_empty[ks], ((j / kDqKStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[ks], n_kcb * kTile);
        for (int cb = 0; cb < n_kcb; ++cb) {
          tma_load_4d(k_s + ks * kSlabTile + cb * kTile, &tm_k, &k_full[ks],
                      c0 + 64 * cb, hk, 64 * j, b);
        }
        for (int cb = 0; cb < n_cb; ++cb, ++it) {
          const int s = it % kStages;
          mbar_wait(&sl_empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&sl_full[s], 4 * kTile);
          uint8_t* stage = slices + s * kSliceBytes;
          tma_load_4d(stage, &tm_q, &sl_full[s], 64 * cb, h, q0, b);
          tma_load_4d(stage + kTile, &tm_do, &sl_full[s], 64 * cb, h, q0, b);
          tma_load_4d(stage + 2 * kTile, &tm_k, &sl_full[s], 64 * cb, hk,
                      64 * j, b);
          tma_load_4d(stage + 3 * kTile, &tm_v, &sl_full[s], 64 * cb, hk,
                      64 * j, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumer
    setmaxnreg_inc<S::kConsumerRegs>();
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, +8
    const float scale_log2 = scale * kLog2e;

    // lse in the log2 domain, and delta = rowsum(O o dO) over every
    // column: the quad of a row takes its 8-column chunks tg, tg + 4, ...
    // in order, then sums the four partials (every lane, every slab, the
    // same bits)
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < T ? lse[((int64_t)b * Hq + h) * T + row] * kLog2e : 0.f;
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
      dlt[r] = sum;
      if (slab == 0 && tg == 0 && row < T) {
        delta[((int64_t)b * Hq + h) * T + row] = sum;
      }
    }

    float acc[kSlab / 2];
#pragma unroll
    for (int i = 0; i < kSlab / 2; ++i) acc[i] = 0.f;

    int it = 0;
    for (int j = 0; j < n_tiles; ++j) {
      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, over the slices
      float sc[32], dp[32];
      for (int cb = 0; cb < n_cb; ++cb, ++it) {
        const int s = it % kStages;
        mbar_wait(&sl_full[s], (it / kStages) & 1);
        const uint32_t base = smem_addr(slices) + s * kSliceBytes;
        const uint32_t q_a = base, do_a = base + kTile;
        const uint32_t k_a = base + 2 * kTile, v_a = base + 3 * kTile;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_ss<64, Op>(sc, desc_sw128(q_a + 32 * ks, 16, 1024),
                           desc_sw128(k_a + 32 * ks, 16, 1024),
                           cb > 0 || ks > 0);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_ss<64, Op>(dp, desc_sw128(do_a + 32 * ks, 16, 1024),
                           desc_sw128(v_a + 32 * ks, 16, 1024),
                           cb > 0 || ks > 0);
        }
        if constexpr (!kTma) {
          // fp32: dP += dO_lo V_hi^T + dO_hi V_lo^T (the tiles' rests)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_ss<64, Op>(dp, desc_sw128(base + 4 * kTile + 32 * ks, 16,
                                            1024),
                             desc_sw128(v_a + 32 * ks, 16, 1024), 1);
            wgmma_ss<64, Op>(dp, desc_sw128(do_a + 32 * ks, 16, 1024),
                             desc_sw128(base + 5 * kTile + 32 * ks, 16,
                                        1024),
                             1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (lane == 0) mbar_arrive(&sl_empty[s]);  // this warp is done
      }

      // P and dS = P (dP - delta) scale; mask the ragged tail and the
      // diagonal
      const int k0 = 64 * j;
      const bool need_mask = k0 + 64 > T || (causal && k0 + 63 > q0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float p = exp2f(sc[e] * scale_log2 - lse2[(e >> 1) & 1]);
        if (need_mask) {
          const int col = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
          const int row = row0 + ((e >> 1) & 1) * 8;
          if (col >= T || (causal && col > row)) p = 0.f;
        }
        dp[e] = p * (dp[e] - dlt[(e >> 1) & 1]) * scale;
      }
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a<Op>(dsa[kk], dp, kk);

      // dQ += dS K over the slab's columns: the tile's keys are the
      // contraction
      const int ks = j % kDqKStages;
      mbar_wait(&k_full[ks], (j / kDqKStages) & 1);
      const uint32_t k_addr = smem_addr(k_s) + ks * kSlabTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_cols<kSlab, Op>(acc, dsa[kk], k_addr + kk * 16 * 128, kTile);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&k_empty[ks]);
    }

    // epilogue: the slab's columns of dQ, the real rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= T) continue;
      In* out = dq + b * dq_sb + h * dq_sh + (int64_t)row * dq_st;
#pragma unroll
      for (int jn = 0; jn < kSlab / 8; ++jn) {
        const int col = c0 + 8 * jn + 2 * tg;
        if (col < d_true) {
          store2(out + col, acc[4 * jn + 2 * r], acc[4 * jn + 2 * r + 1]);
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
      sb_full[kSlabStages], sb_empty[kSlabStages];
  uint8_t* slices = align_1024(smem_raw);  // stage: K, V, Q, dO (, rests)
  uint8_t* slabs = slices + kStages * kSliceBytes;

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
    // write lse and delta); fp32: every producer thread
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sl_full[s], kTma ? 1 : 128);
      mbar_init(&sl_empty[s], dkv::kConsumerWarps);
    }
    for (int s = 0; s < kSlabStages; ++s) {
      mbar_init(&sb_full[s], kTma ? 1 + 32 : 128);
      mbar_init(&sb_empty[s], dkv::kConsumerWarps);
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
        // the slab stage first (the consumers read it after the slices)
        const int bs = it % kSlabStages;
        mbar_wait(&sb_empty[bs], ((it / kSlabStages) & 1) ^ 1);
        uint8_t* stage = slabs + bs * kSlabStageBytes;
        if constexpr (!kTma) {
          convert_rows<64, kSlab>(
              stage, head_rows(src.ptr[0], src.stride[0], b, h) + c0,
              src.stride[0][1], qs0, T, d_true - c0, lane);
          convert_rows<64, kSlab>(
              stage + kSlabTile,
              head_rows(src.ptr[3], src.stride[3], b, h) + c0,
              src.stride[3][1], qs0, T, d_true - c0, lane);
          fence_proxy_async();
        } else if (lane == 0) {
          mbar_arrive_expect_tx(&sb_full[bs], 2 * n_scb * kTile);
          for (int cb = 0; cb < n_scb; ++cb) {
            tma_load_4d(stage + cb * kTile, &tm_q, &sb_full[bs],
                        c0 + 64 * cb, h, qs0, b);
            tma_load_4d(stage + kSlabTile + cb * kTile, &tm_do, &sb_full[bs],
                        c0 + 64 * cb, h, qs0, b);
          }
        }
        float* lse_s = reinterpret_cast<float*>(stage + 2 * kSlabTile);
        const int64_t row = ((int64_t)b * Hq + h) * T;
        for (int i = lane; i < 64; i += kFillThreads) {
          const int t = qs0 + i;
          lse_s[i] = t < T ? lse[row + t] * kLog2e : 0.f;
          lse_s[64 + i] = t < T ? delta[row + t] : 0.f;
        }
        mbar_arrive(&sb_full[bs]);  // release: this lane's rows are visible

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
    const int c = wg - 1;
    const int col0 = c0 + 128 * c;  // this consumer's 128 columns
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int key0 = k0 + 16 * w + g;  // this thread's keys: key0, key0 + 8
    const float scale_log2 = scale * kLog2e;

    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    int sit = 0;
    for (int it = 0; it < n_iter; ++it) {
      const int jq = it % n_qs;
      const int wq0 = q_start + 64 * jq;  // the step's first q row
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, over the
      // slices
      float st[32], dpt[32];
      for (int cb = 0; cb < n_cb; ++cb, ++sit) {
        const int s = sit % kStages;
        mbar_wait(&sl_full[s], (sit / kStages) & 1);
        const uint32_t base = smem_addr(slices) + s * kSliceBytes;
        const uint32_t k_a = base, v_a = base + kTile;
        const uint32_t q_a = base + 2 * kTile, do_a = base + 3 * kTile;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_ss<64, Op>(st, desc_sw128(k_a + 32 * ks, 16, 1024),
                           desc_sw128(q_a + 32 * ks, 16, 1024),
                           cb > 0 || ks > 0);
          wgmma_ss<64, Op>(dpt, desc_sw128(v_a + 32 * ks, 16, 1024),
                           desc_sw128(do_a + 32 * ks, 16, 1024),
                           cb > 0 || ks > 0);
          if constexpr (!kTma) {
            // fp32: dP^T also takes V_hi dO_lo^T + V_lo dO_hi^T
            wgmma_ss<64, Op>(dpt, desc_sw128(v_a + 32 * ks, 16, 1024),
                             desc_sw128(base + 5 * kTile + 32 * ks, 16,
                                        1024),
                             1);
            wgmma_ss<64, Op>(dpt, desc_sw128(base + 4 * kTile + 32 * ks, 16,
                                             1024),
                             desc_sw128(do_a + 32 * ks, 16, 1024), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (lane == 0) mbar_arrive(&sl_empty[s]);  // this warp is done
      }

      // P^T and dS^T; mask the ragged tail and, on the diagonal, the
      // queries before each key (keys past T are never stored)
      const int bs = it % kSlabStages;
      mbar_wait(&sb_full[bs], (it / kSlabStages) & 1);
      uint8_t* stage = slabs + bs * kSlabStageBytes;
      const float* lse_s = reinterpret_cast<const float*>(stage +
                                                          2 * kSlabTile);
      const float* dlt_s = lse_s + 64;
      const bool need_mask = wq0 + 64 > T || (causal && jq == 0);
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
        pack_a<Op>(pa[kk], st, kk);
        pack_a<Op>(dsa[kk], dpt, kk);
      }

      // dV += P^T dO and dK += dS^T Q over this consumer's columns of the
      // slab: the 64 queries are the contraction
      const uint32_t q_slab = smem_addr(stage) + 2 * c * kTile;
      const uint32_t do_slab = q_slab + kSlabTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t rows = kk * 16 * 128;
        wgmma_rs<128, Op>(dv_acc, pa[kk],
                          desc_sw128(do_slab + rows, kTile, 1024));
        wgmma_rs<128, Op>(dk_acc, dsa[kk],
                          desc_sw128(q_slab + rows, kTile, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (lane == 0) mbar_arrive(&sb_empty[bs]);
    }

    // epilogue: this consumer's columns of the key rows it holds
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= T) continue;
      In* dk_row = dk + b * dk_sb + hk * dk_sh + (int64_t)key * dk_st;
      In* dv_row = dv + b * dv_sb + hk * dv_sh + (int64_t)key * dv_st;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = col0 + 8 * jn + 2 * tg;
        if (col >= d_true) continue;
        store2(dk_row + col, dk_acc[4 * jn + 2 * r],
               dk_acc[4 * jn + 2 * r + 1]);
        store2(dv_row + col, dv_acc[4 * jn + 2 * r],
               dv_acc[4 * jn + 2 * r + 1]);
      }
    }
  }
}

template <typename In>
int dq_config_wide(int* out) {
  static_assert(wide::dq_smem<In>() <= 232448,
                "a block may use 227 KB of shared memory");
  out[0] = wide::dq_smem<In>();
  out[1] = wide::DqSplit<In>::kThreads;
  out[2] = wide::DqSplit<In>::kLaunchRegs;
  out[3] = 64;
  return 0;
}

template <typename In>
int dkv_config_wide(int* out) {
  static_assert(wide::dkv_smem<In>() <= 232448,
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
  const int grid = cdiv(T, 64) * Hq * B * cdiv(d_true, wide::kSlab);
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
  if (D <= 64) {
    return launch_dq<64, In>(q, k, v, o, dout, lse, delta, dq, B, T, Hq, Hkv,
                             D, s, scale, causal, st);
  }
  if (D <= 128) {
    return launch_dq<128, In>(q, k, v, o, dout, lse, delta, dq, B, T, Hq,
                              Hkv, D, s, scale, causal, st);
  }
  return launch_dq<256, In>(q, k, v, o, dout, lse, delta, dq, B, T, Hq, Hkv,
                            D, s, scale, causal, st);
}

template <typename In>
int launch_dkv_for(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, void* part, int n_split, int B, int T,
                   int Hq, int Hkv, int D, const long long* s, float scale,
                   int causal, cudaStream_t st) {
  if (D > wide::kSlab) {
    return launch_dkv_wide<In>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq,
                               Hkv, D, s, scale, causal, st);
  }
  if (D <= 64) {
    return launch_dkv<64, dkv_stages<In>(64), In>(
        q, k, v, dout, lse, delta, dk, dv, nullptr, 1, B, T, Hq, Hkv, D, s,
        scale, causal, st);
  }
  if (D <= 128) {
    return launch_dkv<128, dkv_stages<In>(128), In>(
        q, k, v, dout, lse, delta, dk, dv, nullptr, 1, B, T, Hq, Hkv, D, s,
        scale, causal, st);
  }
  return launch_dkv<256, dkv_stages<In>(256), In>(
      q, k, v, dout, lse, delta, dk, dv, part, n_split, B, T, Hq, Hkv, D, s,
      scale, causal, st);
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
  if (D > wide::kSlab) return dkv_config_wide<In>(out);
  return D <= 64    ? dkv_config<64, dkv_stages<In>(64), In>(out)
         : D <= 128 ? dkv_config<128, dkv_stages<In>(128), In>(out)
                    : dkv_config<256, dkv_stages<In>(256), In>(out);
}

bool bad_shape(int B, int T, int Hq, int Hkv) {
  return B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0;
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
// n_split is 1). Launches on `stream` (the kernel and, split, the
// reduction); returns 0 on success, else a cudaError_t or one of the
// codes that flash_attention_error_string names.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            void* part, int B, int T, int Hq, int Hkv, int D,
                            int d_head, int n_split, int dtype,
                            const long long* strides, int causal,
                            void* stream) {
  if (bad_shape(B, T, Hq, Hkv) || dtype != FLASH_DTYPE ||
      bad_head_dim(D, d_head, dtype) || n_split < 1 || n_split > 64 ||
      (n_split > 1 && (D <= 128 || D > wide::kSlab || part == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale = 1.f / sqrtf(static_cast<float>(d_head));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_dkv_for<Built>(q, k, v, dout, lse, delta, dk, dv, part,
                               n_split, B, T, Hq, Hkv, D, strides, scale,
                               causal, st);
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

const char* flash_attention_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"

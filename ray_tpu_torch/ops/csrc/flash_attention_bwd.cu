// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, bf16 in,
// fp32 accumulate.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// ray_tpu/ops/flash_attention.py (launched by `_bwd`). Both recompute the
// probabilities from the forward's row logsumexp instead of storing them:
//   P  = exp(S * scale - lse),   S = Q K^T
//   dP = dO V^T,   dS = P o (dP - delta) * scale,   delta = rowsum(O o dO)
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO.
// lse is in natural-log units (as the forward stores it); the kernels
// move it into the log2 domain once per row and use exp2f, so P is
// exp(S * scale - lse) exactly as in the plain version. delta comes in
// precomputed (the wrapper takes it in plain torch, as the JAX package
// takes it in jnp outside its kernels).
//
// What bounds them on this card: operations. dQ does three products per
// unmasked (query, key) pair (S, dP, dS K), 6 * D flops; dK/dV four
// (S^T, dP^T, P^T dO, dS^T Q), 8 * D flops, against a few bytes per row
// of each input. Both keep the T x T matrices out of device memory.
//
// dQ (mma.sync m16n8k16, flash_attention_common.cuh): one block of 4
// warps per (64-row q tile, q head, batch); each warp holds its 16 rows
// of Q and dO as mma A fragments and walks the K/V tiles of kv head
// h / rep, staged through shared memory, up to the diagonal when causal.
//
// dK/dV (wgmma fed by TMA, flash_attention_sm90.cuh):
// - one block per (64-row kv tile, kv head, batch), 384 threads: a
//   producer warpgroup and two consumer warpgroups; setmaxnreg moves
//   registers from the producer (24) to the consumers (240);
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
// - built for head_dim 64 and 128; a narrower head_dim is read through
//   TMA maps of its true width (missing columns arrive as zeros), scaled
//   by 1/sqrt(true head_dim) and stored at its true width.
//
// Both kernels mask the causal diagonal and the ragged tail (positions
// >= T), so any T >= 1 runs on them; inputs are read through their
// [B, T, H, D] strides; no atomics and no split over the reduced axis
// across blocks, so results are bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using flash::kThreads;
using flash::kTile;
using flash::load_a_frags;
using flash::load_tile;
using flash::mma_rows;
using flash::mma_rows_t;
using flash::pack_bf16;
using flash::store_rows;

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int T, int Hq, int rep,
                        int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
                        int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                        int64_t v_sh, int64_t do_sb, int64_t do_st,
                        int64_t do_sh, int64_t dq_sb, int64_t dq_st,
                        int64_t dq_sh, float scale, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * kLd];

  // causal: the longest rows (last q tiles) are scheduled first
  const int qtile = causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = qtile * kTile;

  const __nv_bfloat16* k_head = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* v_head = v + b * v_sb + hk * v_sh;

  // Q and dO tiles -> registers as A fragments, staged through k_s, v_s
  load_tile<D>(k_s, q + b * q_sb + h * q_sh, q_st, q0, T, tid);
  load_tile<D>(v_s, dout + b * do_sb + h * do_sh, do_st, q0, T, tid);
  __syncthreads();
  uint32_t qf[kKSteps][4], dof[kKSteps][4];
  load_a_frags<D>(qf, k_s + warp * 16 * kLd, lane);
  load_a_frags<D>(dof, v_s + warp * 16 * kLd, lane);

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const int64_t at = ((int64_t)b * Hq + h) * T + row;
    lse2[r] = row < T ? lse[at] * kLog2e : 0.f;
    dlt[r] = row < T ? delta[at] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  const int n_tiles = causal ? qtile + 1 : (T + kTile - 1) / kTile;
  const unsigned short* k_bits = reinterpret_cast<const unsigned short*>(k_s);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(k_s, k_head, k_st, k0, T, tid);
    load_tile<D>(v_s, v_head, v_st, k0, T, tid);
    __syncthreads();
    const bool need_mask =
        (k0 + kTile > T) || (q0 + kTile > T) || (causal && j == qtile);

    // 16 keys at a time: S and dP for two n8 tiles, then dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int nt = 2 * kk + n;
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        mma_rows_t<D>(s[n], qf, k_s + nt * 8 * kLd, lane);
        mma_rows_t<D>(dp[n], dof, v_s + nt * 8 * kLd, lane);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[n][e] * scale_log2 - lse2[e >> 1]);
          if (need_mask) {
            const int col = k0 + (2 * kk + n) * 8 + tg * 2 + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            if (col >= T || row >= T || (causal && col > row)) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - dlt[e >> 1]) * scale;  // dS
        }
      }
      uint32_t da[4];
      da[0] = pack_bf16(s[0][0], s[0][1]);
      da[1] = pack_bf16(s[0][2], s[0][3]);
      da[2] = pack_bf16(s[1][0], s[1][1]);
      da[3] = pack_bf16(s[1][2], s[1][3]);
      mma_rows<D>(acc, da, k_bits, kk * 16, lane);
    }
  }

  store_rows<D>(acc, dq + b * dq_sb + h * dq_sh, dq_st, row0, T, lane);
}

// ------------------------------------------------------------------ dK/dV

namespace dkv {

constexpr int kKvRows = 64;   // kv rows of a block; both consumers own them
constexpr int kQRows = 128;   // q rows of a stage: 64 for each consumer
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
// setmaxnreg split, as in the forward: 384 threads launched at 168
// registers = 128 * 24 + 256 * 240
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace dkv

template <int D, int kStages>
__global__ void __launch_bounds__(dkv::kThreads, 1)
    flash_bwd_dkv_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int T, int Hq,
                         int Hkv, int B, int rep, int d_true, int64_t dk_sb,
                         int64_t dk_st, int64_t dk_sh, int64_t dv_sb,
                         int64_t dv_st, int64_t dv_sh, float scale,
                         int causal) {
  using dkv::cdiv;
  using dkv::kConsumerRegs;
  using dkv::kConsumerWarps;
  using dkv::kKvRows;
  using dkv::kProducerRegs;
  using dkv::kQRows;
  using sm90::desc_sw128;
  using sm90::mbar_arrive;
  using sm90::mbar_arrive_expect_tx;
  using sm90::mbar_wait;
  using sm90::smem_addr;
  using sm90::tma_load_4d;
  constexpr int kColBlocks = D / 64;           // 64-column TMA boxes per row
  constexpr int kKvBytes = kKvRows * D * 2;    // K or V
  constexpr int kTileBytes = kQRows * D * 2;   // Q or dO of a stage
  // a stage: Q, dO, then the stage's rows of lse (log2 domain) and delta
  constexpr int kStageBytes = 2 * kTileBytes + 2 * kQRows * 4;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* k_s = sm90::align_1024(smem_raw);
  uint8_t* v_s = k_s + kKvBytes;
  uint8_t* ring = v_s + kKvBytes;

  // causal: kv tile 0 sees every q row, so low tiles are the longest;
  // heads inner, so the longest tiles of every head are scheduled first
  const int heads = Hkv * B;
  const int kvtile = blockIdx.x / heads;
  const int hk = (blockIdx.x % heads) % Hkv, b = (blockIdx.x % heads) / Hkv;
  const int k0 = kvtile * kKvRows;
  // the stages of one q head start at the diagonal when causal
  const int q_start = causal ? k0 : 0;
  const int n_qs = cdiv(T - q_start, kQRows);
  const int n_iter = rep * n_qs;  // (q head, stage) pairs, head-major

  if (threadIdx.x == 0) {
    sm90::mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's expect_tx plus the 32 lanes that write lse, delta
      sm90::mbar_init(&full[s], 1 + 32);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(&kv_full, 2 * kKvBytes);
#pragma unroll
        for (int cb = 0; cb < kColBlocks; ++cb) {
          tma_load_4d(k_s + cb * kKvRows * 128, &tm_k, &kv_full, cb * 64, hk,
                      k0, b);
          tma_load_4d(v_s + cb * kKvRows * 128, &tm_v, &kv_full, cb * 64, hk,
                      k0, b);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int h = hk * rep + it / n_qs;
        const int qs0 = q_start + (it % n_qs) * kQRows;
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* stage = ring + s * kStageBytes;
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
#pragma unroll
          for (int cb = 0; cb < kColBlocks; ++cb) {
            tma_load_4d(stage + cb * kQRows * 128, &tm_q, &full[s], cb * 64,
                        h, qs0, b);
            tma_load_4d(stage + kTileBytes + cb * kQRows * 128, &tm_do,
                        &full[s], cb * 64, h, qs0, b);
          }
        }
        float* lse_s = reinterpret_cast<float*>(stage + 2 * kTileBytes);
        const int64_t row = ((int64_t)b * Hq + h) * T;
        for (int i = lane; i < kQRows; i += 32) {
          const int t = qs0 + i;
          lse_s[i] = t < T ? lse[row + t] * kLog2e : 0.f;
          lse_s[kQRows + i] = t < T ? delta[row + t] : 0.f;
        }
        mbar_arrive(&full[s]);  // release: this lane's rows are visible
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;  // q rows 64c .. 64c + 63 of every stage
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int key0 = k0 + 16 * w + g;  // this thread's keys: key0, key0 + 8
    const float scale_log2 = scale * 1.4426950408889634f;
    const uint32_t k_addr = smem_addr(k_s), v_addr = smem_addr(v_s);

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(&kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int jq = it % n_qs;
      const int wq0 = q_start + jq * kQRows + 64 * c;  // this warpgroup's
      const int s = it % kStages;                      // first q row
      uint8_t* stage = ring + s * kStageBytes;
      const uint32_t q_addr = smem_addr(stage) + c * 64 * 128;
      const uint32_t do_addr = q_addr + kTileBytes;
      const float* lse_s =
          reinterpret_cast<const float*>(stage + 2 * kTileBytes) + 64 * c;
      const float* dlt_s = lse_s + kQRows;
      mbar_wait(&full[s], (it / kStages) & 1);

      if (wq0 < T) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
        float st[32], dpt[32];
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t col = (ks % 4) * 32;  // bytes into the column block
          const uint32_t a_off = (ks / 4) * kKvRows * 128 + col;
          const uint32_t b_off = (ks / 4) * kQRows * 128 + col;
          sm90::wgmma_ss<64>(st, desc_sw128(k_addr + a_off, 16, 1024),
                             desc_sw128(q_addr + b_off, 16, 1024), ks > 0);
          sm90::wgmma_ss<64>(dpt, desc_sw128(v_addr + a_off, 16, 1024),
                             desc_sw128(do_addr + b_off, 16, 1024), ks > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);

        // P^T and dS^T; mask the ragged tail and, on the diagonal, the
        // queries before each key (keys past T are never stored)
        const bool need_mask =
            wq0 + 64 > T || (causal && jq == 0 && c == 0);
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
          sm90::pack_a(pa[kk], st, kk);
          sm90::pack_a(dsa[kk], dpt, kk);
        }

        // dV += P^T dO and dK += dS^T Q: the 64 queries are the contraction
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t rows = kk * 16 * 128;
          sm90::wgmma_rs<D>(dv_acc, pa[kk],
                            desc_sw128(do_addr + rows, kQRows * 128, 1024));
          sm90::wgmma_rs<D>(dk_acc, dsa[kk],
                            desc_sw128(q_addr + rows, kQRows * 128, 1024));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
      }
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
    }

    // the two consumers' partial sums meet in shared memory (the ring is
    // idle now): the second writes, the first adds in a fixed order
    float* red = reinterpret_cast<float*>(ring);
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
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= T) continue;
        __nv_bfloat16* dk_row = dk + b * dk_sb + hk * dk_sh + key * dk_st;
        __nv_bfloat16* dv_row = dv + b * dv_sb + hk * dv_sh + key * dv_st;
#pragma unroll
        for (int jn = 0; jn < D / 8; ++jn) {
          const int col = 8 * jn + 2 * tg;
          if (col >= d_true) continue;
          const int i0 = 4 * jn + 2 * r, i1 = i0 + 1;
          *reinterpret_cast<__nv_bfloat162*>(dk_row + col) =
              __floats2bfloat162_rn(dk_acc[i0] + red[i0 * 128 + t],
                                    dk_acc[i1] + red[i1 * 128 + t]);
          *reinterpret_cast<__nv_bfloat162*>(dv_row + col) =
              __floats2bfloat162_rn(
                  dv_acc[i0] + red[(D / 2 + i0) * 128 + t],
                  dv_acc[i1] + red[(D / 2 + i1) * 128 + t]);
        }
      }
    }
  }
}

using bf16 = __nv_bfloat16;

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int T,
              int Hq, int Hkv, const long long* s, float scale, int causal,
              cudaStream_t stream) {
  const dim3 grid((T + kTile - 1) / kTile, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), T, Hq, Hq / Hkv, s[0], s[1], s[2], s[3], s[4],
      s[5], s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14], scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kStages>
constexpr int dkv_smem_bytes() {  // + 1024: the tiles' 1024-byte alignment
  return 2 * dkv::kKvRows * D * 2 +
         kStages * (2 * dkv::kQRows * D * 2 + 2 * dkv::kQRows * 4) + 1024;
}

template <int D, int kStages>
int dkv_config(int* out) {
  out[0] = dkv_smem_bytes<D, kStages>();
  out[1] = dkv::kThreads;
  out[2] = dkv::kLaunchRegs;
  out[3] = dkv::kKvRows;
  return 0;
}

template <int D, int kStages>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int T, int Hq, int Hkv, int d_true, const long long* s,
               float scale, int causal, cudaStream_t stream) {
  using dkv::kKvRows;
  using dkv::kQRows;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = sm90::encode_rows(&tm_q, q, B, T, Hq, d_true, s[0], s[1], s[2],
                              kQRows);
  if (!err) err = sm90::encode_rows(&tm_k, k, B, T, Hkv, d_true, s[3], s[4],
                                    s[5], kKvRows);
  if (!err) err = sm90::encode_rows(&tm_v, v, B, T, Hkv, d_true, s[6], s[7],
                                    s[8], kKvRows);
  if (!err) err = sm90::encode_rows(&tm_do, dout, B, T, Hq, d_true, s[9],
                                    s[10], s[11], kQRows);
  constexpr int kSmem = dkv_smem_bytes<D, kStages>();
  auto kernel = flash_bwd_dkv_kernel<D, kStages>;
  if (!err) err = sm90::prepare_launch(kernel, kSmem, dkv::kLaunchRegs);
  if (err) return err;
  const int grid = dkv::cdiv(T, kKvRows) * Hkv * B;
  kernel<<<grid, dkv::kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, Hq, Hkv, B, Hq / Hkv, d_true, s[12], s[13],
      s[14], s[15], s[16], s[17], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int T, int Hq, int Hkv) {
  return B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0;
}

}  // namespace

extern "C" {

// q, dout, dq: [B, T, Hq, D] bf16; k, v: [B, T, Hkv, D] bf16; lse and
// delta: [B, Hq, T] fp32 contiguous (lse in natural-log units). strides:
// 15 element strides (batch, time, head) of q, k, v, dout and dq in that
// order; the head_dim stride is 1 and every stride is a multiple of 8.
// Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).
int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int T,
                                int Hq, int Hkv, int D,
                                const long long* strides, int causal,
                                void* stream) {
  if (bad_shape(B, T, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, strides, scale, causal, st);
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, strides, scale, causal, st);
    case 48: return launch_dq<48>(q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, strides, scale, causal, st);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, strides, scale, causal, st);
    case 80: return launch_dq<80>(q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, strides, scale, causal, st);
    case 96: return launch_dq<96>(q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, strides, scale, causal, st);
    case 112: return launch_dq<112>(q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, strides, scale, causal, st);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, strides, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above, writing dk and dv [B, T, Hkv, D] bf16 (summed over the rep
// q heads of each kv head). strides: 18 element strides (batch, time,
// head) of q, k, v, dout, dk and dv in that order; every base is 16-byte
// aligned (TMA). Returns 0 on success, else a cudaError_t or one of the
// codes that flash_attention_error_string names.
int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int T, int Hq, int Hkv, int D,
                                 const long long* strides, int causal,
                                 void* stream) {
  if (bad_shape(B, T, Hq, Hkv) || D < 16 || D > 128 || D % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) {
    return launch_dkv<64, 3>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                             D, strides, scale, causal, st);
  }
  return launch_dkv<128, 2>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv,
                            D, strides, scale, causal, st);
}

// The launch shape of the dK/dV kernel that head_dim D runs on: out[0]
// bytes of dynamic shared memory, out[1] threads a block, out[2]
// registers a thread at launch, out[3] kv rows a block. Returns 0, or
// cudaErrorInvalidValue for a D the kernel does not take.
int flash_attention_bwd_dkv_config(int D, int* out) {
  if (D < 16 || D > 128 || D % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return D <= 64 ? dkv_config<64, 3>(out) : dkv_config<128, 2>(out);
}

const char* flash_attention_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"

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
// of each input. The design keeps the T x T matrices out of device memory
// (registers, 16 columns at a time) and feeds the tensor cores through
// mma.sync m16n8k16 bf16 -> fp32.
//
// Design (simple and exact first; wgmma, TMA and pipelined loads are
// later work):
// - dQ: one block of 4 warps per (64-row q tile, q head, batch); each
//   warp holds its 16 rows of Q and dO as mma A fragments and walks the
//   K/V tiles of kv head h / rep up to the diagonal when causal;
// - dK/dV: one block per (64-row kv tile, kv head, batch); each warp
//   holds its 16 rows of K and V as A fragments and computes the
//   transposed scores S^T = K Q^T directly, so dV += P^T dO and
//   dK += dS^T Q are the same A-from-accumulators product as the
//   forward's P V. The block loops over the rep q heads of its kv head
//   and over the q tiles from the diagonal on: the GQA group-sum happens
//   in the fp32 accumulators, with no per-q-head buffers and no atomics;
// - dS and P are rounded to bf16 only as A operands;
// - the causal diagonal and the ragged tail (positions >= T, rows and
//   columns) are masked here, so any T >= 1 runs on the kernels;
// - inputs are read through their [B, T, H, D] strides; no atomics and
//   no split over the reduced axis, so results are bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int T, int Hq,
                         int rep, int64_t q_sb, int64_t q_st, int64_t q_sh,
                         int64_t k_sb, int64_t k_st, int64_t k_sh,
                         int64_t v_sb, int64_t v_st, int64_t v_sh,
                         int64_t do_sb, int64_t do_st, int64_t do_sh,
                         int64_t dk_sb, int64_t dk_st, int64_t dk_sh,
                         int64_t dv_sb, int64_t dv_st, int64_t dv_sh,
                         float scale, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  __shared__ __align__(16) __nv_bfloat16 q_s[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 do_s[kTile * kLd];
  __shared__ float lse_s[kTile];  // log2 domain
  __shared__ float dlt_s[kTile];

  // causal: kv tile 0 sees every q tile, so low tiles are the longest
  // and are scheduled first
  const int kvtile = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int k0 = kvtile * kTile;

  // K and V tiles -> registers as A fragments, staged through q_s, do_s
  load_tile<D>(q_s, k + b * k_sb + hk * k_sh, k_st, k0, T, tid);
  load_tile<D>(do_s, v + b * v_sb + hk * v_sh, v_st, k0, T, tid);
  __syncthreads();
  uint32_t kf[kKSteps][4], vf[kKSteps][4];
  load_a_frags<D>(kf, q_s + warp * 16 * kLd, lane);
  load_a_frags<D>(vf, do_s + warp * 16 * kLd, lane);

  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const int warp_key0 = k0 + warp * 16;
  const float scale_log2 = scale * kLog2e;
  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  }
  const int n_q = (T + kTile - 1) / kTile;
  const unsigned short* q_bits = reinterpret_cast<const unsigned short*>(q_s);
  const unsigned short* do_bits =
      reinterpret_cast<const unsigned short*>(do_s);

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const __nv_bfloat16* q_head = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* do_head = dout + b * do_sb + h * do_sh;
    const float* lse_row = lse + ((int64_t)b * Hq + h) * T;
    const float* dlt_row = delta + ((int64_t)b * Hq + h) * T;
    for (int i = causal ? kvtile : 0; i < n_q; ++i) {
      const int q0 = i * kTile;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D>(q_s, q_head, q_st, q0, T, tid);
      load_tile<D>(do_s, do_head, do_st, q0, T, tid);
      if (tid < kTile) {
        const int t = q0 + tid;
        lse_s[tid] = t < T ? lse_row[t] * kLog2e : 0.f;
        dlt_s[tid] = t < T ? dlt_row[t] : 0.f;
      }
      __syncthreads();
      const bool need_mask =
          (q0 + kTile > T) || (k0 + kTile > T) || (causal && i == kvtile);

      // 16 queries at a time: S^T and dP^T for two n8 tiles, then
      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int c = 0; c < kTile / 16; ++c) {
        // causal: queries wholly before this warp's keys see none of them
        if (causal && q0 + c * 16 + 15 < warp_key0) continue;
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
          dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
          mma_rows_t<D>(st[n], kf, q_s + (c * 16 + n * 8) * kLd, lane);
          mma_rows_t<D>(dpt[n], vf, do_s + (c * 16 + n * 8) * kLd, lane);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c * 16 + n * 8 + tg * 2 + (e & 1);  // in tile
            float p = exp2f(st[n][e] * scale_log2 - lse_s[qi]);
            if (need_mask) {
              const int col = q0 + qi;
              const int key = key0 + (e >> 1) * 8;
              if (col >= T || key >= T || (causal && col < key)) p = 0.f;
            }
            st[n][e] = p;                                       // P^T
            dpt[n][e] = p * (dpt[n][e] - dlt_s[qi]) * scale;    // dS^T
          }
        }
        uint32_t pa[4], dsa[4];
        pa[0] = pack_bf16(st[0][0], st[0][1]);
        pa[1] = pack_bf16(st[0][2], st[0][3]);
        pa[2] = pack_bf16(st[1][0], st[1][1]);
        pa[3] = pack_bf16(st[1][2], st[1][3]);
        dsa[0] = pack_bf16(dpt[0][0], dpt[0][1]);
        dsa[1] = pack_bf16(dpt[0][2], dpt[0][3]);
        dsa[2] = pack_bf16(dpt[1][0], dpt[1][1]);
        dsa[3] = pack_bf16(dpt[1][2], dpt[1][3]);
        mma_rows<D>(dv_acc, pa, do_bits, c * 16, lane);
        mma_rows<D>(dk_acc, dsa, q_bits, c * 16, lane);
      }
    }
  }

  store_rows<D>(dk_acc, dk + b * dk_sb + hk * dk_sh, dk_st, key0, T, lane);
  store_rows<D>(dv_acc, dv + b * dv_sb + hk * dv_sh, dv_st, key0, T, lane);
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

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int T, int Hq, int Hkv, const long long* s, float scale,
               int causal, cudaStream_t stream) {
  const dim3 grid((T + kTile - 1) / kTile, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq, Hq / Hkv, s[0],
      s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      s[12], s[13], s[14], s[15], s[16], s[17], scale, causal);
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
// head) of q, k, v, dout, dk and dv in that order.
int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int T, int Hq, int Hkv, int D,
                                 const long long* strides, int causal,
                                 void* stream) {
  if (bad_shape(B, T, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, strides, scale, causal, st);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, strides, scale, causal, st);
    case 48: return launch_dkv<48>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, strides, scale, causal, st);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, strides, scale, causal, st);
    case 80: return launch_dkv<80>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, strides, scale, causal, st);
    case 96: return launch_dkv<96>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, strides, scale, causal, st);
    case 112: return launch_dkv<112>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, strides, scale, causal, st);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, strides, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

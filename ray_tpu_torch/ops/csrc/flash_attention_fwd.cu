// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel `_fwd_kernel` in ray_tpu/ops/flash_attention.py
// (launched by `_fwd`): causal or full attention with an online softmax,
// GQA through kv head h / (Hq / Hkv), and O plus the row logsumexp
// lse = m + log(l) as outputs (the backward kernels read lse).
//
// What bounds it on this card: at the prefill shapes of the serving path
// (T in the hundreds to thousands, head_dim 128) the two matrix products
// per tile make it operation-bound: 4 * D flops per (query, key) pair
// against 2 * D bytes per row of Q, K, V and O. The design keeps the
// T x T scores out of device memory (they live in registers, tile by
// tile) and feeds the tensor cores through mma.sync m16n8k16 bf16 -> fp32.
//
// Design (simple and exact first; wgmma, TMA and a pipelined K/V ring
// are later work):
// - one block of 4 warps per (q tile of 64 rows, q head, batch); each
//   warp owns 16 query rows, held in registers as mma A fragments;
// - K/V tiles of 64 rows of kv head h / rep are staged through shared
//   memory with 16-byte loads; the loop runs up to the diagonal tile when
//   causal and over all tiles otherwise;
// - scores and the running max / sum stay in fp32 (log2 domain, exp2f);
//   P is rounded to bf16 only as the A operand of P @ V;
// - the causal diagonal and the ragged tail (positions >= T) are masked
//   here, so any T >= 1 runs on the kernel;
// - inputs are read through their [B, T, H, D] strides; no atomics, so
//   the result is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using flash::kFull;
using flash::kThreads;
using flash::load_a_frags;
using flash::load_tile;
using flash::mma_rows;
using flash::mma_rows_t;
using flash::pack_bf16;
using flash::store_rows;

constexpr int kBlockM = flash::kTile;  // query rows per block (16 per warp)
constexpr int kBlockN = flash::kTile;  // key rows per K/V tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int T, int Hq, int rep, int64_t q_sb, int64_t q_st,
                     int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
                     int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
                     int64_t o_st, int64_t o_sh, float scale_log2,
                     int causal) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;       // k-steps of Q @ K^T
  constexpr int kDTiles = D / 8;        // n8 tiles of O
  constexpr int kNTiles = kBlockN / 8;  // n8 tiles of S
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kLd];

  // causal: the longest rows (last q tiles) are scheduled first
  const int qtile = causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row / column pair
  const int q0 = qtile * kBlockM;

  const __nv_bfloat16* q_head = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* k_head = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* v_head = v + b * v_sb + hk * v_sh;

  // Q tile -> registers as A fragments, staged through k_s.
  load_tile<D>(k_s, q_head, q_st, q0, T, tid);
  __syncthreads();
  uint32_t qf[kKSteps][4];
  load_a_frags<D>(qf, k_s + warp * 16 * kLd, lane);

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int n_tiles = causal ? qtile + 1 : (T + kBlockN - 1) / kBlockN;
  const unsigned short* v_bits = reinterpret_cast<const unsigned short*>(v_s);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(k_s, k_head, k_st, k0, T, tid);
    load_tile<D>(v_s, v_head, v_st, k0, T, tid);
    __syncthreads();

    // S = Q @ K^T for this warp's 16 rows and the tile's 64 keys
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      mma_rows_t<D>(s[nt], qf, k_s + nt * 8 * kLd, lane);
    }

    // scale into the log2 domain; mask the ragged tail and the diagonal
    const bool need_mask = (k0 + kBlockN > T) || (causal && j == qtile);
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (need_mask) {
          const int col = k0 + nt * 8 + tg * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= T || (causal && col > row)) x = -CUDART_INF_F;
        }
        s[nt][e] = x;
      }
    }

    // online softmax; the four threads of a quad share each row
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float base = (mx == -CUDART_INF_F) ? 0.f : mx;
      corr[r] = exp2f(m[r] - base);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - base);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - base);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;
    }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P @ V: the S accumulators of two n8 tiles are the A fragment
    // of one k16 step; V's B fragment pairs two rows of one column
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      mma_rows<D>(acc, pa, v_bits, kk * 16, lane);
    }
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
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][2 * r] *= inv;
      acc[dt][2 * r + 1] *= inv;
    }
    const int row = row0 + r * 8;
    if (row < T && tg == 0) {
      lse[((int64_t)b * Hq + h) * T + row] = m[r] * kLn2 + logf(sum);
    }
  }
  store_rows<D>(acc, o + b * o_sb + h * o_sh, o_st, row0, T, lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int T, int Hq, int Hkv, const long long* s, float scale_log2,
           int causal, cudaStream_t stream) {
  const dim3 grid((T + kBlockM - 1) / kBlockM, Hq, B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), T, Hq, Hq / Hkv, s[0], s[1], s[2], s[3], s[4],
      s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o: [B, T, Hq, D] bf16; k, v: [B, T, Hkv, D] bf16; lse: [B, Hq, T] fp32
// contiguous. strides: 12 element strides (batch, time, head) of q, k, v
// and o in that order; the head_dim stride is 1 and every stride is a
// multiple of 8. Launches on `stream`; returns the cudaError_t of the
// launch (0 on success).
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int T, int Hq, int Hkv,
                             int D, const long long* strides, int causal,
                             void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, T, Hq, Hkv, strides, scale_log2, causal, st);
    case 32: return launch<32>(q, k, v, o, lse, B, T, Hq, Hkv, strides, scale_log2, causal, st);
    case 48: return launch<48>(q, k, v, o, lse, B, T, Hq, Hkv, strides, scale_log2, causal, st);
    case 64: return launch<64>(q, k, v, o, lse, B, T, Hq, Hkv, strides, scale_log2, causal, st);
    case 80: return launch<80>(q, k, v, o, lse, B, T, Hq, Hkv, strides, scale_log2, causal, st);
    case 96: return launch<96>(q, k, v, o, lse, B, T, Hq, Hkv, strides, scale_log2, causal, st);
    case 112: return launch<112>(q, k, v, o, lse, B, T, Hq, Hkv, strides, scale_log2, causal, st);
    case 128: return launch<128>(q, k, v, o, lse, B, T, Hq, Hkv, strides, scale_log2, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

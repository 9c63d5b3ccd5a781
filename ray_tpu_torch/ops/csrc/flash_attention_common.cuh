// Pieces of the dQ kernel (mma.sync, Hopper's legacy tensor-core path;
// the forward and dK/dV kernels use flash_attention_sm90.cuh instead):
// the bf16 tensor-core product, fragment packing, the shared-memory tile
// copy and the three operand patterns every product of the kernel uses.
// Every tile is 64 rows of one head, staged with a row pitch of D + 8
// elements so that fragment reads of neighbouring rows hit different
// banks. Fragment layouts are those of mma.m16n8k16: lane = 4 * g + tg.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;  // rows of every q and kv tile
constexpr int kWarps = 4;  // 16 rows of a tile per warp
constexpr int kThreads = kWarps * 32;

// d += a @ b for one m16n8k16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register; `lo` lands in the low half, which
// is the element with the smaller column index in an mma fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one head into shared memory with
// 16-byte loads. Rows at or past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* head,
                                          int64_t row_stride, int row0, int T,
                                          int tid) {
  constexpr int kVecs = D / 8;  // 16-byte vectors per row
  constexpr int kLd = D + 8;
  for (int i = tid; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      val = *reinterpret_cast<const uint4*>(head + (int64_t)t * row_stride +
                                            c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) = val;
  }
}

// A fragments of the 16 rows of a shared tile that start at `slab`: the
// rows are the product's M dimension, head_dim its K dimension.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16* slab,
                                             int lane) {
  constexpr int kLd = D + 8;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + tg * 2;
    f[ks][0] = *reinterpret_cast<const uint32_t*>(slab + g * kLd + c);
    f[ks][1] = *reinterpret_cast<const uint32_t*>(slab + (g + 8) * kLd + c);
    f[ks][2] = *reinterpret_cast<const uint32_t*>(slab + g * kLd + c + 8);
    f[ks][3] =
        *reinterpret_cast<const uint32_t*>(slab + (g + 8) * kLd + c + 8);
  }
}

// acc[16 x 8] += A[16 x D] @ R^T, where R is the 8 rows of a shared tile
// that start at `rows`: each row is one column of the result ("col" B
// operand, contracted over head_dim).
template <int D>
__device__ __forceinline__ void mma_rows_t(float (&acc)[4],
                                           const uint32_t (&a)[D / 16][4],
                                           const __nv_bfloat16* rows,
                                           int lane) {
  constexpr int kLd = D + 8;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* r = rows + g * kLd + ks * 16 + tg * 2;
    mma_16816(acc, a[ks], *reinterpret_cast<const uint32_t*>(r),
              *reinterpret_cast<const uint32_t*>(r + 8));
  }
}

// acc[16 x D] += A[16 x 16] @ X[r0 : r0 + 16, :], X a shared tile read as
// [k = row, n = head_dim]: each B register pairs two rows of one column.
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[4],
                                         const unsigned short* bits, int r0,
                                         int lane) {
  constexpr int kLd = D + 8;
  const int g = lane >> 2, tg = lane & 3;
  const int r = r0 + tg * 2;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + g;
    const uint32_t b0 = (uint32_t)bits[r * kLd + col] |
                        ((uint32_t)bits[(r + 1) * kLd + col] << 16);
    const uint32_t b1 = (uint32_t)bits[(r + 8) * kLd + col] |
                        ((uint32_t)bits[(r + 9) * kLd + col] << 16);
    mma_16816(acc[dt], a, b0, b1);
  }
}

// Write this thread's two rows (row0 and row0 + 8) of a [16 x D] fp32
// accumulator as bf16, skipping rows at or past T.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           __nv_bfloat16* base,
                                           int64_t row_stride, int row0,
                                           int T, int lane) {
  const int tg = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    __nv_bfloat16* out = base + (int64_t)row * row_stride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8 + tg * 2) =
          __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
}

}  // namespace flash

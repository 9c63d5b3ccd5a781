// Hopper (sm_90a) building blocks of the flash-attention forward, dQ and
// dK/dV kernels: mbarriers, TMA tile loads, the shared-memory matrix
// descriptor of a 128-byte-swizzled tile, warpgroup MMA (wgmma) in the two
// forms the kernels use, setmaxnreg and the register split it serves, and
// on the host the encoding of a [B, T, H, D] tensor's TMA map.
//
// Element types (`Elem`). The kernels take bf16, fp16 and fp32 inputs.
// bf16 and fp16 tiles reach shared memory by TMA as they are, and the
// products are wgmma in that type (`.bf16` or `.f16`). fp32 inputs run
// the bf16 products: up to head_dim 256 a split pass rounds them once a
// call into bf16 copies (`split8`), which the kernels load by TMA like
// any bf16 tile; past 256 the slab kernels' producer threads round each
// tile on its way into shared memory (`convert_rows`), in the same
// swizzled layout. Not TF32: TF32 wgmma would take both
// operands K-major only, while P V, dS K, dS^T Q and P^T dO contract
// along the sequence, over which V, K, Q and dO are MN-major. Every
// product accumulates in fp32, and outputs are written in the input type.
//
// Tiles. Every tile in shared memory is `rows` rows of 64 16-bit columns
// (128 bytes), 128-byte swizzled (by TMA with CU_TENSOR_MAP_SWIZZLE_128B,
// or by `convert_rows` in the same layout); a head_dim of 128 is two such
// tiles side by side ("column blocks", the second at rows * 128 bytes),
// of 256 four. Each tile starts on a 1024-byte boundary (one swizzle
// atom: 8 rows of 128 bytes).
//
// The two product forms (m64nNk16, 16-bit in, fp32 accumulate):
// - SS, "rows as the K-major B operand": C[64 x N] += A[64 x 16] B[N x 16]^T
//   with A and B both row tiles in shared memory, contracted over their
//   columns (head_dim). K-major, 128-byte swizzle: SBO = 1024 bytes (the
//   next 8 rows), LBO unused; the k-th slice of 16 columns starts 32 bytes
//   further inside its column block.
// - RS, "accumulator as A, rows as the MN-major B operand":
//   C[64 x N] += A[64 x 16] X[r0 : r0 + 16, 0 : N] with A in registers and
//   X a row tile read as [k = row, n = column] (transposed B). MN-major,
//   128-byte swizzle: LBO = the byte offset of the next column block
//   (64 columns further), SBO = 1024 bytes (the next 8 rows); the slice
//   of rows r0 .. r0 + 15 starts r0 * 128 bytes further.
// Accumulator layout (per warp w of the warpgroup, lane = 4 * g + tg):
// element 4 * j + e holds row 16 * w + g + 8 * (e >> 1), column
// 8 * j + 2 * tg + (e & 1). Two neighbouring n8 column blocks 2kk and
// 2kk + 1 of an accumulator are, packed to 16 bits, exactly the A
// registers of the k16 slice kk (see `pack_a`). An accumulator of 256
// columns is two of 128 side by side (`wgmma_rs_cols`).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <mutex>
#include <type_traits>
#include <utility>
#include <vector>

namespace sm90 {

// ------------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA traffic on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One plain arrival (release: this thread's earlier shared stores are
// visible to a thread whose wait on this phase returns).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0: waiting on parity 0 blocks until its first completion,
// waiting on parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at (c0, c1, c2, c3) of the 4-D map `map` into shared
// memory at `dst`, completing `bytes` on `bar` (elements outside the
// tensor arrive as zeros and still count).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous product (which owns them until its wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for the A registers of RS products (16-bit pairs), which an
// asynchronous product reads until its wait: fencing them after the wait
// keeps the compiler from reusing them while the product is in flight.
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A block is a producer warpgroup plus kConsumers warpgroups of 64 q rows
// each (the dK/dV kernel's two consumers share its 64 kv rows), launched
// at the most registers __launch_bounds__ allows; the producer gives what
// it does not need to the consumers (a launch checks the count, see
// prepare_launch):
// - 2 consumers, 1 block a SM: 384 x 168 = 128 x 24 + 256 x 240;
// - 1 consumer, 2 blocks a SM: 256 x 128 = 128 x 24 + 128 x 232.
// A producer that converts fp32 tiles itself (the slab kernels past head_dim
// 256) keeps kProducerRegs = 40, and the consumers get what is left: 232
// (2 consumers) or 216 (1).
template <int kConsumers, int kProducerRegs_ = 24>
struct Split {
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBlocksPerSm = kConsumers == 2 ? 1 : 2;
  static constexpr int kLaunchRegs = kConsumers == 2 ? 168 : 128;
  static constexpr int kProducerRegs = kProducerRegs_;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * kConsumers) /
      8 * 8;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Order this thread's earlier accesses of shared memory by the generic
// proxy (plain loads and stores) against later ones by the async proxy
// (TMA, wgmma), and back.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The first 1024-byte boundary at or after `p` (a swizzle atom's
// alignment; dynamic shared memory is allocated 1024 bytes longer).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// Named barrier over `threads` threads (id 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive on named barrier `id` without waiting: the other threads of its
// `threads` wait for it with named_barrier (this thread's earlier shared
// stores are visible to them once their wait returns).
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- clusters

// This block's rank in its thread-block cluster.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives and waits (release,
// acquire: what each wrote before is visible to all after).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The shared::cluster address of `addr` (a shared::cta address of this
// block's) in the block of rank `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// One arrival on the mbarrier at shared::cluster address `bar` (a peer
// block's) that releases at block scope only: for a signal that
// publishes no data of its own (a receiver's "done with your slot", its
// values already in registers). An arrival releasing at cluster scope
// costs about 900 cycles on an H100 (chip_kernel_probe.py --trace).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait whose completion acquires at cluster scope what the arriving
// threads of any block of the cluster released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// An asynchronous store of 16 bytes to shared::cluster address `addr`
// (a peer block's), which counts its bytes on the mbarrier at
// shared::cluster address `bar` in that block (as a TMA load does): the
// receiver's wait on that barrier sees the bytes, with no fence here.
__device__ __forceinline__ void st_async_f4(uint32_t addr, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------ element types

// What the kernels do with each input type: `Op` is the type of the
// tensor-core operands in shared memory and in the A registers; `kTma`
// whether the tiles arrive by TMA as they are (fp32: up to head_dim 256
// from the split passes' bf16 copies, past it converted by the slab
// kernels' producer threads, see convert_rows); `kMapType` the TMA map's
// type.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using Op = __nv_bfloat16;
  static constexpr bool kTma = true;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<__half> {
  using Op = __half;
  static constexpr bool kTma = true;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};
template <>
struct Elem<float> {
  using Op = __nv_bfloat16;  // rounded to bf16
  static constexpr bool kTma = false;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;  // never encoded (copies are bf16)
};

// The element types' codes (the wrapper's KERNEL_DTYPES). Each source is
// built once per type, into a library of its own (ops/_build.py passes
// -DFLASH_DTYPE=code), which takes that type only: `Built`.
enum DType { kBf16 = 0, kF16 = 1, kF32 = 2 };
template <int kCode>
struct TypeOf;
template <>
struct TypeOf<kBf16> {
  using T = __nv_bfloat16;
};
template <>
struct TypeOf<kF16> {
  using T = __half;
};
template <>
struct TypeOf<kF32> {
  using T = float;
};
#ifndef FLASH_DTYPE
#define FLASH_DTYPE 0
#endif
using Built = typename TypeOf<FLASH_DTYPE>::T;

// Two floats as one 16-bit pair register of type Op; `lo` lands in the
// low half (the smaller column index of a fragment).
template <typename Op>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<Op, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// A 16-bit pair (bf16 or fp16) as two floats.
template <typename Op>
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  if constexpr (std::is_same<Op, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(&r));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  }
}

// Two floats stored at `out` (8-byte aligned for fp32, 4 for 16 bits) in
// the output type T.
template <typename T>
__device__ __forceinline__ void store2(T* out, float a, float b) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(out) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(out) = pack2<T>(a, b);
  }
}

// The A registers of k16 slice kk from an fp32 accumulator (its n8 column
// blocks 2kk and 2kk + 1), rounded to Op.
template <typename Op = __nv_bfloat16, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N],
                                       int kk) {
  a[0] = pack2<Op>(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack2<Op>(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack2<Op>(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack2<Op>(c[8 * kk + 6], c[8 * kk + 7]);
}

// Narrow head_dims. Up to kNarrowWidth columns (the kernels' width) a row
// of Q K^T sums too few products to average the operands' rounding out:
// with bf16 A operands P and dS (exp of scores of order |q| |k|, peaked),
// bf16 head_dim 1 missed the 64-row block gates by up to 12.7x on an H100.
// There the kernels take each A operand as two parts, the rounded value
// and what the rounding left (pack_a_rest), two products where one was.
constexpr int kNarrowWidth = 16;

// The A registers of what rounding slice kk of `c` to `hi` (pack_a's)
// left, rounded to Op in turn: a product of hi and one of these sums to
// that of the fp32 values within about 2^-16 of it, where hi's alone is
// within 2^-9 (Op bf16; 2^-12 fp16).
template <typename Op = __nv_bfloat16, int N>
__device__ __forceinline__ void pack_a_rest(uint32_t (&lo)[4],
                                            const uint32_t (&hi)[4],
                                            const float (&c)[N], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 h = unpack2<Op>(hi[r]);
    lo[r] = pack2<Op>(c[8 * kk + 2 * r] - h.x, c[8 * kk + 2 * r + 1] - h.y);
  }
}

// The split passes (flash_bwd_split_kernel, flash_fwd_split_kernel), which
// round fp32 inputs to bf16 copies once a call for the kernels to load
// by TMA: eight floats of a row from column `col` on, zeros past d_true
__device__ __forceinline__ void load8(const float* row, int col, int d_true,
                                     float (&x)[8]) {
  if (col + 8 <= d_true) {
    const float4 a = reinterpret_cast<const float4*>(row + col)[0];
    const float4 b = reinterpret_cast<const float4*>(row + col)[1];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = col + e < d_true ? row[col + e] : 0.f;
  }
}

// x rounded to bf16 into hi (and, given lo, what the rounding left, rounded
// in turn into lo): convert_rows's arithmetic
__device__ __forceinline__ void split8(const float (&x)[8], uint4* hi,
                                       uint4* lo) {
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = pack2<__nv_bfloat16>(x[2 * e], x[2 * e + 1]);
  *hi = make_uint4(v[0], v[1], v[2], v[3]);
  if (lo != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 h = unpack2<__nv_bfloat16>(v[e]);
      v[e] = pack2<__nv_bfloat16>(x[2 * e] - h.x, x[2 * e + 1] - h.y);
    }
    *lo = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// fp32 inputs: rows t0 .. t0 + kRows - 1 of one head of a [B, T, H, D]
// fp32 tensor (`src` points at row 0 of that head, rows `st` elements
// apart, 16-byte aligned), columns 0 .. kD - 1, rounded to bf16 into kD /
// 64 column blocks of kRows 128-byte rows, swizzled as TMA lays a bf16
// tile (the 16-byte chunk c of row r at byte ((c ^ (r & 7)) << 4) of its
// row); rows >= T and columns >= d_true arrive as zeros, as TMA's do.
// Run by the 128 threads of the producer warpgroup (`tid` 0 .. 127),
// neighbouring threads on neighbouring 32-byte pieces of a row. The
// caller fences (fence_proxy_async) before it arrives on the tile's
// barrier, since wgmma reads the tile through the async proxy. Given
// `lo`, the tile there gets what the rounding left, x - bf16(x), rounded
// to bf16 in turn: the two tiles' products sum to that of x within about
// 2^-16 of it, where one tile's is within 2^-9.
template <int kRows, int kD>
__device__ __forceinline__ void convert_rows(uint8_t* dst, const float* src,
                                             int64_t st, int t0, int T,
                                             int d_true, int tid,
                                             uint8_t* lo = nullptr) {
  constexpr int kChunks = kD / 8;  // 8 columns: 16 bytes of bf16
#pragma unroll 4
  for (int i = tid; i < kRows * kChunks; i += 128) {
    const int r = i / kChunks, ch = i % kChunks;
    const int row = t0 + r, col = 8 * ch;
    float x[8];
    if (row < T && col + 8 <= d_true) {
      const float4* p =
          reinterpret_cast<const float4*>(src + (int64_t)row * st + col);
      const float4 a = p[0], b = p[1];
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = row < T && col + e < d_true ? src[(int64_t)row * st + col + e]
                                           : 0.f;
      }
    }
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = pack2<__nv_bfloat16>(x[2 * e], x[2 * e + 1]);
    }
    const int at = (ch / 8) * kRows * 128 + r * 128 +
                   (((ch % 8) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(dst + at) = make_uint4(v[0], v[1], v[2], v[3]);
    if (lo != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 h = unpack2<__nv_bfloat16>(v[e]);
        v[e] =
            pack2<__nv_bfloat16>(x[2 * e] - h.x, x[2 * e + 1] - h.y);
      }
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The first element of head h, batch b of an fp32 [B, T, H, D] input
// (`s` its element strides: batch, time, head).
__device__ __forceinline__ const float* head_rows(const void* base,
                                                  const long long* s, int b,
                                                  int h) {
  return static_cast<const float*>(base) + b * s[0] + h * s[2];
}

// Where the producer's threads read fp32 inputs (unused for bf16, fp16):
// each input's base and (batch, time, head) element strides.
struct Src {
  const void* ptr[4];
  long long stride[4][3];
};

// ------------------------------------------------------------------- wgmma

// The operand lists of the asm statements below: 32 or 64 accumulator
// floats, read and written.
#define SM90_ACC32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define SM90_ACC64(d)                                                       \
  SM90_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_REGS32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"                   \
  " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"         \
  " %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_REGS64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"                   \
  " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"         \
  " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"         \
  " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"         \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"         \
  " %60, %61, %62, %63}"

// SS: C[64 x N] += A B^T (TY is "bf16" or "f16")
#define SM90_WGMMA_SS64(TY)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               SM90_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                \
               : SM90_ACC32(d)                                             \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define SM90_WGMMA_SS128(TY)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               SM90_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                \
               : SM90_ACC64(d)                                             \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))
// RS: C[64 x N] += A X, A in registers, X transposed from shared memory
#define SM90_WGMMA_RS64(TY)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               SM90_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
               : SM90_ACC32(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),  \
                 "r"(1))
#define SM90_WGMMA_RS128(TY)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               SM90_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"  \
               : SM90_ACC64(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),  \
                 "r"(1))

// C[64 x N] (N / 2 floats a thread) += A B^T, SS form, operands of type
// Op; scale_d = 0 overwrites C instead of adding to it.
template <int N, typename Op = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss is built for N 64 and 128");
  constexpr bool kHalf = std::is_same<Op, __half>::value;
  if constexpr (N == 64 && kHalf) {
    SM90_WGMMA_SS64("f16");
  } else if constexpr (N == 64) {
    SM90_WGMMA_SS64("bf16");
  } else if constexpr (kHalf) {
    SM90_WGMMA_SS128("f16");
  } else {
    SM90_WGMMA_SS128("bf16");
  }
}

// C[64 x N] += A X, RS form (A in registers, X transposed from shared).
template <int N, typename Op = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 64 || N == 128, "wgmma_rs is built for N 64 and 128");
  constexpr bool kHalf = std::is_same<Op, __half>::value;
  if constexpr (N == 64 && kHalf) {
    SM90_WGMMA_RS64("f16");
  } else if constexpr (N == 64) {
    SM90_WGMMA_RS64("bf16");
  } else if constexpr (kHalf) {
    SM90_WGMMA_RS128("f16");
  } else {
    SM90_WGMMA_RS128("bf16");
  }
}

// RS with B K-major: C[64 x N] += A B^T, A in registers (a k16 slice of
// rows held as pack_a packs them), B a row tile in shared memory as the SS
// form reads it; scale_d = 0 overwrites C instead of adding to it.
#define SM90_WGMMA_RSK64(TY)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               SM90_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"  \
               : SM90_ACC32(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),  \
                 "r"(scale_d))
template <typename Op = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_k64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<Op, __half>::value) {
    SM90_WGMMA_RSK64("f16");
  } else {
    SM90_WGMMA_RSK64("bf16");
  }
}
#undef SM90_WGMMA_RSK64

// C[64 x N] += A X over N columns of X, a row tile of N / 64 column blocks
// `lbo` bytes apart starting at shared address `addr`: one RS product for
// N up to 128, two of 128 columns side by side for N = 256 (the
// accumulator's halves are its columns 0-127 and 128-255).
template <int N, typename Op = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint32_t addr, uint32_t lbo) {
  if constexpr (N <= 128) {
    wgmma_rs<N, Op>(d, a, desc_sw128(addr, lbo, 1024));
  } else {
    static_assert(N == 256, "wgmma_rs_cols is built for N up to 256");
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      wgmma_rs<128, Op>(*reinterpret_cast<float(*)[64]>(&d[64 * half]), a,
                        desc_sw128(addr + 2 * half * lbo, lbo, 1024));
    }
  }
}

#undef SM90_WGMMA_SS64
#undef SM90_WGMMA_SS128
#undef SM90_WGMMA_RS64
#undef SM90_WGMMA_RS128
#undef SM90_REGS32
#undef SM90_REGS64
#undef SM90_ACC32
#undef SM90_ACC64


// ------------------------------------------------------------------- host

// Error codes beside cudaError_t's (all of which are below 1000).
constexpr int kErrNoEncode = 7001;     // no cuTensorMapEncodeTiled (libcuda)
constexpr int kErrRegisters = 7002;    // register count != setmaxnreg's plan
constexpr int kErrEncodeBase = 7100;   // + the CUresult of a refused map

inline const char* error_string(int err) {
  static thread_local char buf[128];
  if (err == kErrNoEncode) {
    return "cuTensorMapEncodeTiled is not available (TMA needs libcuda of "
           "CUDA 12 or later)";
  }
  if (err == kErrRegisters) {
    return "kernel built with another register count than its setmaxnreg "
           "split assumes; a launch would deadlock";
  }
  if (err >= kErrEncodeBase) {
    snprintf(buf, sizeof(buf),
             "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             err - kErrEncodeBase);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cuTensorMapEncodeTiled, a libcuda function, fetched through the CUDA
// runtime (so the library needs no -lcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// The TMA map of a [B, T, H, D] bf16 or fp16 tensor (`type`) with
// element strides (sb, st, sh) and a unit head_dim stride, for boxes of
// `rows` rows of 64 columns of one head, 128-byte swizzled. Dimensions are
// ordered (D, H, T, B), so a box {64, 1, rows, 1} at coordinates (c, h, t,
// b) lands as rows t .. t + rows - 1 of columns c .. c + 63. Columns past
// D (a kernel built for a head_dim of 64, 128 or 256 reading a narrower
// tensor, up to whole boxes of them) and rows past T arrive as zeros. The
// kernels' guard (strides a multiple of 16 bytes, 16-byte aligned base) is
// TMA's own rule. Returns 0 or an error code.
inline int encode_rows(CUtensorMap* map, const void* base, int B, int T,
                       int H, int D, long long sb, long long st,
                       long long sh, int rows,
                       CUtensorMapDataType type =
                           CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + static_cast<int>(r);
}

// The TMA map of a split pass's bf16 copy [B, T, H, w8], contiguous (w8:
// the input's width rounded up to 8 columns, the rest zeros), for boxes of
// `rows` rows: the kernels read it as they read a bf16 input. Returns 0 or
// an error code.
inline int encode_copy(CUtensorMap* map, const void* base, int B, int T,
                       int H, int w8, int rows) {
  return encode_rows(map, base, B, T, H, w8, (long long)T * H * w8,
                     (long long)H * w8, w8, rows);
}

// Whether the entry points take head_dim D (the tensors' width, any D >=
// 1 whose rows are a whole number of 16-byte units; past 256 the kernels
// own slabs of the output columns) and the true head_dim `d_head` of the
// scale (at most D: the wrapper may pad D with zeros) for type code
// `dtype`.
inline bool bad_head_dim(int D, int d_head, int dtype) {
  const int esize = dtype == kF32 ? 4 : 2;
  return D < 1 || (D * esize) % 16 != 0 || d_head < 1 || d_head > D;
}

// Input `i` of a kernel, [B, T, H, D] at `base` with element strides s[0 ..
// 2], as the kernel reads it: for bf16 and fp16 its TMA map for boxes of
// `rows` rows, for fp32 its base and strides in `src` (the map is zeroed,
// never used). Returns 0 or an error code.
template <typename In>
inline int prepare_input(CUtensorMap* map, Src* src, int i, const void* base,
                         int B, int T, int H, int D, const long long* s,
                         int rows) {
  if constexpr (Elem<In>::kTma) {
    return encode_rows(map, base, B, T, H, D, s[0], s[1], s[2], rows,
                       Elem<In>::kMapType);
  } else {
    memset(map, 0, sizeof(*map));
    src->ptr[i] = base;
    for (int d = 0; d < 3; ++d) src->stride[i][d] = s[d];
    return 0;
  }
}

// Before a launch: allow `smem_bytes` of dynamic shared memory, and refuse
// (kErrRegisters) a kernel whose register count is not `regs`, the count
// its setmaxnreg split is planned on (another count would leave the
// consumers' setmaxnreg.inc waiting for registers that never come free).
// Done once a kernel and device: both hold for the process, and the two
// runtime calls cost microseconds of host time a launch.
template <typename Kernel>
inline int prepare_launch(Kernel kernel, int smem_bytes, int regs) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> prepared;
  const void* key = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const auto& p : prepared) {
      if (p.first == key && p.second == dev) return 0;
    }
  }
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (attr.numRegs != regs) return kErrRegisters;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e == cudaSuccess) {
    std::lock_guard<std::mutex> lock(mu);
    prepared.emplace_back(key, dev);
  }
  return static_cast<int>(e);
}

}  // namespace sm90

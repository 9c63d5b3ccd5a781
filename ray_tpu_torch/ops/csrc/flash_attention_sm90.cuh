// Hopper (sm_90a) building blocks of the flash-attention forward, dQ and
// dK/dV kernels: mbarriers, TMA tile loads, the shared-memory matrix
// descriptor of a 128-byte-swizzled tile, warpgroup MMA (wgmma) in the two
// forms the kernels use, setmaxnreg and the register split it serves, and
// on the host the encoding of a [B, T, H, D] tensor's TMA map.
//
// Tiles. Every bf16 tile in shared memory is `rows` rows of 64 columns
// (128 bytes) written by TMA with CU_TENSOR_MAP_SWIZZLE_128B; a head_dim
// of 128 is two such tiles side by side ("column blocks", the second at
// rows * 128 bytes). Each tile starts on a 1024-byte boundary (one
// swizzle atom: 8 rows of 128 bytes).
//
// The two product forms (m64nNk16, bf16 in, fp32 accumulate):
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
// 2kk + 1 of an accumulator are, packed to bf16, exactly the A registers
// of the k16 slice kk (see `pack_a`).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

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
template <int kConsumers>
struct Split {
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBlocksPerSm = kConsumers == 2 ? 1 : 2;
  static constexpr int kLaunchRegs = kConsumers == 2 ? 168 : 128;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 232;
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

// Two floats as one bf16x2 register; `lo` lands in the low half (the
// smaller column index of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A registers of k16 slice kk from an fp32 accumulator (its n8 column
// blocks 2kk and 2kk + 1), rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N],
                                       int kk) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// C[64 x N] (N / 2 floats a thread) += A B^T, SS form; scale_d = 0
// overwrites C instead of adding to it.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d);
// C[64 x N] += A X, RS form (A in registers, X transposed from shared).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(
    float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(
    float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}


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

// The TMA map of a [B, T, H, D] bf16 tensor with element strides (sb, st,
// sh) and a unit head_dim stride, for boxes of `rows` rows of 64 columns
// of one head, 128-byte swizzled. Dimensions are ordered (D, H, T, B), so
// a box {64, 1, rows, 1} at coordinates (c, h, t, b) lands as rows t ..
// t + rows - 1 of columns c .. c + 63. Columns past D (a kernel built for
// a head_dim of 64 or 128 reading a narrower tensor) and rows past T
// arrive as zeros. The kernels' guard (strides a multiple of 8 elements,
// 16-byte aligned base) is TMA's own rule. Returns 0 or an error code.
inline int encode_rows(CUtensorMap* map, const void* base, int B, int T,
                       int H, int D, long long sb, long long st,
                       long long sh, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + static_cast<int>(r);
}

// Before a launch: allow `smem_bytes` of dynamic shared memory, and refuse
// (kErrRegisters) a kernel whose register count is not `regs`, the count
// its setmaxnreg split is planned on (another count would leave the
// consumers' setmaxnreg.inc waiting for registers that never come free).
template <typename Kernel>
inline int prepare_launch(Kernel kernel, int smem_bytes, int regs) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (attr.numRegs != regs) return kErrRegisters;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  return static_cast<int>(e);
}

}  // namespace sm90

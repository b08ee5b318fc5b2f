// Hopper (sm_90a) building blocks shared by the attention kernels: mbarriers,
// TMA loads, stores and reduce-adds through 3-D tensor maps, wgmma m64n64k16
// and m64n32k16 (bf16 in, fp32 accumulate) with shared-memory descriptors of
// 128-byte-swizzled tiles, and the tensor-map encoder, taken from the
// runtime's driver entry point so no source links libcuda.
//
// Every tile is a (64 rows × 64 bf16 columns) box, 8 KB, laid out by TMA's
// 128-byte swizzle: 16-byte chunk j of row r sits at chunk j ^ (r % 8).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

constexpr uint32_t kBox = 64 * 128;  // one (64 rows × 64 bf16) swizzled box: 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed; a phase
// that never completes (a lost load) traps after ~2^28 polls instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// TMA reduce-add of a shared-memory box into the tensor, where `pred`;
// predicated, not branched, so it may sit among wgmma in flight
__device__ __forceinline__ void tma_reduce_add_3d_if(const CUtensorMap* map, uint32_t src, int c0,
                                                     int c1, int c2, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups but the newest N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) { named_sync(1 + wg, 128); }

// wgmma shared-memory descriptor of a 128-byte-swizzled operand.  K-major
// (rows of 128 bytes along the reduction): leading offset unused (16),
// stride 1024 bytes between 8-row groups; a k16 step adds 32 bytes.
// MN-major (the transposed read): the reduction runs over rows, 1024 bytes
// between 8-row groups; every MN-major operand here is at most 64 wide, one
// swizzle atom (a 32-wide one starts 64 bytes into it), so the leading
// offset (between atoms) is never used and is given the same 1024; a k16
// step adds 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc_sw128(addr, 16); }
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) { return desc_sw128(addr, 1024); }

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
// keeps the compiler from moving accumulator accesses across wgmma issue/wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_WGMMA_D32                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_WGMMA_REGS32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64×64 fp32) = [d +] A·B, A (64×16) and B (16×64) K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, A (64×16 bf16) in registers, B (16×64) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64×64 fp32) += A·B, A K-major and B MN-major in shared memory
__device__ __forceinline__ void wgmma_sn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : HOPPER_WGMMA_D32
      : "l"(da), "l"(db), "r"(1));
}

// d (64×64 fp32) = [d +] A·B, both MN-major in shared memory (the transposed
// reads: A's rows and B's columns run along the 128-byte rows of their tiles)
__device__ __forceinline__ void wgmma_tt(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : HOPPER_WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// the same, 64×32: B is the left or right half of a 64-column tile
__device__ __forceinline__ void wgmma_tt(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef HOPPER_WGMMA_D32
#undef HOPPER_WGMMA_REGS32

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of m64n64 (thread = 128·wg + 32·warp + 4·g + t):
//   d[4j + 2i + c] is row 16·warp + g + 8i, column 8j + 2t + c.
// Columns 16kk..16kk+15 of it, packed to bf16, are the A registers of k16
// step kk: {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], ..}, {d[8kk+6], ..}.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// this warpgroup's 64 × 64 accumulator, times mul, as bf16 into a box laid
// out as TMA's 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8))
__device__ __forceinline__ void acc_to_box(uint8_t* box, const float (&d)[32], float mul, int warp,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      *reinterpret_cast<uint32_t*>(box + r * 128 + ((j ^ g) << 4) + 4 * t) =
          pack_bf16(d[4 * j + 2 * i] * mul, d[4 * j + 2 * i + 1] * mul);
    }
}

// this warpgroup's 64-row fp32 accumulator of R/2 columns (R/16 boxes of 32)
// into fp32 boxes laid out as TMA's 128-byte swizzle, 8 KB apart:
// columns 8j + 2t + c go to box j / 4, 16-byte chunk 2·(j % 4) + t / 2
template <int R>
__device__ __forceinline__ void acc_to_f32_boxes(uint8_t* box, const float (&d)[R], int warp, int g,
                                                 int t) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      const int chunk = 2 * (j % 4) + (t >> 1);
      *reinterpret_cast<float2*>(box + (j / 4) * 8192 + r * 128 + ((chunk ^ g) << 4) + 8 * (t & 1)) =
          make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// extension does not link libcuda
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// (B·H, T, dim) bf16 rows as 3-D (dim, T, B·H), 64 × 64 boxes, 128-byte
// swizzle; out-of-bounds elements read as zeros and are dropped on store
inline bool encode_heads(CUtensorMap* map, const void* ptr, int bh, int seq, int dim) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dim) * 2,
                                 static_cast<cuuint64_t>(seq) * dim * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (B·H, T, dim) fp32 rows as 3-D (dim, T, B·H), 32 × 64 boxes (128-byte
// rows), 128-byte swizzle: the target of TMA reduce-adds
inline bool encode_heads_f32(CUtensorMap* map, const void* ptr, int bh, int seq, int dim) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dim) * 4,
                                 static_cast<cuuint64_t>(seq) * dim * 4};
  const cuuint32_t box[3] = {32, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace hopper

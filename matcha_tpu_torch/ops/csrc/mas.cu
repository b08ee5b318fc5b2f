// Monotonic alignment search for Hopper (sm_90a): the forward DP over mel
// frames and the backtrack, in one launch, one block per batch row.
//
// Replaces both Pallas TPU kernels of matcha_tpu/ops/mas_pallas.py: the
// forward DP (_fwd_kernel, launched at :179) and the backtrack (_bwd_kernel,
// launched at :189).  Same semantics, all fp32:
//   f[i] <- v[i, j] + max(f[i], f[i-1]),  f[-1] = -1e9
//   rows i >= x_len held at -1e9; at j = 0 only f[0] = v[0, 0]
//   take_diag[j, i] = f[i-1] >= f[i]  (ties go diagonal)
//   backtrack from x_len-1: emit the cursor for j < y_len, -1 after; step
//   down when j < y_len, j > 0, cursor > 0 and take_diag[j, cursor].
// Every operation is an fp32 add or max in the plain version's order, so the
// indices are bit-for-bit the plain version's.
//
// What bounds it on the card: not bytes (the value tensor is read once,
// B*Tx*Ty*4 bytes, 57 MB at (62, 224, 1024): 17 us at 3.35 TB/s) but the
// chain of Ty dependent frames.  The TPU kernel carries f across a
// sequential grid; here a loop over frames inside the block takes its
// place, and the batch rows run in parallel on the SMs.  What the design
// does about each cost of the chain:
//   (1) no barrier per frame: ONE warp owns the whole DP front (Tx <= 512).
//       Lane l holds the K = ceil(Tx/32) consecutive tokens Kl..Kl+K-1 in
//       registers, so f[i-1] is the lane's own previous slot except for its
//       first token, which takes lane l-1's last by one shuffle per frame.
//       A frame is then K independent compare/max/add triples and one
//       shuffle, and the shuffle's latency hides behind the other slots.
//   (2) values prefetched many frames ahead: three loader warps copy
//       (x_len tokens × 16 frames) tiles, each token's 16 frames contiguous
//       in memory, into a ring of 2-4 tiles in shared memory with cp.async
//       (16 bytes a copy when Ty % 4 == 0), and signal each tile on a full
//       mbarrier; the DP warp hands a tile back on an empty one.  Token
//       Kl+k sits in tile row 32k+l, its frames in four 16-byte chunks
//       whose order is XOR-swizzled by the row, so the DP warp reads 4
//       frames of a token in one conflict-free 16-byte load.  Four warps in
//       all: no loader shares the DP warp's scheduler.
//   (3) decisions without a per-frame ballot: each lane sets bit j % 32 of
//       one register per token, and stores the K words every 32 frames,
//       token-major.  The backtrack (one thread) then finds the frame where
//       the cursor leaves token c as the highest set bit of c's word below
//       the current frame (one clz), so it costs a dependent load per token
//       and per 32 frames, not per frame.
// The decisions stay in shared memory when they fit beside a ring of at
// least 2 tiles under the 227 KB opt-in limit (28 KB at (224, 1024), 122 KB
// at (448, 2176)), else they go to a global scratch buffer the wrapper
// allocates.  Tx > 512 (no configured model reaches it) takes the earlier
// block-wide kernel: threads stride over tokens, f double-buffered in
// shared memory with one barrier per frame, decisions packed by ballot.

#include "hopper.cuh"  // mbarriers

namespace {

using namespace hopper;

constexpr float kNegInf = -1e9f;
constexpr size_t kMaxSmem = 232448;

// ---------------------------------------------------------------------------
// Tx <= 512: one DP warp, three loader warps
// ---------------------------------------------------------------------------

constexpr int kWarpMaxK = 16;            // tokens a lane: Tx <= 512
constexpr int kFrames = 16;              // frames per value tile: four 16-byte chunks
constexpr int kLoaders = 96;             // loader threads: warps 1-3
constexpr int kWarpThreads = 32 + kLoaders;
constexpr int kMaxStages = 4;

struct WarpShape {
  int k, stages, row_words;  // row_words: decision words per token, odd
  size_t stage_bytes, bit_bytes, smem;
  bool bits_in_smem;
};

WarpShape warp_shape(int tx, int ty) {
  WarpShape s;
  s.k = (tx + 31) / 32;
  const int blocks = (ty + 31) / 32;
  s.row_words = blocks | 1;  // an odd stride keeps the lanes' stores on distinct banks
  s.stage_bytes = static_cast<size_t>(32) * s.k * kFrames * sizeof(float);
  s.bit_bytes = static_cast<size_t>(32) * s.k * s.row_words * sizeof(uint32_t);
  const size_t bars = 2 * kMaxStages * sizeof(uint64_t);
  s.bits_in_smem = false;
  s.stages = 2;
  for (int st = kMaxStages; st >= 2; --st) {
    if (st * s.stage_bytes + bars + s.bit_bytes <= kMaxSmem) {
      s.stages = st;
      s.bits_in_smem = true;
      break;
    }
  }
  if (!s.bits_in_smem) {
    const size_t fit = (kMaxSmem - bars) / s.stage_bytes;
    s.stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  }
  s.smem = s.stages * s.stage_bytes + bars + (s.bits_in_smem ? s.bit_bytes : 0);
  return s;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// arrives on `bar` once every cp.async this thread issued before has landed
// (counted in the barrier's expected arrivals: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// float offset in a tile of frame chunk c (frames 4c..4c+3) of tile row r
__device__ __forceinline__ int chunk_at(int r, int c) { return r * kFrames + ((c ^ ((r >> 1) & 3)) << 2); }

__device__ __forceinline__ float frame_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// One frame of the DP for this lane's K tokens: f[i-1] is the previous slot,
// or, for the first, lane l-1's last token (−1e9 before token 0); bit j % 32
// of dec[k] takes the decision.  Descending k keeps fr[k - 1] the previous
// frame's value.
template <int K>
__device__ __forceinline__ void dp_frame(float (&fr)[K], uint32_t (&dec)[K], const float4 (&v)[K],
                                         int u, uint32_t bit, int lane) {
  float first = __shfl_up_sync(0xffffffffu, fr[K - 1], 1);
  if (lane == 0) first = kNegInf;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const float prev = k > 0 ? fr[k - 1] : first;
    dec[k] |= prev >= fr[k] ? bit : 0u;
    fr[k] = frame_of(v[k], u) + fmaxf(fr[k], prev);
  }
}

// K: tokens a lane, ceil(Tx / 32); tokens K·l + k of lane l in slot k
template <int K>
__global__ void __launch_bounds__(kWarpThreads, 1)
mas_kernel(const float* __restrict__ value, const int* __restrict__ x_len,
           const int* __restrict__ y_len, int* __restrict__ idx, uint32_t* __restrict__ gbits,
           int tx, int ty, int stages, int row_words, bool bits_in_smem, bool vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStageFloats = 32 * K * kFrames;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // lengths outside [1, Tx] and [0, Ty] are clamped for memory safety only
  const int xl = min(max(x_len[b], 1), tx);
  const int yl = min(max(y_len[b], 0), ty);
  const float* vb = value + static_cast<size_t>(b) * tx * ty;
  float* ring = reinterpret_cast<float*>(smem);
  const uint32_t bars = smem_u32(ring + stages * kStageFloats);  // full[stages], empty[stages]
  uint32_t* bits = bits_in_smem
                       ? reinterpret_cast<uint32_t*>(smem + stages * kStageFloats * sizeof(float) +
                                                     2 * kMaxStages * sizeof(uint64_t))
                       : gbits + static_cast<size_t>(b) * 32 * K * row_words;
  const int n_tiles = (yl + kFrames - 1) / kFrames;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, kLoaders);      // full: every loader thread, when its copies land
      mbar_init(bars + 8 * (stages + s), 1);  // empty: the DP warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 32) {  // loaders: tile n holds frames 16n..16n+15 of tokens [0, x_len)
    const int lt = tid - 32;
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % stages;
      if (n >= stages) mbar_wait(bars + 8 * (stages + s), (n / stages - 1) & 1);
      float* tile = ring + s * kStageFloats;
      const int j0 = n * kFrames;
      const int nf = min(kFrames, yl - j0);
      if (vec16) {  // four threads a token: its 64 contiguous bytes
        for (int e = lt; e < 4 * xl; e += kLoaders) {
          const int i = e >> 2, c = e & 3;
          if (4 * c < nf)
            cp_async16(smem_u32(tile + chunk_at((i % K) * 32 + i / K, c)),
                       vb + static_cast<size_t>(i) * ty + j0 + 4 * c);
        }
      } else {
        for (int e = lt; e < kFrames * xl; e += kLoaders) {
          const int i = e / kFrames, f = e % kFrames;
          if (f < nf)
            cp_async4(smem_u32(tile + chunk_at((i % K) * 32 + i / K, f >> 2) + (f & 3)),
                      vb + static_cast<size_t>(i) * ty + j0 + f);
        }
      }
      cp_async_arrive(bars + 8 * s);
    }
    return;
  }

  // the DP warp.  f at tokens >= x_len is left as it comes (tile rows never
  // loaded hold anything): information flows from token i-1 to i only, so
  // it never reaches a token below x_len, and the backtrack reads no
  // decision there.
  const int lane = tid;
  int* out = idx + static_cast<size_t>(b) * ty;
  for (int j = yl + lane; j < ty; j += 32) out[j] = -1;
  if (yl == 0) return;

  float fr[K];
  uint32_t dec[K];  // bit j % 32: take_diag of token K·lane + k at frame j
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fr[k] = kNegInf;
    dec[k] = 0;
  }
  uint32_t* my_bits = bits + static_cast<size_t>(K * lane) * row_words;

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % stages;
    mbar_wait(bars + 8 * s, (n / stages) & 1);
    const float* tile = ring + s * kStageFloats;
    float4 vn[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      vn[k] = *reinterpret_cast<const float4*>(tile + chunk_at(32 * k + lane, 0));
#pragma unroll
    for (int g = 0; g < kFrames / 4; ++g) {
      const int j0 = n * kFrames + 4 * g;
      if (j0 >= yl) break;
      float4 vc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) vc[k] = vn[k];
      if (g + 1 < kFrames / 4) {  // the next 4 frames, read ahead of this group's chain
#pragma unroll
        for (int k = 0; k < K; ++k)
          vn[k] = *reinterpret_cast<const float4*>(tile + chunk_at(32 * k + lane, g + 1));
      }
      const int last = min(j0 + 3, yl - 1);  // the group's last frame
      if (j0 > 0 && last == j0 + 3) {  // four frames, straight-line
#pragma unroll
        for (int u = 0; u < 4; ++u) dp_frame<K>(fr, dec, vc, u, 1u << ((j0 + u) & 31), lane);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j == 0) {  // frame 0: only f[0] = v[0, 0]
            if (lane == 0) fr[0] = frame_of(vc[0], 0);
          } else if (j <= last) {
            dp_frame<K>(fr, dec, vc, u, 1u << (j & 31), lane);
          }
        }
      }
      if ((last & 31) == 31 || last == yl - 1) {  // a 32-frame block is done
#pragma unroll
        for (int k = 0; k < K; ++k) {
          my_bits[k * row_words + (last >> 5)] = dec[k];
          dec[k] = 0;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (stages + s));
  }
  __syncwarp();

  // backtrack: from frame j at token c, the cursor steps down at the highest
  // frame jj <= j (jj > 0, in j's 32-frame block) whose take_diag bit is set;
  // frames jj..j emit c.  One dependent load per token and per block.
  if (lane == 0) {
    int c = xl - 1;
    for (int j = yl - 1; j >= 0;) {
      const int blk = j >> 5;
      uint32_t w = bits[static_cast<size_t>(c) * row_words + blk] & (0xffffffffu >> (31 - (j & 31)));
      if (blk == 0) w &= ~1u;  // frame 0 never steps
      if (c == 0) w = 0;       // nor does token 0
      const int stop = w != 0 ? 32 * blk + 31 - __clz(w) : 32 * blk;
      for (int jj = j; jj >= stop; --jj) out[jj] = c;
      c -= w != 0;
      j = stop - 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Tx > 512: threads stride over tokens, one block barrier per frame
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 8;  // tokens per thread: Tx <= 8192

struct WideShape {
  int threads, per_thread, words;
  size_t f_bytes, bit_bytes;
  bool bits_in_smem;
};

WideShape wide_shape(int tx, int ty) {
  WideShape s;
  s.words = (tx + 31) / 32;
  const int lanes = s.words * 32;
  s.threads = lanes < kMaxThreads ? lanes : kMaxThreads;
  s.per_thread = (lanes + s.threads - 1) / s.threads;
  s.f_bytes = 2 * static_cast<size_t>(s.per_thread) * s.threads * sizeof(float);
  s.bit_bytes = static_cast<size_t>(ty) * s.words * sizeof(uint32_t);
  s.bits_in_smem = s.f_bytes + s.bit_bytes <= kMaxSmem;
  return s;
}

__global__ void __launch_bounds__(kMaxThreads)
mas_wide_kernel(const float* __restrict__ value, const int* __restrict__ x_len,
                const int* __restrict__ y_len, int* __restrict__ idx, uint32_t* __restrict__ gbits,
                int tx, int ty, int per_thread, int words, bool bits_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int span = per_thread * nthr;
  float* f = reinterpret_cast<float*>(smem);  // two buffers of span floats
  uint32_t* bits = bits_in_smem ? reinterpret_cast<uint32_t*>(f + 2 * span)
                                : gbits + static_cast<size_t>(b) * ty * words;
  // lengths outside [1, Tx] and [0, Ty] are clamped for memory safety only
  const int xl = min(max(x_len[b], 1), tx);
  const int yl = min(max(y_len[b], 0), ty);
  const float* vb = value + static_cast<size_t>(b) * tx * ty;

  float vcur[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = tid + k * nthr;
    vcur[k] = (k < per_thread && i < tx && yl > 0) ? __ldg(vb + static_cast<size_t>(i) * ty) : 0.f;
  }

  int cur = 0;
  for (int j = 0; j < yl; ++j) {
    float vnext[kMaxPer];
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int i = tid + k * nthr;
      vnext[k] = (k < per_thread && i < tx && j + 1 < yl)
                     ? __ldg(vb + static_cast<size_t>(i) * ty + j + 1)
                     : 0.f;
    }
    const float* fc = f + cur * span;
    float* fn = f + (cur ^ 1) * span;
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      if (k < per_thread) {  // uniform across the block
        const int i = tid + k * nthr;
        if (j == 0) {
          fn[i] = (i == 0) ? vcur[k] : kNegInf;
        } else {
          const float fi = fc[i];
          const float sh = i > 0 ? fc[i - 1] : kNegInf;
          const bool diag = sh >= fi;
          fn[i] = (i < xl) ? vcur[k] + fmaxf(fi, sh) : kNegInf;
          const uint32_t word = __ballot_sync(0xffffffffu, diag);
          const int w = i >> 5;
          if (lane == 0 && w < words) bits[static_cast<size_t>(j) * words + w] = word;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) vcur[k] = vnext[k];
    __syncthreads();
    cur ^= 1;
  }

  int* out = idx + static_cast<size_t>(b) * ty;
  for (int j = yl + tid; j < ty; j += nthr) out[j] = -1;
  if (tid == 0) {
    int cursor = xl - 1;
    for (int j = yl - 1; j >= 0; --j) {
      out[j] = cursor;
      if (j > 0 && cursor > 0 &&
          ((bits[static_cast<size_t>(j) * words + (cursor >> 5)] >> (cursor & 31)) & 1u))
        --cursor;
    }
  }
}

bool takes_warp_kernel(int tx) { return tx <= 32 * kWarpMaxK; }

template <int K>
cudaError_t launch_warp(const float* value, const int* x_len, const int* y_len, int* idx,
                        uint32_t* scratch, int batch, int tx, int ty, const WarpShape& s,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      mas_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s.smem));
  if (err != cudaSuccess) return err;
  // 16-byte copies need Ty % 4 == 0 (every token's row then starts aligned)
  const bool vec16 = ty % 4 == 0 && aligned16(value);
  mas_kernel<K><<<batch, kWarpThreads, s.smem, stream>>>(value, x_len, y_len, idx, scratch, tx, ty,
                                                         s.stages, s.row_words, s.bits_in_smem,
                                                         vec16);
  return cudaSuccess;
}

// the instance of K = ceil(Tx / 32): mas_kernel<1> .. mas_kernel<kWarpMaxK>
template <int K = kWarpMaxK>
cudaError_t launch_k(const float* value, const int* x_len, const int* y_len, int* idx,
                     uint32_t* scratch, int batch, int tx, int ty, const WarpShape& s,
                     cudaStream_t stream) {
  if constexpr (K > 1) {
    if (s.k < K) return launch_k<K - 1>(value, x_len, y_len, idx, scratch, batch, tx, ty, s, stream);
  }
  return launch_warp<K>(value, x_len, y_len, idx, scratch, batch, tx, ty, s, stream);
}

template <int K = kWarpMaxK>
const void* warp_kernel_for(int k) {
  if constexpr (K > 1) {
    if (k < K) return warp_kernel_for<K - 1>(k);
  }
  return reinterpret_cast<const void*>(mas_kernel<K>);
}

}  // namespace

// int32 words of global scratch the launch needs for `batch` rows: 0 when
// the decisions fit in shared memory.
long long mas_scratch_words(int batch, int tx, int ty) {
  if (takes_warp_kernel(tx)) {
    const WarpShape s = warp_shape(tx, ty);
    return s.bits_in_smem ? 0 : static_cast<long long>(batch) * 32 * s.k * s.row_words;
  }
  const WideShape s = wide_shape(tx, ty);
  return s.bits_in_smem ? 0 : static_cast<long long>(batch) * ty * s.words;
}

// Launches on `stream` without synchronising.  Returns the error of the
// shared-memory attribute call, or cudaErrorInvalidValue for a shape the
// kernels do not take; the caller checks cudaGetLastError after it.
cudaError_t mas_launch(const float* value, const int* x_len, const int* y_len, int* idx,
                       uint32_t* scratch, int batch, int tx, int ty, cudaStream_t stream) {
  if (tx < 1 || ty < 1) return cudaErrorInvalidValue;
  if (takes_warp_kernel(tx)) {
    const WarpShape s = warp_shape(tx, ty);
    if (!s.bits_in_smem && scratch == nullptr) return cudaErrorInvalidValue;
    return launch_k(value, x_len, y_len, idx, scratch, batch, tx, ty, s, stream);
  }
  const WideShape s = wide_shape(tx, ty);
  if (s.per_thread > kMaxPer) return cudaErrorInvalidValue;
  if (!s.bits_in_smem && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = s.f_bytes + (s.bits_in_smem ? s.bit_bytes : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      mas_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mas_wide_kernel<<<batch, s.threads, smem, stream>>>(value, x_len, y_len, idx, scratch, tx, ty,
                                                      s.per_thread, s.words, s.bits_in_smem);
  return cudaSuccess;
}

// Registers, static and dynamic shared memory, local (spill) bytes and the
// thread count of the kernel that serves (tx, ty); out[6], out[5] = 1 for
// the warp kernel, 0 for the wide one.  Returns the cudaFuncGetAttributes
// error.
cudaError_t mas_attributes(int tx, int ty, int* out) {
  cudaFuncAttributes fa{};
  const bool warp = takes_warp_kernel(tx);
  const void* fn = warp ? warp_kernel_for(warp_shape(tx, ty).k)
                        : reinterpret_cast<const void*>(mas_wide_kernel);
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  if (warp) {
    const WarpShape s = warp_shape(tx, ty);
    out[2] = static_cast<int>(s.smem);
    out[4] = kWarpThreads;
  } else {
    const WideShape s = wide_shape(tx, ty);
    out[2] = static_cast<int>(s.f_bytes + (s.bits_in_smem ? s.bit_bytes : 0));
    out[4] = s.threads;
  }
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[5] = warp ? 1 : 0;
  return err;
}

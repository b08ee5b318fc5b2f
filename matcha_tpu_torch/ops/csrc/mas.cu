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
// chain of Ty dependent frames, each a barrier and a shared-memory
// round trip.  The TPU kernel carries f across a sequential grid; here a
// loop over frames inside the block takes its place, and the batch rows run
// in parallel on the SMs.  Threads stride over tokens; f is double-buffered
// in shared memory with one barrier per frame; each warp packs its 32
// decisions into one word with __ballot_sync.  The decisions stay in shared
// memory when Ty*ceil(Tx/32)*4 bytes fit beside f under the 227 KB opt-in
// limit (28 KB at (224, 1024), 119 KB at (448, 2176)), else they go to a
// global scratch buffer the wrapper allocates.  The backtrack is one thread
// walking the bits.  One frame's column is strided by Ty in memory; the
// next frame's values are loaded into registers while the current frame is
// computed, and each 32-byte sector serves eight frames from L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 8;  // tokens per thread: Tx <= 8192
constexpr size_t kMaxSmem = 232448;

struct MasShape {
  int threads, per_thread, words;
  size_t f_bytes, bit_bytes;
  bool bits_in_smem;
};

MasShape mas_shape(int tx, int ty) {
  MasShape s;
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
mas_kernel(const float* __restrict__ value, const int* __restrict__ x_len,
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

}  // namespace

// int32 words of global scratch the launch needs for `batch` rows: 0 when
// the decisions fit in shared memory.
long long mas_scratch_words(int batch, int tx, int ty) {
  const MasShape s = mas_shape(tx, ty);
  return s.bits_in_smem ? 0 : static_cast<long long>(batch) * ty * s.words;
}

// Launches on `stream` without synchronising.  Returns the error of the
// shared-memory attribute call, or cudaErrorInvalidValue for a shape the
// kernel does not take; the caller checks cudaGetLastError after it.
cudaError_t mas_launch(const float* value, const int* x_len, const int* y_len, int* idx,
                       uint32_t* scratch, int batch, int tx, int ty, cudaStream_t stream) {
  const MasShape s = mas_shape(tx, ty);
  if (tx < 1 || ty < 1 || s.per_thread > kMaxPer) return cudaErrorInvalidValue;
  if (!s.bits_in_smem && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = s.f_bytes + (s.bits_in_smem ? s.bit_bytes : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mas_kernel<<<batch, s.threads, smem, stream>>>(value, x_len, y_len, idx, scratch, tx, ty,
                                                 s.per_thread, s.words, s.bits_in_smem);
  return cudaSuccess;
}

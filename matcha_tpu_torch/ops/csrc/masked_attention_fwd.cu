// Masked self-attention forward for Hopper (sm_90a): out = softmax(q·kᵀ/√D
// over the valid keys)·v, streamed over key tiles so the (T, T) logits never
// reach device memory.
//
// Replaces the Pallas TPU flash-attention forward that the JAX package
// reaches from matcha_tpu/ops/attention.py:117-132 (masked_self_attention,
// flash branch; kernel jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel).  Same contract: padded keys (key_valid == 0) are
// left out of every softmax, every query row (valid or padded) attends the
// same valid keys, running max / sum / accumulator are fp32 and the output is
// in v's dtype.
//
// What bounds it on the card: at the shapes of the synthesis path
// (B=16, H=5..6, T=256..512, D=48..64, bf16) the work is 4·B·H·T²·D flops
// against 4·B·H·T·D·2 bytes of q, k, v and out.  At the H100's peaks the
// bytes take slightly longer (6.3 µs against 5.4 µs at T=512), so the two
// bounds are within a factor of two: the kernel has to keep the logits out
// of device memory and feed the tensor cores.  What the design does:
//
//   bf16  (the serving path)  FlashAttention-2 layout on mma.sync
//         m16n8k16 (bf16 in, fp32 accumulate): one block of 4 warps per
//         (64 query rows, head, batch row), each warp owning 16 rows; k/v
//         tiles of 64 keys staged in shared memory; S = Q·Kᵀ and the
//         running output stay in registers, P is rounded to bf16 for P·V
//         as the JAX einsum path rounds its weights to v's dtype.
//   fp32  exact fp32 FMAs (no tf32, no bf16 downcast): one block per 32
//         query rows, 4 threads per row, each over every 4th key with its
//         own online-softmax state, merged by warp shuffles at the end.
//
// wgmma, TMA and a pipelined producer warp are later work.  Any T works:
// the tail of the last tile is masked here.  Head dims up to 128 are padded
// with zeros (to a multiple of 16 for bf16, of 4 for fp32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// log2 of a row's softmax denominator, sum_k exp2(s_k) = exp2(m) * l: the
// backward recomputes p = exp2(s - lse).  A row with no valid key (l = 0)
// gets +inf, so every p of its backward is 0.
__device__ __forceinline__ float lse_log2(float m, float l) {
  return l > 0.f ? m + log2f(l) : INFINITY;
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kRows = 32;                 // query rows per block
constexpr int kSplit = 4;                 // threads per query row
constexpr int kThreads = kRows * kSplit;  // 128

template <int DP>
__global__ void __launch_bounds__(kThreads)
masked_attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v,
                                const uint8_t* __restrict__ key_valid,
                                float* __restrict__ out, float* __restrict__ lse,
                                int n_heads, int seq, int dim, float qk_scale_log2) {
  // keys per shared-memory tile: two fp32 tiles stay under 48 KB
  constexpr int kKeys = DP <= 64 ? 64 : 32;
  constexpr int kPer = kKeys / kSplit;  // keys per thread per tile
  // row stride in floats: +4 puts the 4 rows that one 16-byte load phase
  // reads (keys s, s+1, s+2, s+3) on different banks
  constexpr int kStride = DP + 4;
  __shared__ __align__(16) float ks[kKeys * kStride];
  __shared__ __align__(16) float vs[kKeys * kStride];
  __shared__ bool key_ok[kKeys];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / kSplit;
  const int s = tid % kSplit;
  const int qi = blockIdx.x * kRows + r;
  const size_t head = (static_cast<size_t>(b) * n_heads + h) * static_cast<size_t>(seq) * dim;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;

  // the query row, pre-scaled so that exp2 of a logit is the softmax weight
  float qr[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d)
    qr[d] = (qi < seq && d < dim) ? qh[static_cast<size_t>(qi) * dim + d] * qk_scale_log2 : 0.f;

  float acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max (log2 units) over this thread's keys
  float l = 0.f;        // running sum of exp2(logit - m)

  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kKeys * DP; idx += kThreads) {
      const int j = idx / DP;
      const int d = idx - j * DP;
      const int key = k0 + j;
      const bool in = key < seq && d < dim;
      const size_t off = static_cast<size_t>(key) * dim + d;
      ks[j * kStride + d] = in ? kh[off] : 0.f;
      vs[j * kStride + d] = in ? vh[off] : 0.f;
    }
    if (tid < kKeys) key_ok[tid] = (k0 + tid < seq) && valid[k0 + tid] != 0;
    __syncthreads();

    float sc[kPer];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = s + kSplit * i;
      const float4* kr = reinterpret_cast<const float4*>(ks + j * kStride);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      sc[i] = key_ok[j] ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, sc[i]);
    }
    if (tile_max == -INFINITY) continue;  // no valid key of this thread here

    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);  // 0 while m is still -inf
    l *= corr;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= corr;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float p = exp2f(sc[i] - m_new);  // masked keys: exp2(-inf) = 0
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + (s + kSplit * i) * kStride);
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  // merge the kSplit partial softmax states of this row (adjacent lanes)
  float m_row = m;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));
  const float f = (m == -INFINITY) ? 0.f : exp2f(m - m_row);
  float l_row = l * f;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    l_row += __shfl_xor_sync(0xffffffffu, l_row, off);
  // a row with no valid key at all divides 0 by 0, as the plain version does
  const float inv = 1.f / l_row;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    float a = acc[d] * f;
#pragma unroll
    for (int off = 1; off < kSplit; off <<= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    acc[d] = a;
  }
  if (qi < seq) {
    float* orow = out + head + static_cast<size_t>(qi) * dim;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d % kSplit == s && d < dim) orow[d] = acc[d] * inv;
    if (lse != nullptr && s == 0)
      lse[head / dim + qi] = lse_log2(m_row, l_row);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, fp32 accumulate
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per shared-memory tile

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values → one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layouts of m16n8k16 (lane = 4·g + t):
//   A (16x16, row-major): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)
//                         a3 (g+8, 8+2t..)
//   B (16x8, k-major):    b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C (16x8):             c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
template <int DP>
__global__ void __launch_bounds__(32 * kWarps)
masked_attention_fwd_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                                 const uint16_t* __restrict__ v,
                                 const uint8_t* __restrict__ key_valid,
                                 uint16_t* __restrict__ out, float* __restrict__ lse,
                                 int n_heads, int seq, int dim, float qk_scale_log2,
                                 bool vec16) {
  constexpr int kSteps = DP / 16;       // k-steps of Q·Kᵀ over the head dim
  constexpr int kKeyTiles = kBlockK / 8;
  constexpr int kDimTiles = DP / 8;
  // row stride in bf16: +8 staggers the 8 rows a fragment load touches
  // across all 32 banks
  constexpr int kStride = DP + 8;
  __shared__ __align__(16) uint16_t ks[kBlockK * kStride];
  __shared__ __align__(16) uint16_t vs[kBlockK * kStride];
  __shared__ float key_bias[kBlockK];  // 0 for a valid key, -inf otherwise

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kBlockQ + (tid >> 5) * 16;
  const size_t head = (static_cast<size_t>(b) * n_heads + h) * static_cast<size_t>(seq) * dim;
  const uint16_t* qh = q + head;
  const uint16_t* kh = k + head;
  const uint16_t* vh = v + head;
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;

  // this warp's 16 query rows as A fragments, straight from global memory
  auto q_at = [&](int r, int c) -> uint16_t {
    return (r < seq && c < dim) ? qh[static_cast<size_t>(r) * dim + c] : uint16_t(0);
  };
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = pack_raw(q_at(row0 + g, c), q_at(row0 + g, c + 1));
    qa[kk][1] = pack_raw(q_at(row0 + g + 8, c), q_at(row0 + g + 8, c + 1));
    qa[kk][2] = pack_raw(q_at(row0 + g, c + 8), q_at(row0 + g, c + 9));
    qa[kk][3] = pack_raw(q_at(row0 + g + 8, c + 8), q_at(row0 + g + 8, c + 9));
  }

  float o[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g and g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sums

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    if (vec16) {      // dim % 8 == 0 and 16-byte aligned rows: 8 values a load
      constexpr int kChunks = DP / 8;
      for (int idx = tid; idx < kBlockK * kChunks; idx += 32 * kWarps) {
        const int j = idx / kChunks;
        const int c = (idx - j * kChunks) * 8;
        const int key = k0 + j;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (key < seq && c < dim) {
          const size_t off = static_cast<size_t>(key) * dim + c;
          kv = *reinterpret_cast<const uint4*>(kh + off);
          vv = *reinterpret_cast<const uint4*>(vh + off);
        }
        *reinterpret_cast<uint4*>(ks + j * kStride + c) = kv;
        *reinterpret_cast<uint4*>(vs + j * kStride + c) = vv;
      }
    } else {
      for (int idx = tid; idx < kBlockK * DP; idx += 32 * kWarps) {
        const int j = idx / DP;
        const int c = idx - j * DP;
        const int key = k0 + j;
        const bool in = key < seq && c < dim;
        const size_t off = static_cast<size_t>(key) * dim + c;
        ks[j * kStride + c] = in ? kh[off] : uint16_t(0);
        vs[j * kStride + c] = in ? vh[off] : uint16_t(0);
      }
    }
    if (tid < kBlockK)
      key_bias[tid] = (k0 + tid < seq && valid[k0 + tid] != 0) ? 0.f : -INFINITY;
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows x 64 keys
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint16_t* krow = ks + (j * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[j], qa[kk], b0, b1);
      }
    }

    // scale to log2 units, mask, online softmax over rows g and g+8
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const float bias0 = key_bias[j * 8 + 2 * t];
      const float bias1 = key_bias[j * 8 + 2 * t + 1];
      s[j][0] = fmaf(s[j][0], qk_scale_log2, bias0);
      s[j][1] = fmaf(s[j][1], qk_scale_log2, bias1);
      s[j][2] = fmaf(s[j][2], qk_scale_log2, bias0);
      s[j][3] = fmaf(s[j][3], qk_scale_log2, bias1);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // a row with no valid key so far keeps p = 0 (never exp2(-inf + inf))
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float c0 = exp2f(m0 - base0);
    const float c1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }

    // O += P·V, 16 keys per step; P's C-fragments are the next A-fragment
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const float* sa = s[2 * kk];
      const float* sb = s[2 * kk + 1];
      const float p00 = exp2f(sa[0] - base0), p01 = exp2f(sa[1] - base0);
      const float p02 = exp2f(sa[2] - base1), p03 = exp2f(sa[3] - base1);
      const float p10 = exp2f(sb[0] - base0), p11 = exp2f(sb[1] - base0);
      const float p12 = exp2f(sb[2] - base1), p13 = exp2f(sb[3] - base1);
      l0 += (p00 + p01) + (p10 + p11);
      l1 += (p02 + p03) + (p12 + p13);
      const uint32_t pa[4] = {pack_bf16(p00, p01), pack_bf16(p02, p03), pack_bf16(p10, p11),
                              pack_bf16(p12, p13)};
      const uint16_t* vrow = vs + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int j = 0; j < kDimTiles; ++j) {
        const uint16_t* vc = vrow + j * 8;
        const uint32_t b0 = pack_raw(vc[0], vc[kStride]);
        const uint32_t b1 = pack_raw(vc[8 * kStride], vc[9 * kStride]);
        mma_16816(o[j], pa, b0, b1);
      }
    }
  }

  // a row with no valid key at all divides 0 by 0, as the plain version does
  const float sum0 = quad_sum(l0);
  const float sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0;
  const float inv1 = 1.f / sum1;
  const int r0 = row0 + g;
  const int r1 = row0 + g + 8;
  if (lse != nullptr && t == 0) {
    float* lh = lse + head / dim;
    if (r0 < seq) lh[r0] = lse_log2(m0, sum0);
    if (r1 < seq) lh[r1] = lse_log2(m1, sum1);
  }
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) {
    const int c = j * 8 + 2 * t;
    const __nv_bfloat162 w0 = __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    const __nv_bfloat162 w1 = __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
    const uint32_t u0 = *reinterpret_cast<const uint32_t*>(&w0);
    const uint32_t u1 = *reinterpret_cast<const uint32_t*>(&w1);
    if (r0 < seq) {
      uint16_t* orow = out + head + static_cast<size_t>(r0) * dim;
      if (c < dim) orow[c] = static_cast<uint16_t>(u0 & 0xffffu);
      if (c + 1 < dim) orow[c + 1] = static_cast<uint16_t>(u0 >> 16);
    }
    if (r1 < seq) {
      uint16_t* orow = out + head + static_cast<size_t>(r1) * dim;
      if (c < dim) orow[c] = static_cast<uint16_t>(u1 & 0xffffu);
      if (c + 1 < dim) orow[c + 1] = static_cast<uint16_t>(u1 >> 16);
    }
  }
}

template <int DP>
void launch_f32(const void* q, const void* k, const void* v, const uint8_t* key_valid, void* out,
                float* lse, int batch, int n_heads, int seq, int dim, float qk_scale_log2,
                cudaStream_t stream) {
  const dim3 grid((seq + kRows - 1) / kRows, n_heads, batch);
  masked_attention_fwd_f32_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      key_valid, static_cast<float*>(out), lse, n_heads, seq, dim, qk_scale_log2);
}

template <int DP>
void launch_bf16(const void* q, const void* k, const void* v, const uint8_t* key_valid,
                 void* out, float* lse, int batch, int n_heads, int seq, int dim,
                 float qk_scale_log2, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec16 = dim % 8 == 0 && aligned(k) && aligned(v);
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, n_heads, batch);
  masked_attention_fwd_bf16_kernel<DP><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), key_valid, static_cast<uint16_t*>(out), lse, n_heads, seq,
      dim, qk_scale_log2, vec16);
}

}  // namespace

// Launches on `stream` without synchronising.  Returns false, launching
// nothing, for a head dim outside [1, 128]; the caller checks
// cudaGetLastError.  `lse` (B, H, T) fp32, or null: the log-sum-exp of each
// row's scaled logits in log2 units, which the backward kernels read.
bool masked_attention_fwd_launch(const void* q, const void* k, const void* v,
                                 const uint8_t* key_valid, void* out, float* lse, int batch,
                                 int n_heads, int seq, int dim, bool bf16,
                                 float qk_scale_log2, cudaStream_t stream) {
#define MATCHA_ARGS q, k, v, key_valid, out, lse, batch, n_heads, seq, dim, qk_scale_log2, stream
  if (dim < 1 || dim > 128) return false;
  if (bf16) {
    if (dim <= 16) launch_bf16<16>(MATCHA_ARGS);
    else if (dim <= 32) launch_bf16<32>(MATCHA_ARGS);
    else if (dim <= 48) launch_bf16<48>(MATCHA_ARGS);
    else if (dim <= 64) launch_bf16<64>(MATCHA_ARGS);
    else if (dim <= 96) launch_bf16<96>(MATCHA_ARGS);
    else launch_bf16<128>(MATCHA_ARGS);
  } else {
    if (dim <= 8) launch_f32<8>(MATCHA_ARGS);
    else if (dim <= 16) launch_f32<16>(MATCHA_ARGS);
    else if (dim <= 32) launch_f32<32>(MATCHA_ARGS);
    else if (dim <= 48) launch_f32<48>(MATCHA_ARGS);
    else if (dim <= 64) launch_f32<64>(MATCHA_ARGS);
    else if (dim <= 96) launch_f32<96>(MATCHA_ARGS);
    else launch_f32<128>(MATCHA_ARGS);
  }
#undef MATCHA_ARGS
  return true;
}

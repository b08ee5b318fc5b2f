// Masked self-attention backward for Hopper (sm_90a): dq, dk, dv of
// out = softmax(q·kᵀ/√D over the valid keys)·v.
//
// Replaces the Pallas TPU flash-attention backward that the JAX package
// differentiates through (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv at :1121 and _flash_attention_bwd_dq at :1456).
// Same split: one kernel per key tile loops over the query tiles for dk, dv;
// one kernel per query tile loops over the key tiles for dq; no atomics.
// P is recomputed from q, k and the forward's log-sum-exp (log2 units, see
// masked_attention_fwd.cu); D_i = rowsum(dO∘O) arrives precomputed in fp32,
// as the TPU wrapper computes it outside its kernels:
//   S = q·kᵀ, P = exp2(S·scale·log2e − lse), dV = Pᵀ·dO, dP = dO·vᵀ,
//   dS = P∘(dP − D), dQ = scale·dS·k, dK = scale·dSᵀ·q.
// Padded keys get dk = dv = 0; every query row, padded or not, back-
// propagates through the valid keys it attended, as in the forward.
//
// What bounds it on the card: at the decoder's training shapes
// (B=29..62, H=5, T=256..1088, D=64, bf16) the work is 10·B·H·T²·D flops
// (five products) against about 8·B·H·T·D·2 bytes, so the tensor cores and
// not the memory set the bound.  What the design does:
//
//   bf16  mma.sync m16n8k16 (bf16 in, fp32 accumulate) for every product,
//         4 warps of 16 rows per block.  dkv: a block owns 64 keys and keeps
//         k, v as A fragments in registers, computes Sᵀ and dPᵀ per tile of
//         32 queries and feeds Pᵀ and dSᵀ straight from the accumulator
//         fragments into dV += Pᵀ·dO and dK += dSᵀ·q.  dq: a block owns 64
//         queries, keeps q and dO as A fragments, and streams 64-key tiles.
//   fp32  exact fp32 FMAs (no TF32): a block owns 16 rows, 8 threads per
//         row each holding every 8th head dim; row dot products are reduced
//         by warp shuffles.
//
// wgmma, TMA and pipelining are later work.  Any T works (tails masked);
// head dims up to 128 are padded with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kLanes = 8;                   // threads per owned row
constexpr int kOwnRows = 16;                // owned rows per block
constexpr int kThreadsF = kOwnRows * kLanes;  // 128
constexpr int kTileF = 32;                  // streamed rows per shared tile

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF)
attn_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const uint8_t* __restrict__ key_valid, float* __restrict__ dk,
                        float* __restrict__ dv, int n_heads, int seq, int dim, float scale,
                        float scale_log2) {
  constexpr int kPer = DP / kLanes;
  __shared__ __align__(16) float qs[kTileF * DP];
  __shared__ __align__(16) float dos[kTileF * DP];
  __shared__ float ls[kTileF];
  __shared__ float dls[kTileF];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int s = tid % kLanes;
  const int key = blockIdx.x * kOwnRows + tid / kLanes;
  const size_t rows = (static_cast<size_t>(b) * n_heads + h) * static_cast<size_t>(seq);
  const size_t head = rows * dim;
  const bool key_ok = key < seq && key_valid[static_cast<size_t>(b) * seq + key] != 0;

  float kr[kPer], vr[kPer], dka[kPer], dva[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int d = s + kLanes * m;
    const bool in = key < seq && d < dim;
    const size_t off = head + static_cast<size_t>(key) * dim + d;
    kr[m] = in ? k[off] : 0.f;
    vr[m] = in ? v[off] : 0.f;
    dka[m] = dva[m] = 0.f;
  }

  for (int q0 = 0; q0 < seq; q0 += kTileF) {
    __syncthreads();
    for (int idx = tid; idx < kTileF * DP; idx += kThreadsF) {
      const int j = idx / DP;
      const int d = idx - j * DP;
      const int qi = q0 + j;
      const bool in = qi < seq && d < dim;
      const size_t off = head + static_cast<size_t>(qi) * dim + d;
      qs[idx] = in ? q[off] : 0.f;
      dos[idx] = in ? dout[off] : 0.f;
    }
    if (tid < kTileF) {
      const int qi = q0 + tid;
      ls[tid] = qi < seq ? lse[rows + qi] : INFINITY;
      dls[tid] = qi < seq ? delta[rows + qi] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kTileF; ++j) {
      const float* qrow = qs + j * DP;
      const float* drow = dos + j * DP;
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        sp = fmaf(kr[m], qrow[s + kLanes * m], sp);
        dp = fmaf(vr[m], drow[s + kLanes * m], dp);
      }
      sp = group_sum(sp);
      dp = group_sum(dp);
      const float p = key_ok ? exp2f(fmaf(sp, scale_log2, -ls[j])) : 0.f;
      const float ds = p * (dp - dls[j]);
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        dva[m] = fmaf(p, drow[s + kLanes * m], dva[m]);
        dka[m] = fmaf(ds, qrow[s + kLanes * m], dka[m]);
      }
    }
  }

  if (key < seq) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int d = s + kLanes * m;
      if (d < dim) {
        const size_t off = head + static_cast<size_t>(key) * dim + d;
        dk[off] = dka[m] * scale;
        dv[off] = dva[m];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const uint8_t* __restrict__ key_valid, float* __restrict__ dq,
                       int n_heads, int seq, int dim, float scale, float scale_log2) {
  constexpr int kPer = DP / kLanes;
  __shared__ __align__(16) float ks[kTileF * DP];
  __shared__ __align__(16) float vs[kTileF * DP];
  __shared__ bool key_ok[kTileF];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int s = tid % kLanes;
  const int qi = blockIdx.x * kOwnRows + tid / kLanes;
  const size_t rows = (static_cast<size_t>(b) * n_heads + h) * static_cast<size_t>(seq);
  const size_t head = rows * dim;
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;
  const float lse_row = qi < seq ? lse[rows + qi] : INFINITY;
  const float delta_row = qi < seq ? delta[rows + qi] : 0.f;

  float qr[kPer], dor[kPer], dqa[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int d = s + kLanes * m;
    const bool in = qi < seq && d < dim;
    const size_t off = head + static_cast<size_t>(qi) * dim + d;
    qr[m] = in ? q[off] : 0.f;
    dor[m] = in ? dout[off] : 0.f;
    dqa[m] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kTileF) {
    __syncthreads();
    for (int idx = tid; idx < kTileF * DP; idx += kThreadsF) {
      const int j = idx / DP;
      const int d = idx - j * DP;
      const int key = k0 + j;
      const bool in = key < seq && d < dim;
      const size_t off = head + static_cast<size_t>(key) * dim + d;
      ks[idx] = in ? k[off] : 0.f;
      vs[idx] = in ? v[off] : 0.f;
    }
    if (tid < kTileF) key_ok[tid] = (k0 + tid < seq) && valid[k0 + tid] != 0;
    __syncthreads();

    for (int j = 0; j < kTileF; ++j) {
      const float* krow = ks + j * DP;
      const float* vrow = vs + j * DP;
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        sp = fmaf(qr[m], krow[s + kLanes * m], sp);
        dp = fmaf(dor[m], vrow[s + kLanes * m], dp);
      }
      sp = group_sum(sp);
      dp = group_sum(dp);
      const float p = key_ok[j] ? exp2f(fmaf(sp, scale_log2, -lse_row)) : 0.f;
      const float ds = p * (dp - delta_row);
#pragma unroll
      for (int m = 0; m < kPer; ++m) dqa[m] = fmaf(ds, krow[s + kLanes * m], dqa[m]);
    }
  }

  if (qi < seq) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int d = s + kLanes * m;
      if (d < dim) dq[head + static_cast<size_t>(qi) * dim + d] = dqa[m] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, fp32 accumulate
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreadsB = 32 * kWarps;
constexpr int kOwnB = 16 * kWarps;  // owned rows per block (queries or keys)
constexpr int kKeyTile = 64;        // dq: keys per shared tile
constexpr int kQueryTile = 32;      // dkv: queries per shared tile

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t u32_at(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 rows of a (T, dim) head starting at row0 as m16n8k16 A fragments over
// the (padded) head dim: a0 (g, 2t..) a1 (g+8, 2t..) a2 (g, 8+2t..) a3 (g+8, 8+2t..)
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[DP / 16][4], const uint16_t* base,
                                             int row0, int seq, int dim, int g, int t) {
  auto at = [&](int r, int c) -> uint16_t {
    return (r < seq && c < dim) ? base[static_cast<size_t>(r) * dim + c] : uint16_t(0);
  };
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = pack_raw(at(row0 + g, c), at(row0 + g, c + 1));
    a[kk][1] = pack_raw(at(row0 + g + 8, c), at(row0 + g + 8, c + 1));
    a[kk][2] = pack_raw(at(row0 + g, c + 8), at(row0 + g, c + 9));
    a[kk][3] = pack_raw(at(row0 + g + 8, c + 8), at(row0 + g + 8, c + 9));
  }
}

// rows [r0, r0 + n) of two (T, dim) heads into shared tiles of row stride
// DP + 8, zero-padded past seq and dim
template <int DP>
__device__ __forceinline__ void load_tiles(uint16_t* xs, uint16_t* ys, const uint16_t* x,
                                           const uint16_t* y, int r0, int n, int seq, int dim,
                                           bool vec16, int tid) {
  constexpr int kStride = DP + 8;
  if (vec16) {  // dim % 8 == 0 and 16-byte aligned rows: 8 values a load
    constexpr int kChunks = DP / 8;
    for (int idx = tid; idx < n * kChunks; idx += kThreadsB) {
      const int j = idx / kChunks;
      const int c = (idx - j * kChunks) * 8;
      const int r = r0 + j;
      uint4 xv = make_uint4(0, 0, 0, 0), yv = make_uint4(0, 0, 0, 0);
      if (r < seq && c < dim) {
        const size_t off = static_cast<size_t>(r) * dim + c;
        xv = *reinterpret_cast<const uint4*>(x + off);
        yv = *reinterpret_cast<const uint4*>(y + off);
      }
      *reinterpret_cast<uint4*>(xs + j * kStride + c) = xv;
      *reinterpret_cast<uint4*>(ys + j * kStride + c) = yv;
    }
  } else {
    for (int idx = tid; idx < n * DP; idx += kThreadsB) {
      const int j = idx / DP;
      const int c = idx - j * DP;
      const int r = r0 + j;
      const bool in = r < seq && c < dim;
      const size_t off = static_cast<size_t>(r) * dim + c;
      xs[j * kStride + c] = in ? x[off] : uint16_t(0);
      ys[j * kStride + c] = in ? y[off] : uint16_t(0);
    }
  }
}

// Fragment layouts of m16n8k16 (lane = 4·g + t):
//   A (16x16, row-major): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)
//                         a3 (g+8, 8+2t..)
//   B (16x8, k-major):    b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C (16x8):             c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
// Two C tiles of 8 columns are one A fragment over 16 columns, so P and dS
// go from one product's accumulators into the next product's A operand.
template <int DP>
__global__ void __launch_bounds__(kThreadsB)
attn_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const uint8_t* __restrict__ key_valid, uint16_t* __restrict__ dq,
                        int n_heads, int seq, int dim, float scale, float scale_log2,
                        bool vec16) {
  constexpr int kSteps = DP / 16;
  constexpr int kKeyTiles = kKeyTile / 8;
  constexpr int kDimTiles = DP / 8;
  constexpr int kStride = DP + 8;
  __shared__ __align__(16) uint16_t ks[kKeyTile * kStride];
  __shared__ __align__(16) uint16_t vs[kKeyTile * kStride];
  __shared__ float key_bias[kKeyTile];  // 0 for a valid key, -inf otherwise

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kOwnB + (tid >> 5) * 16;
  const size_t rows = (static_cast<size_t>(b) * n_heads + h) * static_cast<size_t>(seq);
  const size_t head = rows * dim;
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;

  uint32_t qa[kSteps][4], da[kSteps][4];
  load_a_frags<DP>(qa, q + head, row0, seq, dim, g, t);
  load_a_frags<DP>(da, dout + head, row0, seq, dim, g, t);
  const int r0 = row0 + g;
  const int r1 = row0 + g + 8;
  const float lse0 = r0 < seq ? lse[rows + r0] : INFINITY;
  const float lse1 = r1 < seq ? lse[rows + r1] : INFINITY;
  const float dl0 = r0 < seq ? delta[rows + r0] : 0.f;
  const float dl1 = r1 < seq ? delta[rows + r1] : 0.f;

  float acc[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kKeyTile) {
    __syncthreads();
    load_tiles<DP>(ks, vs, k + head, v + head, k0, kKeyTile, seq, dim, vec16, tid);
    if (tid < kKeyTile)
      key_bias[tid] = (k0 + tid < seq && valid[k0 + tid] != 0) ? 0.f : -INFINITY;
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 rows x 64 keys
    float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const uint16_t* krow = ks + (j * 8 + g) * kStride + 2 * t;
      const uint16_t* vrow = vs + (j * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        mma_16816(s[j], qa[kk], u32_at(krow + kk * 16), u32_at(krow + kk * 16 + 8));
        mma_16816(dp[j], da[kk], u32_at(vrow + kk * 16), u32_at(vrow + kk * 16 + 8));
      }
    }

    // dS = P∘(dP − D), in place of S
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const float bias0 = key_bias[j * 8 + 2 * t];
      const float bias1 = key_bias[j * 8 + 2 * t + 1];
      const float p0 = exp2f(fmaf(s[j][0], scale_log2, bias0) - lse0);
      const float p1 = exp2f(fmaf(s[j][1], scale_log2, bias1) - lse0);
      const float p2 = exp2f(fmaf(s[j][2], scale_log2, bias0) - lse1);
      const float p3 = exp2f(fmaf(s[j][3], scale_log2, bias1) - lse1);
      s[j][0] = p0 * (dp[j][0] - dl0);
      s[j][1] = p1 * (dp[j][1] - dl0);
      s[j][2] = p2 * (dp[j][2] - dl1);
      s[j][3] = p3 * (dp[j][3] - dl1);
    }

    // dQ += dS·K, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      const float* sa = s[2 * kk];
      const float* sb = s[2 * kk + 1];
      const uint32_t a[4] = {pack_bf16(sa[0], sa[1]), pack_bf16(sa[2], sa[3]),
                             pack_bf16(sb[0], sb[1]), pack_bf16(sb[2], sb[3])};
      const uint16_t* krow = ks + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int j = 0; j < kDimTiles; ++j) {
        const uint16_t* kc = krow + j * 8;
        mma_16816(acc[j], a, pack_raw(kc[0], kc[kStride]), pack_raw(kc[8 * kStride], kc[9 * kStride]));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) {
    const int c = j * 8 + 2 * t;
    const __nv_bfloat162 w0 = __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
    const __nv_bfloat162 w1 = __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
    const uint32_t u0 = *reinterpret_cast<const uint32_t*>(&w0);
    const uint32_t u1 = *reinterpret_cast<const uint32_t*>(&w1);
    if (r0 < seq) {
      uint16_t* row = dq + head + static_cast<size_t>(r0) * dim;
      if (c < dim) row[c] = static_cast<uint16_t>(u0 & 0xffffu);
      if (c + 1 < dim) row[c + 1] = static_cast<uint16_t>(u0 >> 16);
    }
    if (r1 < seq) {
      uint16_t* row = dq + head + static_cast<size_t>(r1) * dim;
      if (c < dim) row[c] = static_cast<uint16_t>(u1 & 0xffffu);
      if (c + 1 < dim) row[c + 1] = static_cast<uint16_t>(u1 >> 16);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsB)
attn_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const uint8_t* __restrict__ key_valid, uint16_t* __restrict__ dk,
                         uint16_t* __restrict__ dv, int n_heads, int seq, int dim, float scale,
                         float scale_log2, bool vec16) {
  constexpr int kSteps = DP / 16;
  constexpr int kQTiles = kQueryTile / 8;
  constexpr int kDimTiles = DP / 8;
  constexpr int kStride = DP + 8;
  __shared__ __align__(16) uint16_t qs[kQueryTile * kStride];
  __shared__ __align__(16) uint16_t dos[kQueryTile * kStride];
  __shared__ float ls[kQueryTile];
  __shared__ float dls[kQueryTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = blockIdx.x * kOwnB + (tid >> 5) * 16;
  const size_t rows = (static_cast<size_t>(b) * n_heads + h) * static_cast<size_t>(seq);
  const size_t head = rows * dim;
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;

  uint32_t ka[kSteps][4], va[kSteps][4];
  load_a_frags<DP>(ka, k + head, key0, seq, dim, g, t);
  load_a_frags<DP>(va, v + head, key0, seq, dim, g, t);
  const int kr0 = key0 + g;
  const int kr1 = key0 + g + 8;
  const bool ok0 = kr0 < seq && valid[kr0] != 0;
  const bool ok1 = kr1 < seq && valid[kr1] != 0;

  float dka[kDimTiles][4], dva[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  for (int q0 = 0; q0 < seq; q0 += kQueryTile) {
    __syncthreads();
    load_tiles<DP>(qs, dos, q + head, dout + head, q0, kQueryTile, seq, dim, vec16, tid);
    if (tid < kQueryTile) {
      const int qi = q0 + tid;
      ls[tid] = qi < seq ? lse[rows + qi] : INFINITY;
      dls[tid] = qi < seq ? delta[rows + qi] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 keys x 32 queries
    float st[kQTiles][4], dpt[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      const uint16_t* qrow = qs + (j * 8 + g) * kStride + 2 * t;
      const uint16_t* drow = dos + (j * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        mma_16816(st[j], ka[kk], u32_at(qrow + kk * 16), u32_at(qrow + kk * 16 + 8));
        mma_16816(dpt[j], va[kk], u32_at(drow + kk * 16), u32_at(drow + kk * 16 + 8));
      }
    }

    // Pᵀ in place of Sᵀ, dSᵀ = Pᵀ∘(dPᵀ − D) in place of dPᵀ
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
      const int qa = j * 8 + 2 * t;
      const float la = ls[qa], lb = ls[qa + 1];
      const float da = dls[qa], db = dls[qa + 1];
      const float p0 = ok0 ? exp2f(fmaf(st[j][0], scale_log2, -la)) : 0.f;
      const float p1 = ok0 ? exp2f(fmaf(st[j][1], scale_log2, -lb)) : 0.f;
      const float p2 = ok1 ? exp2f(fmaf(st[j][2], scale_log2, -la)) : 0.f;
      const float p3 = ok1 ? exp2f(fmaf(st[j][3], scale_log2, -lb)) : 0.f;
      st[j][0] = p0;
      st[j][1] = p1;
      st[j][2] = p2;
      st[j][3] = p3;
      dpt[j][0] = p0 * (dpt[j][0] - da);
      dpt[j][1] = p1 * (dpt[j][1] - db);
      dpt[j][2] = p2 * (dpt[j][2] - da);
      dpt[j][3] = p3 * (dpt[j][3] - db);
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q, 16 queries per step
#pragma unroll
    for (int kk = 0; kk < kQueryTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
      const uint16_t* drow = dos + (kk * 16 + 2 * t) * kStride + g;
      const uint16_t* qrow = qs + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int j = 0; j < kDimTiles; ++j) {
        const uint16_t* dc = drow + j * 8;
        const uint16_t* qc = qrow + j * 8;
        mma_16816(dva[j], pa, pack_raw(dc[0], dc[kStride]), pack_raw(dc[8 * kStride], dc[9 * kStride]));
        mma_16816(dka[j], sa, pack_raw(qc[0], qc[kStride]), pack_raw(qc[8 * kStride], qc[9 * kStride]));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) {
    const int c = j * 8 + 2 * t;
    const __nv_bfloat162 k0v = __floats2bfloat162_rn(dka[j][0] * scale, dka[j][1] * scale);
    const __nv_bfloat162 k1v = __floats2bfloat162_rn(dka[j][2] * scale, dka[j][3] * scale);
    const __nv_bfloat162 v0v = __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    const __nv_bfloat162 v1v = __floats2bfloat162_rn(dva[j][2], dva[j][3]);
    const uint32_t uk0 = *reinterpret_cast<const uint32_t*>(&k0v);
    const uint32_t uk1 = *reinterpret_cast<const uint32_t*>(&k1v);
    const uint32_t uv0 = *reinterpret_cast<const uint32_t*>(&v0v);
    const uint32_t uv1 = *reinterpret_cast<const uint32_t*>(&v1v);
    if (kr0 < seq) {
      const size_t off = head + static_cast<size_t>(kr0) * dim;
      if (c < dim) { dk[off + c] = static_cast<uint16_t>(uk0 & 0xffffu); dv[off + c] = static_cast<uint16_t>(uv0 & 0xffffu); }
      if (c + 1 < dim) { dk[off + c + 1] = static_cast<uint16_t>(uk0 >> 16); dv[off + c + 1] = static_cast<uint16_t>(uv0 >> 16); }
    }
    if (kr1 < seq) {
      const size_t off = head + static_cast<size_t>(kr1) * dim;
      if (c < dim) { dk[off + c] = static_cast<uint16_t>(uk1 & 0xffffu); dv[off + c] = static_cast<uint16_t>(uv1 & 0xffffu); }
      if (c + 1 < dim) { dk[off + c + 1] = static_cast<uint16_t>(uk1 >> 16); dv[off + c + 1] = static_cast<uint16_t>(uv1 >> 16); }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const uint8_t* key_valid;
  int batch, n_heads, seq, dim;
  float scale, scale_log2;
  bool vec16;
  cudaStream_t stream;
};

template <int DP>
void launch_dkv_f32(const BwdArgs& a, void* dk, void* dv) {
  const dim3 grid((a.seq + kOwnRows - 1) / kOwnRows, a.n_heads, a.batch);
  attn_bwd_dkv_f32_kernel<DP><<<grid, kThreadsF, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.key_valid, static_cast<float*>(dk), static_cast<float*>(dv), a.n_heads, a.seq, a.dim,
      a.scale, a.scale_log2);
}

template <int DP>
void launch_dq_f32(const BwdArgs& a, void* dq) {
  const dim3 grid((a.seq + kOwnRows - 1) / kOwnRows, a.n_heads, a.batch);
  attn_bwd_dq_f32_kernel<DP><<<grid, kThreadsF, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.key_valid, static_cast<float*>(dq), a.n_heads, a.seq, a.dim, a.scale, a.scale_log2);
}

template <int DP>
void launch_dkv_bf16(const BwdArgs& a, void* dk, void* dv) {
  const dim3 grid((a.seq + kOwnB - 1) / kOwnB, a.n_heads, a.batch);
  attn_bwd_dkv_bf16_kernel<DP><<<grid, kThreadsB, 0, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.dout), a.lse, a.delta,
      a.key_valid, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), a.n_heads, a.seq,
      a.dim, a.scale, a.scale_log2, a.vec16);
}

template <int DP>
void launch_dq_bf16(const BwdArgs& a, void* dq) {
  const dim3 grid((a.seq + kOwnB - 1) / kOwnB, a.n_heads, a.batch);
  attn_bwd_dq_bf16_kernel<DP><<<grid, kThreadsB, 0, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.dout), a.lse, a.delta,
      a.key_valid, static_cast<uint16_t*>(dq), a.n_heads, a.seq, a.dim, a.scale, a.scale_log2,
      a.vec16);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, const uint8_t* key_valid, int batch,
                  int n_heads, int seq, int dim, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  BwdArgs a{q, k, v, dout, lse, delta, key_valid, batch, n_heads, seq, dim, 0.f, 0.f, false, stream};
  const double scale = 1.0 / sqrt(static_cast<double>(dim));
  a.scale = static_cast<float>(scale);
  a.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  a.vec16 = dim % 8 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(dout);
  return a;
}

}  // namespace

// Launch on `stream` without synchronising.  Return false, launching
// nothing, for a head dim outside [1, 128]; the caller checks
// cudaGetLastError.  q, k, v, dout, dq, dk, dv: contiguous (B, H, T, D) in
// one dtype; lse, delta: (B, H, T) fp32; key_valid: (B, T) uint8.
bool masked_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* delta,
                                     const uint8_t* key_valid, void* dk, void* dv, int batch,
                                     int n_heads, int seq, int dim, bool bf16,
                                     cudaStream_t stream) {
  if (dim < 1 || dim > 128) return false;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, key_valid, batch, n_heads, seq, dim, stream);
  if (bf16) {
    if (dim <= 16) launch_dkv_bf16<16>(a, dk, dv);
    else if (dim <= 32) launch_dkv_bf16<32>(a, dk, dv);
    else if (dim <= 48) launch_dkv_bf16<48>(a, dk, dv);
    else if (dim <= 64) launch_dkv_bf16<64>(a, dk, dv);
    else if (dim <= 96) launch_dkv_bf16<96>(a, dk, dv);
    else launch_dkv_bf16<128>(a, dk, dv);
  } else {
    if (dim <= 8) launch_dkv_f32<8>(a, dk, dv);
    else if (dim <= 16) launch_dkv_f32<16>(a, dk, dv);
    else if (dim <= 32) launch_dkv_f32<32>(a, dk, dv);
    else if (dim <= 48) launch_dkv_f32<48>(a, dk, dv);
    else if (dim <= 64) launch_dkv_f32<64>(a, dk, dv);
    else if (dim <= 96) launch_dkv_f32<96>(a, dk, dv);
    else launch_dkv_f32<128>(a, dk, dv);
  }
  return true;
}

bool masked_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    const uint8_t* key_valid, void* dq, int batch, int n_heads,
                                    int seq, int dim, bool bf16, cudaStream_t stream) {
  if (dim < 1 || dim > 128) return false;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, key_valid, batch, n_heads, seq, dim, stream);
  if (bf16) {
    if (dim <= 16) launch_dq_bf16<16>(a, dq);
    else if (dim <= 32) launch_dq_bf16<32>(a, dq);
    else if (dim <= 48) launch_dq_bf16<48>(a, dq);
    else if (dim <= 64) launch_dq_bf16<64>(a, dq);
    else if (dim <= 96) launch_dq_bf16<96>(a, dq);
    else launch_dq_bf16<128>(a, dq);
  } else {
    if (dim <= 8) launch_dq_f32<8>(a, dq);
    else if (dim <= 16) launch_dq_f32<16>(a, dq);
    else if (dim <= 32) launch_dq_f32<32>(a, dq);
    else if (dim <= 48) launch_dq_f32<48>(a, dq);
    else if (dim <= 64) launch_dq_f32<64>(a, dq);
    else if (dim <= 96) launch_dq_f32<96>(a, dq);
    else launch_dq_f32<128>(a, dq);
  }
  return true;
}

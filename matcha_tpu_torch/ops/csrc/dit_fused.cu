// The DiT block's memory-bound glue for Hopper (sm_90a): F5-TTS's adaLN
// modulation, RoPE with the head layout, the gated residual with its dropout
// and row mask, and GELU-tanh with its dropout.  A forward and a backward
// kernel each; ops/dit_fused.py wraps them as autograd Functions, and
// models/dit.py calls them on the card.
//
// Replaces no Pallas kernel: the JAX package has no DiT.  In eager PyTorch
// each of these is a chain of elementwise passes over (B, N, 1024) or
// (B, N, 2048) tensors (LayerNorm, then ·(1 + scale), + shift and the cast;
// the fp32 rotation, stack, cast and head transpose; the dropout's divide,
// where, masked_fill, the gate's promoting multiply and the residual add),
// each its own launch and its own round trip through device memory, and
// autograd's backward of each chain as many again.
//
// What bounds them: bytes, far under the card's ~295 FLOP/byte line.  So
// every intermediate stays in registers and every tensor is read once and
// written once, in the dtype the next product or the fp32 carry needs
// (bytes a token and a block at width C, forward / backward):
//   modulate        h fp32 → y (bf16), row mean and rstd      6C / 10C
//   rope_heads      q, k, v (B, N, H·D) ↔ (B, H, N, D)        12C / 12C
//   gated_residual  h + g·y′ fp32, y′ the dropped branch      14C / 8C
//   gelu_dropout    the 2C-wide hidden layer                  16C / 12C
// A thread takes 8 neighbouring elements of a row: one 16-byte load of the
// bf16 operand, two of an fp32 one.
//
// Dropout: the wrapper draws the fp32 uniforms u with torch.rand on the
// step's dropout generator, as layers.dropout draws them, and the kernels
// keep u < keep_p (keep_p = float32(1 - p), the float32 comparison
// layers.dropout makes).  The forward writes the kept elements as bits, one
// byte a thread (bit j: element j of its 8); the backward reads the bits.
//
// Column sums (d(scale), d(shift), d(g): sums over a row's N positions) are
// taken without float atomics, as adamw.cu takes its norm: a block sums its
// tile of rows into its own slot of `partials`, and column_sums adds the
// tiles in order, so a step's gradients are the same on every run.
//
// Arithmetic: fp32, products and sums rounded one by one (__fmul_rn,
// __fadd_rn: nothing contracts into an FMA) where the eager expression
// rounds them so, for the rotation, the modulation and the residual; the
// LayerNorm's statistics are summed in another order than PyTorch's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // elementwise kernels
constexpr int kRowsFwd = 4;        // modulate_fwd: rows a block
constexpr int kSumThreads = 256;   // column_sums
constexpr float kGeluBeta = 0.7978845608028654f;  // sqrt(2 / pi), as PyTorch's GELU-tanh
constexpr float kGeluKappa = 0.044715f;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// (a, b) summed over the block's threads, returned to every thread: the
// shuffle tree, then the warps' sums in order, the same order on every run.
// The two halves of `red` alternate from one call to the next (`parity`):
// a thread writes a half again only after the next call's barrier, which
// every thread reaches after reading it, so one barrier a call suffices.
__device__ __forceinline__ float2 block_sum(float2 v, float2 (*red)[32], int& parity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if ((threadIdx.x & 31) == 0) red[parity][threadIdx.x >> 5] = v;
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    s.x += red[parity][w].x;
    s.y += red[parity][w].y;
  }
  parity ^= 1;
  return s;
}

// ---------------------------------------------------------------------------
// modulate: y = LN₀(h)·(1 + scale) + shift.  A block takes kRowsFwd rows of
// the flattened (B·N, C) carry, a thread 8 columns; the row's mean, then
// its variance, by two block sums (the variance of the centred values).
// ---------------------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(1024)
    modulate_fwd(const float* __restrict__ h, const float* __restrict__ scale,
                 const float* __restrict__ shift, long long ss_stride, OutT* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out, long long rows, int n,
                 int width, float eps) {
  __shared__ float2 red[2][32];
  int parity = 0;
  const int c = threadIdx.x * 8;
  const bool active = c < width;
  int cur_b = -1;
  float sc1[8], sh[8];
  for (int r = 0; r < kRowsFwd; ++r) {
    const long long row = static_cast<long long>(blockIdx.x) * kRowsFwd + r;
    if (row >= rows) break;  // the same for every thread of the block
    const int b = static_cast<int>(row / n);
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (active) {
      load8(h + row * width + c, x);
      if (b != cur_b) {
        load8(scale + b * ss_stride + c, sc1);
        load8(shift + b * ss_stride + c, sh);
#pragma unroll
        for (int j = 0; j < 8; ++j) sc1[j] = __fadd_rn(1.f, sc1[j]);
      }
    }
    cur_b = b;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += x[j];
    const float mean = __fdiv_rn(block_sum(make_float2(s, 0.f), red, parity).x, width);
    float d = 0.f;
    if (active) {
#pragma unroll
      for (int j = 0; j < 8; ++j) d += (x[j] - mean) * (x[j] - mean);
    }
    const float var = __fdiv_rn(block_sum(make_float2(d, 0.f), red, parity).x, width);
    const float rstd = rsqrtf(var + eps);
    if (active) {
      float out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x[j], mean), rstd), sc1[j]), sh[j]);
      store8(y + row * width + c, out);
    }
    if (threadIdx.x == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// dh = rstd·(g − mean_c(g) − x̂·mean_c(g·x̂)), g = dy·(1 + scale), x̂ the
// forward's normalised row; and each tile's column sums of dy·x̂ (d(scale))
// and dy (d(shift)).  Grid (tiles, B); a block walks its tile's rows.
template <typename GradT>
__global__ void __launch_bounds__(1024)
    modulate_bwd(const GradT* __restrict__ dy, const float* __restrict__ h,
                 const float* __restrict__ scale, long long ss_stride,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 float* __restrict__ dh, float* __restrict__ partials, int n, int width,
                 int rows_per_tile) {
  __shared__ float2 red[2][32];
  int parity = 0;
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int c = threadIdx.x * 8;
  const bool active = c < width;
  float sc1[8], dsc[8], dsh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sc1[j] = 1.f, dsc[j] = 0.f, dsh[j] = 0.f;
  if (active) {
    load8(scale + b * ss_stride + c, sc1);
#pragma unroll
    for (int j = 0; j < 8; ++j) sc1[j] = __fadd_rn(1.f, sc1[j]);
  }
  const int first = tile * rows_per_tile;
  const int last = min(first + rows_per_tile, n);
  for (int pos = first; pos < last; ++pos) {
    const long long row = static_cast<long long>(b) * n + pos;
    const float m = mean[row], rs = rstd[row];
    float hv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float dv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (active) {
      load8(h + row * width + c, hv);
      load8(dy + row * width + c, dv);
    }
    float xh[8], g[8];
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xh[j] = (hv[j] - m) * rs;
      g[j] = dv[j] * sc1[j];
      s.x += g[j];
      s.y += g[j] * xh[j];
    }
    s = block_sum(s, red, parity);
    const float a = s.x / width, bb = s.y / width;
    if (active) {
      float out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out[j] = rs * (g[j] - a - xh[j] * bb);
        dsc[j] += dv[j] * xh[j];
        dsh[j] += dv[j];
      }
      store8(dh + row * width + c, out);
    }
  }
  if (active) {
    const long long slot = (static_cast<long long>(b) * tiles + tile) * width + c;
    const long long second = static_cast<long long>(gridDim.y) * tiles * width;
    store8(partials + slot, dsc);
    store8(partials + second + slot, dsh);
  }
}

// out[z, b, c] = Σ_t partials[z, b, t, c], the tiles in order.  Grid
// (ceil(width / kSumThreads), B, arrays).
__global__ void __launch_bounds__(kSumThreads)
    column_sums(const float* __restrict__ partials, float* __restrict__ out, int tiles, int width) {
  const int c = blockIdx.x * kSumThreads + threadIdx.x;
  if (c >= width) return;
  const long long plane = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const float* p = partials + plane * tiles * width + c;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += p[static_cast<long long>(t) * width];
  out[plane * width + c] = s;
}

// ---------------------------------------------------------------------------
// rope_heads: q and k rotated over interleaved pairs by the (N, D/2, 2)
// (cos, sin) table and laid out as (B, H, N, D); v only laid out.  The
// backward rotates back and lays out (B, N, H·D).  One thread: 8 elements
// of one head's row in each of q, k and v.
// ---------------------------------------------------------------------------

template <typename T, bool kBackward>
__global__ void __launch_bounds__(kThreads)
    rope_heads(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ rope, T* __restrict__ oq, T* __restrict__ ok,
               T* __restrict__ ov, long long units, int n, int heads, int dim_head) {
  const long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= units) return;
  const int per_row = heads * dim_head / 8;
  const long long row = u / per_row;
  const int c = static_cast<int>(u % per_row) * 8;
  const int b = static_cast<int>(row / n), pos = static_cast<int>(row % n);
  const int head = c / dim_head, d = c % dim_head;
  const long long flat = row * heads * dim_head + c;
  const long long split = ((static_cast<long long>(b) * heads + head) * n + pos) * dim_head + d;
  const long long src = kBackward ? split : flat, dst = kBackward ? flat : split;
  float t[8];  // (cos, sin) of pairs d/2 .. d/2 + 3
  load8(rope + static_cast<long long>(pos) * dim_head + d, t);
  float x[8];
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    load8((which == 0 ? q : k) + src, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = x[2 * i], x1 = x[2 * i + 1], co = t[2 * i], si = t[2 * i + 1];
      if (kBackward) {
        x[2 * i] = __fadd_rn(__fmul_rn(x0, co), __fmul_rn(x1, si));
        x[2 * i + 1] = __fsub_rn(__fmul_rn(x1, co), __fmul_rn(x0, si));
      } else {
        x[2 * i] = __fsub_rn(__fmul_rn(x0, co), __fmul_rn(x1, si));
        x[2 * i + 1] = __fadd_rn(__fmul_rn(x1, co), __fmul_rn(x0, si));
      }
    }
    store8((which == 0 ? oq : ok) + dst, x);
  }
  load8(v + src, x);
  store8(ov + dst, x);
}

// ---------------------------------------------------------------------------
// gated_residual: out = h + g·y′, y′ = y·[row kept]·[u < keep_p]/keep_p
// (the attention branch; with no u, y·[row kept]; on the FFN branch, with
// neither, y).  g: (B, C) rows at batch stride g_stride.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gated_residual_fwd(const float* __restrict__ h, const float* __restrict__ g, long long g_stride,
                       const T* __restrict__ y, const float* __restrict__ u, float keep_p,
                       const uint8_t* __restrict__ row_keep, float* __restrict__ out,
                       uint8_t* __restrict__ bits, long long units, int n, int width) {
  const long long unit = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (unit >= units) return;
  const int per_row = width / 8;
  const long long row = unit / per_row;
  const int c = static_cast<int>(unit % per_row) * 8;
  const long long at = row * width + c;
  float hv[8], gv[8], yv[8];
  load8(h + at, hv);
  load8(g + (row / n) * g_stride + c, gv);
  load8(y + at, yv);
  unsigned kept = (row_keep == nullptr || row_keep[row]) ? 0xffu : 0u;
  if (u != nullptr) {
    float uv[8];
    load8(u + at, uv);
    unsigned drawn = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) drawn |= (uv[j] < keep_p ? 1u : 0u) << j;
    bits[unit] = static_cast<uint8_t>(drawn);
    kept &= drawn;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float yp = ((kept >> j) & 1u) ? (u != nullptr ? __fdiv_rn(yv[j], keep_p) : yv[j]) : 0.f;
    hv[j] = __fadd_rn(hv[j], __fmul_rn(gv[j], yp));
  }
  store8(out + at, hv);
}

// dy = dout·g·[kept]/keep_p (no /keep_p without u) in y's dtype; each
// tile's column sums of dout·y′ (d(g)).  dh is dout itself: no kernel.
// Grid (tiles, B).
template <typename T>
__global__ void __launch_bounds__(1024)
    gated_residual_bwd(const float* __restrict__ dout, const float* __restrict__ g,
                       long long g_stride, const T* __restrict__ y,
                       const uint8_t* __restrict__ bits, float keep_p,
                       const uint8_t* __restrict__ row_keep, T* __restrict__ dy,
                       float* __restrict__ partials, int n, int width, int rows_per_tile) {
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int c = threadIdx.x * 8;
  if (c >= width) return;  // no block-wide step follows
  float gv[8], dg[8];
  load8(g + b * g_stride + c, gv);
#pragma unroll
  for (int j = 0; j < 8; ++j) dg[j] = 0.f;
  const int first = tile * rows_per_tile;
  const int last = min(first + rows_per_tile, n);
  for (int pos = first; pos < last; ++pos) {
    const long long row = static_cast<long long>(b) * n + pos;
    const long long at = row * width + c;
    unsigned kept = (row_keep == nullptr || row_keep[row]) ? 0xffu : 0u;
    if (bits != nullptr) kept &= bits[at / 8];
    float dv[8], yv[8];
    load8(dout + at, dv);
    load8(y + at, yv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool on = (kept >> j) & 1u;
      const float yp = on ? (bits != nullptr ? __fdiv_rn(yv[j], keep_p) : yv[j]) : 0.f;
      dg[j] += dv[j] * yp;
      const float dg_y = __fmul_rn(dv[j], gv[j]);
      yv[j] = on ? (bits != nullptr ? __fdiv_rn(dg_y, keep_p) : dg_y) : 0.f;
    }
    store8(dy + at, yv);
  }
  store8(partials + (static_cast<long long>(b) * tiles + tile) * width + c, dg);
}

// ---------------------------------------------------------------------------
// gelu_dropout: y = GELU_tanh(x)·[u < keep_p]/keep_p (GELU_tanh(x) with no
// u), PyTorch's GELU-tanh formula in fp32; dx = dy/keep_p·[kept]·GELU′(x).
// ---------------------------------------------------------------------------

// PyTorch's GELU-tanh and its derivative, in its order of operations.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = x * x * x;
  const float inner = kGeluBeta * (x + kGeluKappa * cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float x_sq = x * x;
  const float cube = x_sq * x;
  const float inner = kGeluBeta * (x + kGeluKappa * cube);
  const float t = tanhf(inner);
  const float left = 0.5f * x;
  const float left_derivative = 0.5f * (1.f + t);
  const float inner_derivative = kGeluBeta * (1.f + 3.f * kGeluKappa * x_sq);
  return left_derivative + left * (1.f - t * t) * inner_derivative;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gelu_dropout_fwd(const T* __restrict__ x, const float* __restrict__ u, float keep_p,
                     T* __restrict__ y, uint8_t* __restrict__ bits, long long units) {
  const long long unit = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (unit >= units) return;
  float xv[8];
  load8(x + unit * 8, xv);
  if (u == nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = gelu_tanh(xv[j]);
  } else {
    float uv[8];
    load8(u + unit * 8, uv);
    unsigned drawn = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool on = uv[j] < keep_p;
      drawn |= (on ? 1u : 0u) << j;
      xv[j] = on ? __fdiv_rn(gelu_tanh(xv[j]), keep_p) : 0.f;
    }
    bits[unit] = static_cast<uint8_t>(drawn);
  }
  store8(y + unit * 8, xv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gelu_dropout_bwd(const T* __restrict__ dy, const T* __restrict__ x,
                     const uint8_t* __restrict__ bits, float keep_p, T* __restrict__ dx,
                     long long units) {
  const long long unit = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (unit >= units) return;
  float dv[8], xv[8];
  load8(dy + unit * 8, dv);
  load8(x + unit * 8, xv);
  const unsigned kept = bits == nullptr ? 0xffu : bits[unit];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = bits == nullptr ? dv[j] : __fdiv_rn(dv[j], keep_p);
    dv[j] = ((kept >> j) & 1u) ? d * gelu_tanh_grad(xv[j]) : 0.f;
  }
  store8(dx + unit * 8, dv);
}

int row_threads(int width) { return (width / 8 + 31) / 32 * 32; }

unsigned blocks_for(long long units) {
  return static_cast<unsigned>((units + kThreads - 1) / kThreads);
}

cudaError_t launch_column_sums(const float* partials, float* out, int arrays, int batch, int tiles,
                               int width, cudaStream_t stream) {
  column_sums<<<dim3((width + kSumThreads - 1) / kSumThreads, batch, arrays), kSumThreads, 0,
                stream>>>(partials, out, tiles, width);
  return cudaGetLastError();
}

}  // namespace

// The launch functions below take contiguous row-major tensors (the
// binding checks them): rows of `width` elements, 8 elements at a time, so
// width % 8 == 0 and every row 16-byte aligned; bf16 selects
// __nv_bfloat16 for the narrow operands (else float).  None allocates.

// y (B·N, C) from h; mean and rstd (B·N).
cudaError_t dit_modulate_fwd_launch(const float* h, const float* scale, const float* shift,
                                    long long ss_stride, void* y, bool bf16, float* mean,
                                    float* rstd, long long rows, int n, int width, float eps,
                                    cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((rows + kRowsFwd - 1) / kRowsFwd));
  if (bf16)
    modulate_fwd<<<grid, row_threads(width), 0, stream>>>(
        h, scale, shift, ss_stride, static_cast<__nv_bfloat16*>(y), mean, rstd, rows, n, width, eps);
  else
    modulate_fwd<<<grid, row_threads(width), 0, stream>>>(
        h, scale, shift, ss_stride, static_cast<float*>(y), mean, rstd, rows, n, width, eps);
  return cudaGetLastError();
}

// dh (B, N, C); partials: 2·B·tiles·C floats; dscale_shift (2, B, C).
cudaError_t dit_modulate_bwd_launch(const void* dy, bool bf16, const float* h, const float* scale,
                                    long long ss_stride, const float* mean, const float* rstd,
                                    float* dh, float* partials, float* dscale_shift, int batch,
                                    int n, int width, int rows_per_tile, cudaStream_t stream) {
  if (batch == 0 || n == 0) return cudaSuccess;
  const int tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const dim3 grid(tiles, batch);
  if (bf16)
    modulate_bwd<<<grid, row_threads(width), 0, stream>>>(
        static_cast<const __nv_bfloat16*>(dy), h, scale, ss_stride, mean, rstd, dh, partials, n,
        width, rows_per_tile);
  else
    modulate_bwd<<<grid, row_threads(width), 0, stream>>>(
        static_cast<const float*>(dy), h, scale, ss_stride, mean, rstd, dh, partials, n, width,
        rows_per_tile);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sums(partials, dscale_shift, 2, batch, tiles, width, stream);
}

// Forward: q, k, v (B, N, H·D) → oq, ok, ov (B, H, N, D); backward the
// reverse.  rope (N, D/2, 2) float32.
cudaError_t dit_rope_heads_launch(const void* q, const void* k, const void* v, const float* rope,
                                  void* oq, void* ok, void* ov, bool bf16, bool backward,
                                  int batch, int n, int heads, int dim_head, cudaStream_t stream) {
  const long long units = static_cast<long long>(batch) * n * heads * dim_head / 8;
  if (units == 0) return cudaSuccess;
#define MATCHA_ROPE(T, BWD)                                                                       \
  rope_heads<T, BWD><<<blocks_for(units), kThreads, 0, stream>>>(                                 \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rope,          \
      static_cast<T*>(oq), static_cast<T*>(ok), static_cast<T*>(ov), units, n, heads, dim_head)
  if (bf16) {
    if (backward) MATCHA_ROPE(__nv_bfloat16, true);
    else MATCHA_ROPE(__nv_bfloat16, false);
  } else {
    if (backward) MATCHA_ROPE(float, true);
    else MATCHA_ROPE(float, false);
  }
#undef MATCHA_ROPE
  return cudaGetLastError();
}

// out (B, N, C) fp32; u null: no dropout (bits not written); row_keep null:
// every row kept.
cudaError_t dit_gated_residual_fwd_launch(const float* h, const float* g, long long g_stride,
                                          const void* y, bool bf16, const float* u, float keep_p,
                                          const uint8_t* row_keep, float* out, uint8_t* bits,
                                          int batch, int n, int width, cudaStream_t stream) {
  const long long units = static_cast<long long>(batch) * n * width / 8;
  if (units == 0) return cudaSuccess;
  if (bf16)
    gated_residual_fwd<<<blocks_for(units), kThreads, 0, stream>>>(
        h, g, g_stride, static_cast<const __nv_bfloat16*>(y), u, keep_p, row_keep, out, bits, units,
        n, width);
  else
    gated_residual_fwd<<<blocks_for(units), kThreads, 0, stream>>>(
        h, g, g_stride, static_cast<const float*>(y), u, keep_p, row_keep, out, bits, units, n,
        width);
  return cudaGetLastError();
}

// dy (B, N, C) in y's dtype; partials: B·tiles·C floats; dg (B, C).  bits
// null: no dropout.
cudaError_t dit_gated_residual_bwd_launch(const float* dout, const float* g, long long g_stride,
                                          const void* y, bool bf16, const uint8_t* bits,
                                          float keep_p, const uint8_t* row_keep, void* dy,
                                          float* partials, float* dg, int batch, int n, int width,
                                          int rows_per_tile, cudaStream_t stream) {
  if (batch == 0 || n == 0) return cudaSuccess;
  const int tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const dim3 grid(tiles, batch);
  if (bf16)
    gated_residual_bwd<<<grid, row_threads(width), 0, stream>>>(
        dout, g, g_stride, static_cast<const __nv_bfloat16*>(y), bits, keep_p, row_keep,
        static_cast<__nv_bfloat16*>(dy), partials, n, width, rows_per_tile);
  else
    gated_residual_bwd<<<grid, row_threads(width), 0, stream>>>(
        dout, g, g_stride, static_cast<const float*>(y), bits, keep_p, row_keep,
        static_cast<float*>(dy), partials, n, width, rows_per_tile);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sums(partials, dg, 1, batch, tiles, width, stream);
}

// `count` elements (a multiple of 8); u null: no dropout.
cudaError_t dit_gelu_dropout_fwd_launch(const void* x, bool bf16, const float* u, float keep_p,
                                        void* y, uint8_t* bits, long long count,
                                        cudaStream_t stream) {
  const long long units = count / 8;
  if (units == 0) return cudaSuccess;
  if (bf16)
    gelu_dropout_fwd<<<blocks_for(units), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), u, keep_p, static_cast<__nv_bfloat16*>(y), bits, units);
  else
    gelu_dropout_fwd<<<blocks_for(units), kThreads, 0, stream>>>(
        static_cast<const float*>(x), u, keep_p, static_cast<float*>(y), bits, units);
  return cudaGetLastError();
}

cudaError_t dit_gelu_dropout_bwd_launch(const void* dy, const void* x, bool bf16,
                                        const uint8_t* bits, float keep_p, void* dx,
                                        long long count, cudaStream_t stream) {
  const long long units = count / 8;
  if (units == 0) return cudaSuccess;
  if (bf16)
    gelu_dropout_bwd<<<blocks_for(units), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(x), bits, keep_p,
        static_cast<__nv_bfloat16*>(dx), units);
  else
    gelu_dropout_bwd<<<blocks_for(units), kThreads, 0, stream>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), bits, keep_p,
        static_cast<float*>(dx), units);
  return cudaGetLastError();
}

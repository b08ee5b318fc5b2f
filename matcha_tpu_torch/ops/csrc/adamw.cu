// Multi-tensor AdamW for Hopper (sm_90a): the training step's optimizer
// (train/optim.py, AdamW: global-norm clip, AdamW, the non-finite skip) over
// every parameter in a fixed number of launches, whatever their count.
//
// Replaces no Pallas kernel.  On the TPU, XLA fused the optax chain of
// matcha_tpu/train/optim.py::build_optimizer into the step's program; in
// eager PyTorch the plain loop (AdamW.apply_plain) launches about 25 small
// kernels a parameter, 9.7 k a step at 387 parameters, and the host, not the
// card, sets their pace.
//
// The kernels walk two tables the wrapper (ops/adamw.py) writes, int64:
//   leaves  (L, 4): the addresses of p, g, mu, nu of each parameter
//   chunks  (C, 4): leaf, first element, element count (<= 16 Ki), flags
//                   (bit 0: weight decay, bit 1: trainable)
// and one fp32 buffer `out`: out[0..7] the step's scalars (below), out[8..]
// one partial sum of squares a chunk.
//   adamw_norm_partials  one block a chunk: the fp32 sum of g^2 over it into
//                        its own slot.  No float atomics: the norm is the
//                        same on every run and on every data-parallel rank.
//   adamw_norm_finish    one block: the partials summed in a fixed order, the
//                        norm (or the one given: tensor parallelism's), then
//                        the clip flag, the finite check and its counters, the
//                        step count and the bias corrections 1 - b^n (fp32
//                        powf, as the loop), into the OptState's device
//                        scalars and out[0..4].
//   adamw_update         one block a chunk; every block returns at once when
//                        the step is not accepted.  Else the loop's arithmetic
//                        element by element, in its order and with its
//                        roundings (__f*_rn: nothing contracts into an FMA),
//                        so p, mu and nu equal the loop's for the same norm.
//                        p, mu and nu in place.
// Nothing reads a scalar back to the host: the step never waits for the card.
//
// What bounds it: bytes.  The update reads p, g, mu, nu and writes p, mu, nu,
// 28 B an element: 1.18 GB at 42.23 M parameters, 0.35 ms at 3.35 TB/s; the
// norm reads g once more, 0.05 ms.  16-byte loads and stores where a chunk's
// pointers are aligned; chunks of 16 Ki elements spread the large parameters
// over the SMs, so a few large matrices do not leave most SMs idle.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kScalars = 8;  // out[0..7]; the partials follow
// out[] slots
constexpr int kNorm = 0, kKeep = 1, kAccept = 2, kBc1 = 3, kBc2 = 4;
constexpr long long kDecay = 1, kTrainable = 2;

struct Leaf {
  float* p;
  const float* g;
  float* mu;
  float* nu;
};

struct Chunk {
  long long leaf, start, count, flags;
};

struct Hyper {
  float one_minus_b1, b1, one_minus_b2, b2, eps, weight_decay, neg_lr, grad_clip;
};

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// Sum over the block, in a fixed order (shuffle tree, then the warps in
// order); the result is valid on thread 0.  Every thread must call it.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
    adamw_norm_partials(const Leaf* __restrict__ leaves, const Chunk* __restrict__ chunks,
                        float* __restrict__ out) {
  const Chunk c = chunks[blockIdx.x];
  const float* g = leaves[c.leaf].g + c.start;
  const int n = static_cast<int>(c.count);
  float s = 0.f;
  int head = 0;
  if (aligned16(g)) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      const float4 v = g4[i];
      s += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    head = n / 4 * 4;
  }
  for (int i = head + threadIdx.x; i < n; i += kThreads) s += g[i] * g[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[kScalars + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
    adamw_norm_finish(float* __restrict__ out, int n_partials, const float* __restrict__ given_norm,
                      int* count, int* notfinite_count, unsigned char* last_finite,
                      int* total_notfinite, float grad_clip, float b1, float b2, int skip_nonfinite,
                      int max_errors) {
  float norm;
  if (given_norm == nullptr) {
    float s = 0.f;
    for (int i = threadIdx.x; i < n_partials; i += kThreads) s += out[kScalars + i];
    norm = __fsqrt_rn(block_sum(s));
  } else {
    norm = *given_norm;
  }
  if (threadIdx.x != 0) return;
  bool accept = true;
  if (skip_nonfinite) {
    const bool finite = isfinite(norm);
    const int bad = finite ? 0 : *notfinite_count + 1;
    accept = finite || bad > max_errors;
    *notfinite_count = bad;
    *last_finite = finite ? 1 : 0;
    *total_notfinite += finite ? 0 : 1;
  }
  const int n = *count + (accept ? 1 : 0);
  *count = n;
  out[kNorm] = norm;
  out[kKeep] = norm < grad_clip ? 1.f : 0.f;
  out[kAccept] = accept ? 1.f : 0.f;
  out[kBc1] = 1.f - powf(b1, static_cast<float>(n));
  out[kBc2] = 1.f - powf(b2, static_cast<float>(n));
}

// The loop's update of one element (train/optim.py, AdamW.apply_plain).
__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v, const Hyper& h,
                                              float norm, bool keep, float bc1, float bc2,
                                              bool decay, bool trainable) {
  if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), h.grad_clip);
  m = __fadd_rn(__fmul_rn(h.one_minus_b1, g), __fmul_rn(h.b1, m));
  v = __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.weight_decay, p));
  u = trainable ? __fmul_rn(h.neg_lr, u) : 0.f;
  p = __fadd_rn(p, u);
}

__global__ void __launch_bounds__(kThreads)
    adamw_update(const Leaf* __restrict__ leaves, const Chunk* __restrict__ chunks,
                 const float* __restrict__ out, Hyper h) {
  if (out[kAccept] == 0.f) return;
  const float norm = out[kNorm], bc1 = out[kBc1], bc2 = out[kBc2];
  const bool keep = out[kKeep] != 0.f;
  const Chunk c = chunks[blockIdx.x];
  const Leaf l = leaves[c.leaf];
  const bool decay = (c.flags & kDecay) != 0, trainable = (c.flags & kTrainable) != 0;
  float* p = l.p + c.start;
  const float* g = l.g + c.start;
  float* mu = l.mu + c.start;
  float* nu = l.nu + c.start;
  const int n = static_cast<int>(c.count);
  int head = 0;
  if (aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu)) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(mu);
    float4* v4 = reinterpret_cast<float4*>(nu);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      float4 pv = p4[i], mv = m4[i], vv = v4[i];
      const float4 gv = g4[i];
      adamw_element(pv.x, gv.x, mv.x, vv.x, h, norm, keep, bc1, bc2, decay, trainable);
      adamw_element(pv.y, gv.y, mv.y, vv.y, h, norm, keep, bc1, bc2, decay, trainable);
      adamw_element(pv.z, gv.z, mv.z, vv.z, h, norm, keep, bc1, bc2, decay, trainable);
      adamw_element(pv.w, gv.w, mv.w, vv.w, h, norm, keep, bc1, bc2, decay, trainable);
      p4[i] = pv;
      m4[i] = mv;
      v4[i] = vv;
    }
    head = n / 4 * 4;
  }
  for (int i = head + threadIdx.x; i < n; i += kThreads) {
    float pv = p[i], mv = mu[i], vv = nu[i];
    adamw_element(pv, g[i], mv, vv, h, norm, keep, bc1, bc2, decay, trainable);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = vv;
  }
}

}  // namespace

// out: kScalars + n_chunks floats.  given_norm: a device scalar, or null to
// take the norm of the leaves' gradients (then one launch more).  The four
// counters are the OptState's device scalars, updated in place; with
// skip_nonfinite 0 only count moves (every step is accepted).
cudaError_t adamw_norm_launch(const long long* leaves, const long long* chunks, int n_chunks,
                              float* out, const float* given_norm, int* count,
                              int* notfinite_count, unsigned char* last_finite,
                              int* total_notfinite, float grad_clip, float b1, float b2,
                              int skip_nonfinite, int max_errors, cudaStream_t stream) {
  if (n_chunks < 0) return cudaErrorInvalidValue;
  if (given_norm == nullptr && n_chunks > 0) {
    adamw_norm_partials<<<n_chunks, kThreads, 0, stream>>>(
        reinterpret_cast<const Leaf*>(leaves), reinterpret_cast<const Chunk*>(chunks), out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  adamw_norm_finish<<<1, kThreads, 0, stream>>>(out, n_chunks, given_norm, count, notfinite_count,
                                                last_finite, total_notfinite, grad_clip, b1, b2,
                                                skip_nonfinite, max_errors);
  return cudaGetLastError();
}

// Reads out[0..4] as adamw_norm_launch wrote them.
cudaError_t adamw_update_launch(const long long* leaves, const long long* chunks, int n_chunks,
                                const float* out, float one_minus_b1, float b1, float one_minus_b2,
                                float b2, float eps, float weight_decay, float neg_lr,
                                float grad_clip, cudaStream_t stream) {
  if (n_chunks < 0) return cudaErrorInvalidValue;
  if (n_chunks == 0) return cudaSuccess;
  const Hyper h{one_minus_b1, b1, one_minus_b2, b2, eps, weight_decay, neg_lr, grad_clip};
  adamw_update<<<n_chunks, kThreads, 0, stream>>>(reinterpret_cast<const Leaf*>(leaves),
                                                  reinterpret_cast<const Chunk*>(chunks), out, h);
  return cudaGetLastError();
}

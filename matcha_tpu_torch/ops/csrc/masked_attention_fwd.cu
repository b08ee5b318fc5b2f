// Masked self-attention forward for Hopper (sm_90a): out = softmax(q·kᵀ/√D
// over the valid keys)·v, streamed over key tiles so the (T, T) logits never
// reach device memory.
//
// Replaces the Pallas TPU flash-attention forward that the JAX package
// reaches from matcha_tpu/ops/attention.py:117-132 (masked_self_attention,
// flash branch; jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_impl → pallas_call :758, _flash_attention_kernel).  Same
// contract: padded keys (key_valid == 0) are left out of every softmax,
// every query row (valid or padded) attends the same valid keys, running
// max / sum / accumulator are fp32, P is rounded to bf16 before P·V (as the
// JAX einsum path rounds its weights to v's dtype), the output is in v's
// dtype, and a row with no valid key divides 0 by 0 as the plain version
// does.  The optional (B, H, T) fp32 lse is log2 Σ exp2(q·kᵀ·scale·log2e)
// over the valid keys, +inf for a row with none; the backward reads it.
//
// What bounds it on the card: at (16,5,512,64) bf16 the function reads q, k,
// v and writes out once, 4·B·H·T·D·2 bytes, 6.3 µs at 3.35 TB/s, against
// 4·B·H·T²·D flops, 5.4 µs at the bf16 tensor-core peak: the two bounds are
// within 2×, so the kernel must keep the logits out of device memory and
// feed the tensor cores without stalling on loads.  At the B=1 request
// (20–40 blocks of 64 queries on 132 SMs) neither bound is near: each
// block's chain of key tiles sets the time.
//
// bf16 design: one block per (64 queries, head, batch row).  A producer
// warp's one thread loads the block's Q once and streams K and V as
// (64 keys × 64 columns) 128-byte-swizzled boxes by TMA through a ring of
// full/empty mbarriers; the consumer warpgroups run S = Q·Kᵀ as wgmma
// m64n64k16 from shared memory (both operands K-major), the online softmax
// in the accumulator registers, and O += P·V with A = P from registers (the
// fp32 accumulator layout of 16 columns is the bf16 A layout of k16) and B =
// the V tile read MN-major through the transpose bit.  The tile's key mask
// is read beside the load as a 0/−inf bias, branch-free (a conditional load
// before the products makes ptxas serialise wgmma, C7520).  The tensor maps
// are 3-D (D, T, B·H): rows past T and columns past D arrive as zeros and
// never from the next head, and the output leaves through shared memory by
// one TMA store per box, which drops them.  D ≤ 64 is one 64-column box,
// 64 < D ≤ 128 two; the wrapper pads a head dim that is not a multiple of 8
// and passes the true scale.  Two layouts, chosen by grid size:
//   1  one consumer warpgroup per block, two ring stages (160 threads); the
//      wide grids (B=16 serving, B=29..62 training) keep several blocks on
//      each SM, whose products and softmax interleave;
//   2  two consumer warpgroups that take alternate key tiles through a
//      4-stage ring and merge their (max, sum, O) through shared memory at
//      the end (288 threads): a split over keys inside the block, no second
//      launch.  The grids of a B=1 request have fewer blocks than SMs, and
//      this halves each block's chain of tiles.
// What this does about the five costs of the mma.sync kernel it replaces:
// (1) synchronous loads serialised with the math: the producer keeps tiles
// in flight on mbarriers while the consumers compute; (2) V gathered 16 bits
// at a time and Q read from global memory 16 bits at a time: both arrive by
// TMA and wgmma reads them from the swizzled tiles, no thread loads an
// operand; (3) mma.sync m16n8k16: wgmma, the only path to Hopper's tensor-
// core rate; (4) scattered 16-bit epilogue stores: one TMA store per box;
// (5) a serial chain of 4–8 tiles per block at B=1: layout 2 halves it.
//
// fp32 (the reference checks): exact fp32 FMAs (no tf32, no bf16 downcast):
// one block per 32 query rows, 4 threads per row, each over every 4th key
// with its own online-softmax state, merged by warp shuffles at the end.
// Any T, head dims 1..128.

#include <initializer_list>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

using namespace hopper;

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

template <int DP>
void launch_f32(const void* q, const void* k, const void* v, const uint8_t* key_valid, void* out,
                float* lse, int batch, int n_heads, int seq, int dim, float qk_scale_log2,
                cudaStream_t stream) {
  const dim3 grid((seq + kRows - 1) / kRows, n_heads, batch);
  masked_attention_fwd_f32_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      key_valid, static_cast<float*>(out), lse, n_heads, seq, dim, qk_scale_log2);
}


// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;        // query rows a block owns (one wgmma M)
constexpr int kSplitBelow = 132;   // layout by shape: split keys below one block per SM

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory, from a 1024-byte-aligned base:
//   q      [ATOMS] boxes of the block's 64 query rows
//   ring   kStages × ([ATOMS] boxes of a 64-key K tile, [ATOMS] of its V tile)
//   merge  (NWG = 2) the second warpgroup's row max and sum, 4 floats a
//          thread; its O goes through ring stage 1, which only it reads
//   bars   full[kStages], empty[kStages], q
template <int ATOMS, int NWG>
struct FwdLayout {
  static constexpr int kStages = 2 * NWG;  // two tiles in flight per consumer warpgroup
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;  // + one producer warp
  static constexpr uint32_t kQ = ATOMS * kBox;
  static constexpr uint32_t kStage = 2 * ATOMS * kBox;
  static constexpr uint32_t kMerge = NWG > 1 ? 4 * 128 * sizeof(float) : 0;
  static constexpr uint32_t kBars = kQ + kStages * kStage + kMerge;
  static constexpr uint32_t kBytes = kBars + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
  static constexpr int kMinBlocks = NWG > 1 ? 1 : (ATOMS == 1 ? 3 : 2);
};

template <int ATOMS, int NWG>
__global__ void __launch_bounds__(FwdLayout<ATOMS, NWG>::kThreads, FwdLayout<ATOMS, NWG>::kMinBlocks)
masked_attention_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                       const __grid_constant__ CUtensorMap map_k,
                                       const __grid_constant__ CUtensorMap map_v,
                                       const __grid_constant__ CUtensorMap map_out,
                                       const uint8_t* __restrict__ key_valid,
                                       float* __restrict__ lse, int n_heads, int seq,
                                       float qk_scale_log2) {
  using L = FwdLayout<ATOMS, NWG>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t s_q = base, s_ring = base + L::kQ;
  const uint32_t bars = base + L::kBars;
  const uint32_t q_bar = bars + 16 * kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int bh = b * n_heads + blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_tiles = (seq + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);              // full: the producer's arrive + bytes
      mbar_init(bars + 8 * (kStages + s), 4);  // empty: one arrive per warp of its warpgroup
    }
    mbar_init(q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= L::kConsumers) {  // producer warp: one thread issues every load
    if (tid == L::kConsumers) {
      mbar_expect_tx(q_bar, L::kQ);
      for (int a = 0; a < ATOMS; ++a) tma_load_3d(s_q + a * kBox, &map_q, q_bar, 64 * a, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(bars + 8 * (kStages + s), (i / kStages - 1) & 1);
        const uint32_t st = s_ring + s * L::kStage;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, L::kStage);
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_3d(st + a * kBox, &map_k, full, 64 * a, 64 * i, bh);
          tma_load_3d(st + (ATOMS + a) * kBox, &map_v, full, 64 * a, 64 * i, bh);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;

  float o[ATOMS][32];
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[a][r] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units), rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sums

  mbar_wait(q_bar, 0);
  for (int i = wg; i < n_tiles; i += NWG) {  // this warpgroup's key tiles
    const int s = i % kStages;
    const uint32_t st = s_ring + s * L::kStage;
    // bit 2j + c: key 8j + 2t + c of the tile (this thread's columns) is
    // valid and below T; loaded before the products so the latency hides
    // behind the wait, branch-free
    const int k0 = 64 * i;
    uint32_t key_bits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kc = k0 + 8 * j + 2 * t + c;
        const uint32_t ok = (valid[min(kc, seq - 1)] != 0) & (kc < seq);
        key_bits |= ok << (2 * j + c);
      }
    mbar_wait(bars + 8 * s, (i / kStages) & 1);

    // S = Q·Kᵀ: the block's 64 queries × the tile's 64 keys
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * ATOMS; ++kk)
      wgmma_ss(sc, desc_k(s_q + (kk / 4) * kBox + (kk % 4) * 32),
               desc_k(st + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // log2 units with a −inf bias on padded keys and keys past T; online
    // softmax over rows g and g + 8 (the 4 threads of a quad share a row)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bias0 = ((key_bits >> (2 * j)) & 1u) ? 0.f : -INFINITY;
      const float bias1 = ((key_bits >> (2 * j + 1)) & 1u) ? 0.f : -INFINITY;
      sc[4 * j + 0] = fmaf(sc[4 * j + 0], qk_scale_log2, bias0);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], qk_scale_log2, bias1);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], qk_scale_log2, bias0);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], qk_scale_log2, bias1);
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // a row with no valid key so far keeps p = 0 (never exp2(-inf + inf))
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float c0 = fast_exp2(m0 - base0);  // 0 while m is still -inf
    const float c1 = fast_exp2(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j + 0] = fast_exp2(sc[4 * j + 0] - base0);
      sc[4 * j + 1] = fast_exp2(sc[4 * j + 1] - base0);
      sc[4 * j + 2] = fast_exp2(sc[4 * j + 2] - base1);
      sc[4 * j + 3] = fast_exp2(sc[4 * j + 3] - base1);
      ps0 += sc[4 * j + 0] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = fmaf(l0, c0, ps0);
    l1 = fmaf(l1, c1, ps1);
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[a][4 * j + 0] *= c0;
        o[a][4 * j + 1] *= c0;
        o[a][4 * j + 2] *= c1;
        o[a][4 * j + 3] *= c1;
      }

    // O += P·V, 16 keys per step, P rounded to bf16, B = the V tile MN-major
    uint32_t pa[4][4];
    acc_to_a(pa, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        wgmma_rs(o[a], pa[kk], desc_mn(st + (ATOMS + a) * kBox + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) fence_acc(o[a]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if constexpr (NWG > 1) {
    // merge the second warpgroup's (max, sum, O) into the first's: thread r
    // of each warpgroup holds the same rows and columns
    float* mrg = reinterpret_cast<float*>(gbase + L::kQ + kStages * L::kStage);
    const float* ob = reinterpret_cast<const float*>(gbase + L::kQ + L::kStage);
    const int r = tid & 127;
    if (wg == 1) {
      mrg[r] = m0;
      mrg[128 + r] = m1;
      mrg[256 + r] = l0;
      mrg[384 + r] = l1;
      float* ow = reinterpret_cast<float*>(gbase + L::kQ + L::kStage);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
#pragma unroll
        for (int k = 0; k < 32; ++k) ow[(32 * a + k) * 128 + r] = o[a][k];
    }
    named_sync(3, L::kConsumers);
    if (wg == 1) return;
    const float n0 = mrg[r], n1 = mrg[128 + r];
    const float mm0 = fmaxf(m0, n0), mm1 = fmaxf(m1, n1);
    const float base0 = mm0 == -INFINITY ? 0.f : mm0;
    const float base1 = mm1 == -INFINITY ? 0.f : mm1;
    const float fa0 = fast_exp2(m0 - base0), fb0 = fast_exp2(n0 - base0);
    const float fa1 = fast_exp2(m1 - base1), fb1 = fast_exp2(n1 - base1);
    l0 = l0 * fa0 + mrg[256 + r] * fb0;
    l1 = l1 * fa1 + mrg[384 + r] * fb1;
    m0 = mm0;
    m1 = mm1;
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* oj = ob + (32 * a + 4 * j) * 128 + r;
        o[a][4 * j + 0] = o[a][4 * j + 0] * fa0 + oj[0] * fb0;
        o[a][4 * j + 1] = o[a][4 * j + 1] * fa0 + oj[128] * fb0;
        o[a][4 * j + 2] = o[a][4 * j + 2] * fa1 + oj[256] * fb1;
        o[a][4 * j + 3] = o[a][4 * j + 3] * fa1 + oj[384] * fb1;
      }
  }

  // a row with no valid key at all divides 0 by 0, as the plain version does
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const int row = q0 + 16 * warp + g;  // this thread's rows: row, row + 8
  if (lse != nullptr && t == 0) {
    float* lh = lse + static_cast<size_t>(bh) * seq;
    if (row < seq) lh[row] = lse_log2(m0, l0);
    if (row + 8 < seq) lh[row + 8] = lse_log2(m1, l1);
  }
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[a][4 * j + 0] *= inv0;
      o[a][4 * j + 1] *= inv0;
      o[a][4 * j + 2] *= inv1;
      o[a][4 * j + 3] *= inv1;
    }
    // over the Q boxes: every product that read them has completed
    acc_to_box(gbase + a * kBox, o[a], 1.f, warp, g, t);
  }
  fence_proxy_async();
  warpgroup_sync(0);
  if (tid == 0) {
    for (int a = 0; a < ATOMS; ++a) tma_store_3d(&map_out, s_q + a * kBox, 64 * a, q0, bh);
    tma_store_drain();
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  const uint8_t* key_valid;
  void* out;
  float* lse;
  int batch, n_heads, seq, dim;
  float qk_scale_log2;
  cudaStream_t stream;
};

template <int ATOMS, int NWG>
const char* launch_bf16(const FwdArgs& a) {
  using L = FwdLayout<ATOMS, NWG>;
  const int bh = a.batch * a.n_heads;
  CUtensorMap mq, mk, mv, mo;
  if (!encode_heads(&mq, a.q, bh, a.seq, a.dim) || !encode_heads(&mk, a.k, bh, a.seq, a.dim) ||
      !encode_heads(&mv, a.v, bh, a.seq, a.dim) || !encode_heads(&mo, a.out, bh, a.seq, a.dim))
    return "cuTensorMapEncodeTiled refused a tensor map";
  const auto kernel = masked_attention_fwd_bf16_wgmma_kernel<ATOMS, NWG>;
  const int smem = static_cast<int>(L::kBytes);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return "cudaFuncSetAttribute refused the forward kernel's shared memory";
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.n_heads, a.batch);
  kernel<<<grid, L::kThreads, smem, a.stream>>>(mq, mk, mv, mo, a.key_valid, a.lse, a.n_heads,
                                                a.seq, a.qk_scale_log2);
  return nullptr;
}

// layout by shape: split the key tiles over two warpgroups when the grid
// has fewer 64-query blocks than the card has SMs
int layout_for(int batch, int n_heads, int seq) {
  const long long blocks = static_cast<long long>(batch) * n_heads * ((seq + kBlockQ - 1) / kBlockQ);
  return blocks < kSplitBelow ? 2 : 1;
}

const char* launch_bf16_layout(const FwdArgs& a, int layout) {
  if (encode_tiled() == nullptr) return "cuTensorMapEncodeTiled is not available from the driver";
  if (a.dim % 8 != 0) return "bf16 head dim must be a multiple of 8 (the wrapper pads it)";
  for (const void* p : {a.q, a.k, a.v, static_cast<const void*>(a.out)})
    if (!aligned16(p)) return "bf16 forward operands must be 16-byte aligned";
  const bool wide = a.dim > 64;
  if (layout == 1) return wide ? launch_bf16<2, 1>(a) : launch_bf16<1, 1>(a);
  return wide ? launch_bf16<2, 2>(a) : launch_bf16<1, 2>(a);
}

const char* const kBadDim = "head dim outside [1, 128]";

}  // namespace

// Launches on `stream` without synchronising; returns nullptr, or why
// nothing was launched.  The caller checks cudaGetLastError.  q, k, v, out:
// contiguous (B, H, T, D) in one dtype; key_valid: (B, T) uint8; `lse`
// (B, H, T) fp32, or null: the log-sum-exp of each row's scaled logits in
// log2 units, which the backward kernels read.  qk_scale_log2: the softmax
// scale of the true head dim times log2(e) (bf16 takes D padded to a
// multiple of 8 and 16-byte-aligned pointers).  layout (bf16 only): 0 by
// shape, 1 one warpgroup per block, 2 two warpgroups splitting the keys.
const char* masked_attention_fwd_launch(const void* q, const void* k, const void* v,
                                        const uint8_t* key_valid, void* out, float* lse,
                                        int batch, int n_heads, int seq, int dim, bool bf16,
                                        float qk_scale_log2, int layout, cudaStream_t stream) {
  if (dim < 1 || dim > 128) return kBadDim;
  if (bf16) {
    if (layout == 0) layout = layout_for(batch, n_heads, seq);
    if (layout != 1 && layout != 2) return "layout must be 0 (by shape), 1 or 2";
    return launch_bf16_layout(
        FwdArgs{q, k, v, key_valid, out, lse, batch, n_heads, seq, dim, qk_scale_log2, stream},
        layout);
  }
#define MATCHA_ARGS q, k, v, key_valid, out, lse, batch, n_heads, seq, dim, qk_scale_log2, stream
  if (dim <= 8) launch_f32<8>(MATCHA_ARGS);
  else if (dim <= 16) launch_f32<16>(MATCHA_ARGS);
  else if (dim <= 32) launch_f32<32>(MATCHA_ARGS);
  else if (dim <= 48) launch_f32<48>(MATCHA_ARGS);
  else if (dim <= 64) launch_f32<64>(MATCHA_ARGS);
  else if (dim <= 96) launch_f32<96>(MATCHA_ARGS);
  else launch_f32<128>(MATCHA_ARGS);
#undef MATCHA_ARGS
  return nullptr;
}

// The bf16 layout (1 or 2) that layout 0 picks for this shape.
int masked_attention_fwd_layout(int batch, int n_heads, int seq) {
  return layout_for(batch, n_heads, seq);
}

// Registers, static and dynamic shared memory, local (spill) bytes and the
// thread count of the bf16 forward kernel of `layout` (1 or 2) that serves
// `dim`.  out[5]; returns the cudaFuncGetAttributes error.
cudaError_t masked_attention_fwd_attributes(int layout, int dim, int* out) {
  cudaFuncAttributes fa{};
  const bool wide = dim > 64;
  const void* fn =
      layout == 1
          ? (wide ? reinterpret_cast<const void*>(masked_attention_fwd_bf16_wgmma_kernel<2, 1>)
                  : reinterpret_cast<const void*>(masked_attention_fwd_bf16_wgmma_kernel<1, 1>))
          : (wide ? reinterpret_cast<const void*>(masked_attention_fwd_bf16_wgmma_kernel<2, 2>)
                  : reinterpret_cast<const void*>(masked_attention_fwd_bf16_wgmma_kernel<1, 2>));
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(layout == 1 ? (wide ? FwdLayout<2, 1>::kBytes : FwdLayout<1, 1>::kBytes)
                                        : (wide ? FwdLayout<2, 2>::kBytes : FwdLayout<1, 2>::kBytes));
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = layout == 1 ? FwdLayout<1, 1>::kThreads : FwdLayout<1, 2>::kThreads;
  return err;
}

// Masked self-attention backward for Hopper (sm_90a): dq, dk, dv of
// out = softmax(q·kᵀ/√D over the valid keys)·v.
//
// Replaces the Pallas TPU flash-attention backward that the JAX package
// differentiates through (jax/experimental/pallas/ops/tpu/flash_attention.py):
// _flash_attention_dkv_kernel :796, called from _flash_attention_bwd_dkv
// :941 → pallas_call :1121, and _flash_attention_dq_kernel :1146, called
// from _flash_attention_bwd_dq :1287 → pallas_call :1456.  The TPU runs them
// as two kernels; here bf16 runs one pass that computes all three gradients.
// P is recomputed from q, k and the forward's log-sum-exp (log2 units, see
// masked_attention_fwd.cu); D_i = rowsum(dO∘O) comes from a pre-pass kernel:
//   S = q·kᵀ, P = exp2(S·scale·log2e − lse), dV = Pᵀ·dO, dP = dO·vᵀ,
//   dS = P∘(dP − D), dQ = scale·dS·k, dK = scale·dSᵀ·q.
// Padded keys get dk = dv = 0; every query row, padded or not, back-
// propagates through the valid keys it attended, as in the forward.  With a
// chunk c > 0 (chunk-causal) query i attended key j only where also
// j < (⌊i / c⌋ + 1)·c, that is i ≥ ⌊j / c⌋·c: a key block's query loop starts
// at the tile of the first query that sees its first key, and P is 0 past
// each key row's bound by the same −inf bias as a padded key.
//
// What bounds it on the card: the function is five products,
// 10·B·H·T·D·(valid keys) flops, against about 8·B·H·T·D·2 bytes, so the
// tensor cores and not the memory set the bound: 52.6 µs at the decoder's
// (62,5,512,64), 1,091 µs at the DiT's (13,16,2848,64) on an H100.  The
// split this replaced (one kernel per key block for dk, dv, one per query
// block for dq) recomputed S and dP in both: 7 products against the 5 of
// the bound, so it could not pass 5/7 of it, and it reached 23 % at the
// DiT's shape.
//
// bf16 design (the training path), three launches:
//   attn_bwd_dq_delta_kernel   D_i = rowsum(dO∘O) in fp32 from the bf16
//        tensors, each read once (8 lanes a row, each lane every 8th
//        16-byte chunk in order, then the lanes' sums pairwise); it also
//        zeroes the fp32 (B, H, T, D) dq accumulator.
//   attn_bwd_dkv_dq_bf16_wgmma_kernel   one block per (128 keys, head, batch
//        row): two consumer warpgroups of 64 keys and one producer
//        warpgroup (384 threads).  K and V of the block go once into shared
//        memory by TMA and stay; Q and dO stream as 64-query tiles through
//        a ring of stages (full and empty mbarriers; one producer thread
//        keeps the ring loaded).  Per tile each warpgroup runs Sᵀ = K·Qᵀ and
//        dPᵀ = V·dOᵀ (wgmma m64n64k16 from shared memory), forms Pᵀ and dSᵀ
//        in the accumulator registers, writes both to shared memory as
//        bf16 and runs dV += Pᵀ·dO and dK += dSᵀ·Q from there.  Once both
//        warpgroups' dSᵀ are in place, each computes dQ = dS·K over the
//        block's 128 keys for its half of the head dim (m64n32k16, or
//        m64n64k16 for D > 64, A and B read transposed), stages it in a
//        swizzled fp32 box and adds it into the accumulator with one TMA
//        reduce-add (cp.reduce.async.bulk.tensor .add).  Five products per
//        (query tile, key block), the bound's five.
//   attn_bwd_dq_convert_kernel   dq = bf16(scale · accumulator).
//   The 7-product split: gone, one pass computes each product once.  The
//   register limit: the producer warpgroup gives registers back
//   (setmaxnreg.dec to 24) and the consumers take them (setmaxnreg.inc to
//   240), and no register holds a product's operand while it runs (Pᵀ and
//   dSᵀ go through shared memory, the tile's lse and delta too), so dK,
//   dV, Sᵀ, dPᵀ and dQ live in registers without a spill.  Overlap: each
//   warpgroup queues the next tile's Sᵀ behind this tile's dV, dK and dQ,
//   so it runs while dQ is staged and reduce-added, and the next tile's
//   dPᵀ runs while Pᵀ is computed.  (Sᵀ, dPᵀ and dQ in flight at once
//   spill, and ptxas then serialises every wgmma.)  The key blocks of one
//   head start their query loops at staggered tiles, so their reduce-adds
//   spread over the accumulator instead of meeting on one tile.
//   Measured on an H100 at (13,16,2848,64): 3,172 µs for the three
//   launches, 34 % of the 1,091 µs bound, against 4,753 µs for the split.
//   A key block whose keys are all padded writes dk = dv = 0 and exits;
//   no query row is skipped.  Every bf16 tile is a (64 rows × 64 columns)
//   TMA box with 128-byte swizzle, from a 3-D tensor map (D, T, B·H): rows
//   past T and columns past D arrive as zeros and never from the next
//   head.  dk and dv go back through shared memory in the same swizzled
//   layout and leave by a TMA store, which drops rows past T and columns
//   past D, as the reduce-add drops them from dQ.  D ≤ 64 is one 64-column
//   box, 64 < D ≤ 128 two; the wrapper pads a head dim that is not a
//   multiple of 8 (TMA needs 16-byte row strides) and passes the true
//   scale.  P is exp2 by ex2.approx; padded keys get P = 0 by a −inf bias
//   and query columns past T by an lse of +inf, with no branch among the
//   products (ptxas serialises wgmma behind divergent code, C7520).
//   dq is summed by fp32 reduce-adds that land in an order that changes
//   from run to run: bf16 dq is no longer bit-repeatable (dk and dv are).

// fp32 (the reference checks): exact fp32 FMAs (no TF32), two kernels: a
// block owns 16 keys (dk, dv) or 16 queries (dq), 8 threads per row each
// holding every 8th head dim; row dot products are reduced by warp
// shuffles; delta from the same pre-pass.  Any T, head dims 1..128.

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

using namespace hopper;

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
                        float scale_log2, int chunk) {
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
  const int first_query = chunk > 0 ? key / chunk * chunk : 0;  // the first query that sees it

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
      const float p = key_ok && q0 + j >= first_query ? exp2f(fmaf(sp, scale_log2, -ls[j])) : 0.f;
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
                       int n_heads, int seq, int dim, float scale, float scale_log2, int chunk) {
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
  const int row_end = chunk > 0 ? (qi / chunk + 1) * chunk : seq;  // the row's keys end here

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
      const float p = key_ok[j] && k0 + j < row_end ? exp2f(fmaf(sp, scale_log2, -lse_row)) : 0.f;
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
// delta pre-pass and dq post-pass
// ---------------------------------------------------------------------------

constexpr int kDeltaRows = 32;  // rows per 256-thread block, 8 lanes each

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// lane s of a row adds dO·O over 8-element chunks s, s + 8, ... in order,
// then the 8 lanes' sums pairwise (group_sum); each product is rounded to
// fp32 before it is added (no fused multiply-add), so the plain twin
// (attention.masked_attention_delta_plain) computes the same sum to the
// bit.  dq_acc, when given, gets its row zeroed.
template <typename T>
__global__ void __launch_bounds__(kDeltaRows * kLanes)
attn_bwd_dq_delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                         float* __restrict__ delta, float* __restrict__ dq_acc, long long rows,
                         int dim) {
  const long long row = static_cast<long long>(blockIdx.x) * kDeltaRows + threadIdx.x / kLanes;
  const int s = threadIdx.x % kLanes;
  float acc = 0.f;
  if (row < rows) {
    const T* a = dout + row * dim;
    const T* o = out + row * dim;
    for (int c = s; 8 * c < dim; c += kLanes) {
      if constexpr (sizeof(T) == 2) {  // bf16: dim % 8 == 0, one 16-byte load each
        const uint4 va = *reinterpret_cast<const uint4*>(a + 8 * c);
        const uint4 vo = *reinterpret_cast<const uint4*>(o + 8 * c);
        const __nv_bfloat16* ea = reinterpret_cast<const __nv_bfloat16*>(&va);
        const __nv_bfloat16* eo = reinterpret_cast<const __nv_bfloat16*>(&vo);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = __fadd_rn(acc, __fmul_rn(to_float(ea[e]), to_float(eo[e])));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * c + e < dim) acc = __fadd_rn(acc, __fmul_rn(to_float(a[8 * c + e]), to_float(o[8 * c + e])));
      }
    }
  }
  acc = group_sum(acc);
  if (row < rows) {
    if (s == 0) delta[row] = acc;
    if (dq_acc != nullptr)
      for (int d = 4 * s; d < dim; d += 4 * kLanes)
        *reinterpret_cast<float4*>(dq_acc + row * dim + d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(256)
attn_bwd_dq_convert_kernel(const float4* __restrict__ acc, uint2* __restrict__ dq, long long n4,
                           float scale) {
  const long long x = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (x < n4) {
    const float4 a = acc[x];
    dq[x] = make_uint2(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
  }
}

// ---------------------------------------------------------------------------
// bf16: one pass, wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;              // two warpgroups of 64 keys each
constexpr int kThreadsW = kConsumers + 128;  // + one producer warpgroup
constexpr int kProducerRegs = 24;            // setmaxnreg: 24·128 + 240·256 ≤ 64 Ki
constexpr int kConsumerRegs = 240;
constexpr int kBlockKeys = 128;              // keys a block owns
constexpr int kBothGroups = 3;               // named barrier over both warpgroups
constexpr uint32_t kBoxF32 = 64 * 128;       // one (64 rows × 32 fp32) swizzled box: 8 KB

// Shared memory, from a 1024-byte-aligned base:
//   fixed  [ATOMS][2 halves] boxes of K, then of V: the block's 128 keys
//   ring   kStages × ([ATOMS] boxes of the Q tile, [ATOMS] of the dO tile)
//   dsT    2 buffers × 2 halves: the tile's dSᵀ (keys × queries) in bf16
//   pT     2 halves: the tile's Pᵀ in bf16
//   dq     kDqBufs buffers × 2 warpgroups × ATOMS fp32 boxes: dQ on its way
//          to the TMA reduce-add
//   rows   2 buffers × (64 lse, 64 delta) fp32 of the tile's queries
//   bars   full[kStages], empty[kStages], fixed
template <int ATOMS>
struct Layout {
  static constexpr int kStages = ATOMS == 1 ? 3 : 2;  // ring depth
  static constexpr int kDqBufs = ATOMS == 1 ? 2 : 1;
  static constexpr uint32_t kFixed = 2 * ATOMS * 2 * kBox;
  static constexpr uint32_t kStage = 2 * ATOMS * kBox;
  static constexpr uint32_t kDsT = kFixed + kStages * kStage;
  static constexpr uint32_t kPT = kDsT + 4 * kBox;
  static constexpr uint32_t kDq = kPT + 2 * kBox;
  static constexpr uint32_t kRows = kDq + kDqBufs * 2 * ATOMS * kBoxF32;
  static constexpr uint32_t kBars = kRows + 2 * 128 * 4;
  static constexpr uint32_t kBytes = kBars + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
};

// Sᵀ = K·Qᵀ (or dPᵀ = V·dOᵀ, with the V boxes and stage + the Q boxes'
// size) of one warpgroup's 64 keys × a tile's 64 queries, one commit group
template <int ATOMS>
__device__ __forceinline__ void issue_product(float (&acc)[32], uint32_t fixed, uint32_t stage,
                                              int wg) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * ATOMS; ++kk)
    wgmma_ss(acc, desc_k(fixed + (kk / 4) * 2 * kBox + wg * kBox + (kk % 4) * 32),
             desc_k(stage + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
  wgmma_commit();
}

// Predicated, not branched: ptxas serialises wgmma behind divergent code.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}

// CHUNKED (chunk > 0): the query loop covers the tiles from that of the
// first query that sees the block's first key; the chunk's bound of each
// key row enters Pᵀ's bias by a select, no branch.  With CHUNKED = false the
// kernel is the unchunked one, instruction for instruction.
template <int ATOMS, bool CHUNKED>
__global__ void __launch_bounds__(kThreadsW, 1)
attn_bwd_dkv_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const __grid_constant__ CUtensorMap map_do,
                                  const __grid_constant__ CUtensorMap map_dk,
                                  const __grid_constant__ CUtensorMap map_dv,
                                  const __grid_constant__ CUtensorMap map_dq,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  const uint8_t* __restrict__ key_valid,
                                  __nv_bfloat16* __restrict__ dk_out,
                                  __nv_bfloat16* __restrict__ dv_out, int n_heads, int seq, int dim,
                                  float scale, float scale_log2, int chunk) {
  using L = Layout<ATOMS>;
  constexpr int kStages = L::kStages;
  constexpr int kDqCols = 32 * ATOMS;  // dQ columns per warpgroup: half the boxes' width
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t s_k = base, s_v = base + ATOMS * 2 * kBox, s_ring = base + L::kFixed;
  const uint32_t s_dq = base + L::kDq;
  float* const rows_s = reinterpret_cast<float*>(gbase + L::kRows);
  const uint32_t bars = base + L::kBars;
  const uint32_t kv_bar = bars + 16 * kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int bh = b * n_heads + blockIdx.y;
  const int key0 = blockIdx.x * kBlockKeys;
  // the query tiles that see the block's keys: q_first .. of them all
  const int q_first = CHUNKED ? key0 / chunk * chunk / 64 : 0;
  const int n_tiles = (seq + 63) / 64 - q_first;
  const int start = (2 * blockIdx.x) % n_tiles;  // this block's first query tile
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;
  // the query tiles in this block's order: its n-th is tile(n)
  auto tile = [&](int n) {
    return q_first + (start + n < n_tiles ? start + n : start + n - n_tiles);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                 // full: the producer's arrive + bytes
      mbar_init(bars + 8 * (kStages + s), 8);     // empty: one arrive per consumer warp
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  const int own = key0 + (tid & (kBlockKeys - 1));
  if (!__syncthreads_or(tid < kBlockKeys && own < seq && valid[own] != 0)) {
    // every key of the block is padded: dk = dv = 0, nothing loaded
    const int rows = min(kBlockKeys, seq - key0), chunks = dim / 8;
    for (int x = tid; x < rows * chunks; x += kThreadsW) {
      const size_t off = (static_cast<size_t>(bh) * seq + key0 + x / chunks) * dim + 8 * (x % chunks);
      *reinterpret_cast<uint4*>(dk_out + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv_out + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  if (tid >= kConsumers) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(kv_bar, L::kFixed);
      for (int a = 0; a < ATOMS; ++a)
        for (int half = 0; half < 2; ++half) {
          tma_load_3d(s_k + (2 * a + half) * kBox, &map_k, kv_bar, 64 * a, key0 + 64 * half, bh);
          tma_load_3d(s_v + (2 * a + half) * kBox, &map_v, kv_bar, 64 * a, key0 + 64 * half, bh);
        }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(bars + 8 * (kStages + s), (n / kStages - 1) & 1);
        const uint32_t st = s_ring + s * L::kStage;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, L::kStage);
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_3d(st + a * kBox, &map_q, full, 64 * a, 64 * tile(n), bh);
          tma_load_3d(st + (ATOMS + a) * kBox, &map_do, full, 64 * a, 64 * tile(n), bh);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key = key0 + 64 * wg + 16 * warp + g;  // this thread's rows: key, key + 8
  // 0 for a valid key row, −inf for a padded one (or one past T): P = 0
  const float bias0 = key < seq && valid[key] != 0 ? 0.f : -INFINITY;
  const float bias1 = key + 8 < seq && valid[key + 8] != 0 ? 0.f : -INFINITY;
  // (CHUNKED) the first query that sees each of this thread's key rows
  const int first0 = CHUNKED ? key / chunk * chunk : 0;
  const int first1 = CHUNKED ? (key + 8) / chunk * chunk : 0;
  const float* lse_h = lse + static_cast<size_t>(bh) * seq;
  const float* delta_h = delta + static_cast<size_t>(bh) * seq;
  const bool issuer = (tid & 127) == 0;  // its warpgroup's bulk copies and reduce-adds

  // the lse (+inf past T, so P = 0 there) and delta of tile n's queries into
  // rows buffer n % 2; both warpgroups write the same values, without a branch
  auto stage_rows = [&](int n) {
    const int q = 64 * tile(n) + (tid & 63);
    const float x = ((tid & 64) ? delta_h : lse_h)[min(q, seq - 1)];
    rows_s[(n & 1) * 128 + (tid & 127)] = q < seq ? x : ((tid & 64) ? 0.f : INFINITY);
  };

  float dk[ATOMS][32], dv[ATOMS][32];
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
#pragma unroll
    for (int r = 0; r < 32; ++r) dk[a][r] = dv[a][r] = 0.f;
  float st[32], dpt[32], dq[kDqCols / 2];

  // dQ of tile n (complete) into this warpgroup's staging boxes, then one TMA
  // reduce-add per box into the fp32 accumulator (rows past T and columns
  // past D dropped by TMA)
  auto reduce_dq = [&](int n) {
    const uint32_t box = s_dq + ((n % L::kDqBufs) * 2 + wg) * ATOMS * kBoxF32;
    if constexpr (L::kDqBufs == 1) {  // the box's last reduce-add has read it
      bulk_wait_read<0>();
      warpgroup_sync(wg);
    }
    acc_to_f32_boxes(gbase + (box - base), dq, warp, g, t);
    fence_proxy_async();
    // with two boxes, the previous tile's reduce-add has read the other one
    // by this barrier, so the next tile may write it without one of its own
    if constexpr (L::kDqBufs == 2) bulk_wait_read<0>();
    warpgroup_sync(wg);
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      tma_reduce_add_3d_if(&map_dq, box + a * kBoxF32, kDqCols * wg + 32 * a, 64 * tile(n), bh,
                           issuer && kDqCols * wg + 32 * a < dim);
    bulk_commit();
  };

  // One query tile; its Sᵀ and dPᵀ are in flight when it starts.  With
  // `next`, tile n + 1's Sᵀ queues behind its dV, dK and dQ and runs while
  // it reduce-adds dQ; then tile n + 1's dPᵀ, which runs while tile n + 1
  // computes Pᵀ.  (Sᵀ, dPᵀ and dQ in registers at once spill, and ptxas
  // then serialises every wgmma.)
  auto step = [&](int n, auto next) {
    // shared-memory addresses from an opaque copy of the base, so the
    // descriptors are formed where they are used and not hoisted into
    // registers across the loop
    uint32_t b0;
    asm volatile("mov.u32 %0, %1;\n" : "=r"(b0) : "r"(base));
    const uint32_t s_k = b0, s_v = b0 + ATOMS * 2 * kBox, s_ring = b0 + L::kFixed;
    const uint32_t s_dst = b0 + L::kDsT, s_pt = b0 + L::kPT;
    const uint32_t stage = s_ring + (n % kStages) * L::kStage;
    const float* ls = rows_s + (n & 1) * 128;  // lse of the tile's 64 queries, then delta

    // Pᵀ in place of Sᵀ: 0 for a padded key row (bias −inf), for query
    // columns past T (lse +inf) and (CHUNKED) for queries before a key
    // row's chunk
    wgmma_wait<1>();
    fence_acc(st);
    const int qt = 64 * tile(n) + 2 * t;  // this thread's first query column
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      float b00 = bias0, b01 = bias0, b10 = bias1, b11 = bias1;
      if constexpr (CHUNKED) {
        const int qc = qt + 8 * j;
        b00 = qc >= first0 ? bias0 : -INFINITY;
        b01 = qc + 1 >= first0 ? bias0 : -INFINITY;
        b10 = qc >= first1 ? bias1 : -INFINITY;
        b11 = qc + 1 >= first1 ? bias1 : -INFINITY;
      }
      st[4 * j + 0] = fast_exp2(fmaf(st[4 * j + 0], scale_log2, b00 - l2.x));
      st[4 * j + 1] = fast_exp2(fmaf(st[4 * j + 1], scale_log2, b01 - l2.y));
      st[4 * j + 2] = fast_exp2(fmaf(st[4 * j + 2], scale_log2, b10 - l2.x));
      st[4 * j + 3] = fast_exp2(fmaf(st[4 * j + 3], scale_log2, b11 - l2.y));
    }
    // dSᵀ = Pᵀ∘(dPᵀ − D) in place of dPᵀ
    wgmma_wait<0>();
    fence_acc(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(ls + 64 + 8 * j + 2 * t);
      dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - d2.x);
      dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d2.y);
      dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d2.x);
      dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d2.y);
    }

    // Pᵀ and dSᵀ to shared memory as bf16 (dSᵀ for dQ too), so no register
    // holds an operand of a product in flight; dV += Pᵀ·dO and dK += dSᵀ·Q,
    // 16 queries per step, A K-major from those boxes, B MN-major from the
    // ring
    const uint32_t pt = s_pt + wg * kBox, dst_own = s_dst + (2 * (n & 1) + wg) * kBox;
    acc_to_box(gbase + (pt - b0), st, 1.f, warp, g, t);
    acc_to_box(gbase + (dst_own - b0), dpt, 1.f, warp, g, t);
    fence_proxy_async();
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        wgmma_sn(dv[a], desc_k(pt + kq * 32), desc_mn(stage + (ATOMS + a) * kBox + kq * 2048));
        wgmma_sn(dk[a], desc_k(dst_own + kq * 32), desc_mn(stage + a * kBox + kq * 2048));
      }
    wgmma_commit();

    // dQ = dS·K over the block's 128 keys, once both halves of dSᵀ are in
    // place: A = dSᵀ read transposed, B = K read MN-major, this warpgroup's
    // columns (a 64-byte offset into the box for D ≤ 64, its own box above)
    named_sync(kBothGroups, kConsumers);
    const uint32_t dst = s_dst + 2 * (n & 1) * kBox;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t kb = ATOMS == 1 ? s_k + (kk / 4) * kBox + 64 * wg
                                     : s_k + (2 * wg + kk / 4) * kBox;
      wgmma_tt(dq, desc_mn(dst + (kk / 4) * kBox + (kk % 4) * 2048), desc_mn(kb + (kk % 4) * 2048),
               kk > 0);
    }
    wgmma_commit();

    // (D > 64: dK and dV alone take 128 registers, so Sᵀ waits for dQ)
    constexpr bool kAhead = decltype(next)::value && ATOMS == 1;
    const uint32_t stage1 = s_ring + ((n + 1) % kStages) * L::kStage;
    if constexpr (decltype(next)::value) {
      stage_rows(n + 1);
      mbar_wait(bars + 8 * ((n + 1) % kStages), ((n + 1) / kStages) & 1);
    }
    if constexpr (kAhead) {
      issue_product<ATOMS>(st, s_k, stage1, wg);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    // dV, dK and dQ of this tile are complete: its ring stage is free
    fence_acc(dq);
    mbar_arrive_if(bars + 8 * (kStages + n % kStages), lane == 0);
    reduce_dq(n);
    if constexpr (decltype(next)::value && !kAhead) issue_product<ATOMS>(st, s_k, stage1, wg);
    if constexpr (decltype(next)::value) issue_product<ATOMS>(dpt, s_v, stage1 + ATOMS * kBox, wg);
  };

  mbar_wait(kv_bar, 0);
  stage_rows(0);
  named_sync(kBothGroups, kConsumers);
  mbar_wait(bars, 0);
  issue_product<ATOMS>(st, s_k, s_ring, wg);
  issue_product<ATOMS>(dpt, s_v, s_ring + ATOMS * kBox, wg);
  for (int n = 0; n + 1 < n_tiles; ++n) step(n, std::true_type{});
  step(n_tiles - 1, std::false_type{});
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) {
    fence_acc(dk[a]);
    fence_acc(dv[a]);
  }
  // every dQ product has read K: dk, dv over this warpgroup's own K and V
  // boxes, then one TMA store each
  named_sync(kBothGroups, kConsumers);
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) {
    acc_to_box(gbase + (s_k - base) + (2 * a + wg) * kBox, dk[a], scale, warp, g, t);
    acc_to_box(gbase + (s_v - base) + (2 * a + wg) * kBox, dv[a], 1.f, warp, g, t);
  }
  fence_proxy_async();
  warpgroup_sync(wg);
  if (issuer && key0 + 64 * wg < seq) {
    for (int a = 0; a < ATOMS; ++a) {
      tma_store_3d(&map_dk, s_k + (2 * a + wg) * kBox, 64 * a, key0 + 64 * wg, bh);
      tma_store_3d(&map_dv, s_v + (2 * a + wg) * kBox, 64 * a, key0 + 64 * wg, bh);
    }
  }
  tma_store_drain();  // also waits for the reduce-adds to have read their boxes
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const uint8_t* key_valid;
  int batch, n_heads, seq, dim;
  float scale, scale_log2;
  int chunk;
  cudaStream_t stream;
};

template <int DP>
void launch_f32(const BwdArgs& a, void* dq, void* dk, void* dv) {
  const dim3 grid((a.seq + kOwnRows - 1) / kOwnRows, a.n_heads, a.batch);
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
  attn_bwd_dkv_f32_kernel<DP><<<grid, kThreadsF, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, a.key_valid, static_cast<float*>(dk), static_cast<float*>(dv),
      a.n_heads, a.seq, a.dim, a.scale, a.scale_log2, a.chunk);
  attn_bwd_dq_f32_kernel<DP><<<grid, kThreadsF, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, a.key_valid, static_cast<float*>(dq), a.n_heads, a.seq, a.dim,
      a.scale, a.scale_log2, a.chunk);
}

// what TMA needs of the bf16 operands; nullptr when every check passes
const char* check_tma(const BwdArgs& a, std::initializer_list<const void*> more) {
  if (encode_tiled() == nullptr) return "cuTensorMapEncodeTiled is not available from the driver";
  if (a.dim % 8 != 0) return "bf16 head dim must be a multiple of 8 (the wrapper pads it)";
  for (const void* p : {a.q, a.k, a.v, a.dout})
    if (!aligned16(p)) return "bf16 backward operands must be 16-byte aligned";
  for (const void* p : more)
    if (!aligned16(p)) return "bf16 backward outputs and scratch must be 16-byte aligned";
  return nullptr;
}

template <int ATOMS, bool CHUNKED>
const char* launch_bf16(const BwdArgs& a, float* dq_acc, void* dq, void* dk, void* dv) {
  if (const char* err = check_tma(a, {dq_acc, dq, dk, dv})) return err;
  const int bh = a.batch * a.n_heads;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv, mdq;
  if (!encode_heads(&mq, a.q, bh, a.seq, a.dim) || !encode_heads(&mk, a.k, bh, a.seq, a.dim) ||
      !encode_heads(&mv, a.v, bh, a.seq, a.dim) || !encode_heads(&mdo, a.dout, bh, a.seq, a.dim) ||
      !encode_heads(&mdk, dk, bh, a.seq, a.dim) || !encode_heads(&mdv, dv, bh, a.seq, a.dim) ||
      !encode_heads_f32(&mdq, dq_acc, bh, a.seq, a.dim))
    return "cuTensorMapEncodeTiled refused a tensor map";
  const auto kernel = attn_bwd_dkv_dq_bf16_wgmma_kernel<ATOMS, CHUNKED>;
  const int smem = static_cast<int>(Layout<ATOMS>::kBytes);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return "cudaFuncSetAttribute refused the backward kernel's shared memory";
  const dim3 grid((a.seq + kBlockKeys - 1) / kBlockKeys, a.n_heads, a.batch);
  kernel<<<grid, kThreadsW, smem, a.stream>>>(
      mq, mk, mv, mdo, mdk, mdv, mdq, a.lse, a.delta, a.key_valid,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.n_heads, a.seq, a.dim,
      a.scale, a.scale_log2, a.chunk);
  const long long n4 = static_cast<long long>(bh) * a.seq * a.dim / 4;
  attn_bwd_dq_convert_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<uint2*>(dq), n4, a.scale);
  return nullptr;
}

template <int ATOMS>
const char* launch_bf16_chunk(const BwdArgs& a, float* dq_acc, void* dq, void* dk, void* dv) {
  return a.chunk > 0 ? launch_bf16<ATOMS, true>(a, dq_acc, dq, dk, dv)
                     : launch_bf16<ATOMS, false>(a, dq_acc, dq, dk, dv);
}

}  // namespace

// Launch on `stream` without synchronising; return nullptr, or why nothing
// was launched.  The caller checks cudaGetLastError.  q, k, v, dout, out,
// dq, dk, dv: contiguous (B, H, T, D) in one dtype; lse: (B, H, T) fp32 from
// the forward; key_valid: (B, T) uint8; delta: (B, H, T) fp32 scratch that
// the pre-pass fills with rowsum(dout∘out); dq_acc: (B, H, T, D) fp32
// scratch for bf16 (unused for fp32); scale: the softmax scale of the true
// head dim (bf16 takes D padded to a multiple of 8, 16-byte-aligned
// pointers); chunk: the forward's (0, or the chunk-causal chunk).
const char* masked_attention_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const void* out, const float* lse,
                                        const uint8_t* key_valid, float* delta, float* dq_acc,
                                        void* dq, void* dk, void* dv, int batch, int n_heads,
                                        int seq, int dim, float scale, bool bf16, int chunk,
                                        cudaStream_t stream) {
  if (dim < 1 || dim > 128) return "head dim outside [1, 128]";
  if (chunk < 0) return "chunk must be 0 (none) or positive";
  const BwdArgs a{q,   k,       v,   dout, lse,   delta,
                  key_valid, batch, n_heads, seq, dim, scale,
                  static_cast<float>(static_cast<double>(scale) * 1.4426950408889634), chunk,
                  stream};
  const long long rows = static_cast<long long>(batch) * n_heads * seq;
  const unsigned delta_blocks = static_cast<unsigned>((rows + kDeltaRows - 1) / kDeltaRows);
  if (bf16) {
    if (dim % 8 != 0) return "bf16 head dim must be a multiple of 8 (the wrapper pads it)";
    if (!aligned16(out) || !aligned16(dq_acc)) return "bf16 backward operands must be 16-byte aligned";
    attn_bwd_dq_delta_kernel<__nv_bfloat16><<<delta_blocks, kDeltaRows * kLanes, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(out), delta,
        dq_acc, rows, dim);
    return dim <= 64 ? launch_bf16_chunk<1>(a, dq_acc, dq, dk, dv)
                     : launch_bf16_chunk<2>(a, dq_acc, dq, dk, dv);
  }
  attn_bwd_dq_delta_kernel<float><<<delta_blocks, kDeltaRows * kLanes, 0, stream>>>(
      static_cast<const float*>(dout), static_cast<const float*>(out), delta, nullptr, rows, dim);
  if (dim <= 8) launch_f32<8>(a, dq, dk, dv);
  else if (dim <= 16) launch_f32<16>(a, dq, dk, dv);
  else if (dim <= 32) launch_f32<32>(a, dq, dk, dv);
  else if (dim <= 48) launch_f32<48>(a, dq, dk, dv);
  else if (dim <= 64) launch_f32<64>(a, dq, dk, dv);
  else if (dim <= 96) launch_f32<96>(a, dq, dk, dv);
  else launch_f32<128>(a, dq, dk, dv);
  return nullptr;
}

// Registers, static and dynamic shared memory, local (spill) bytes and the
// thread count of the bf16 backward kernel that serves `dim`.  out[5];
// returns the cudaFuncGetAttributes error.
cudaError_t masked_attention_bwd_attributes(int dim, int* out) {
  cudaFuncAttributes fa{};
  const bool wide = dim > 64;
  const void* fn = wide ? reinterpret_cast<const void*>(attn_bwd_dkv_dq_bf16_wgmma_kernel<2, false>)
                        : reinterpret_cast<const void*>(attn_bwd_dkv_dq_bf16_wgmma_kernel<1, false>);
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(wide ? Layout<2>::kBytes : Layout<1>::kBytes);
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = kThreadsW;
  return err;
}

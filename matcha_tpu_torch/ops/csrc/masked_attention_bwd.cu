// Masked self-attention backward for Hopper (sm_90a): dq, dk, dv of
// out = softmax(q·kᵀ/√D over the valid keys)·v.
//
// Replaces the Pallas TPU flash-attention backward that the JAX package
// differentiates through (jax/experimental/pallas/ops/tpu/flash_attention.py):
// _flash_attention_dkv_kernel :796, called from _flash_attention_bwd_dkv
// :941 → pallas_call :1121, and _flash_attention_dq_kernel :1146, called
// from _flash_attention_bwd_dq :1287 → pallas_call :1456.  Same split: one
// kernel per key block loops over the query tiles for dk, dv; one kernel per
// query block loops over the key tiles for dq; no atomics, so dq is
// deterministic.  P is recomputed from q, k and the forward's log-sum-exp
// (log2 units, see masked_attention_fwd.cu); D_i = rowsum(dO∘O) arrives
// precomputed in fp32, as the TPU wrapper computes it outside its kernels:
//   S = q·kᵀ, P = exp2(S·scale·log2e − lse), dV = Pᵀ·dO, dP = dO·vᵀ,
//   dS = P∘(dP − D), dQ = scale·dS·k, dK = scale·dSᵀ·q.
// Padded keys get dk = dv = 0; every query row, padded or not, back-
// propagates through the valid keys it attended, as in the forward.
//
// What bounds it on the card: at the decoder's training shapes (B=29..62,
// H=5, T=256..1088, D=64, bf16) the function is five products,
// 10·B·H·T²·D flops, against about 8·B·H·T·D·2 bytes, so the tensor cores
// and not the memory set the bound (52.6 µs at (62,5,512,64) on an H100).
// The split recomputes S and dP in both kernels: 7 products are computed
// against the 5 of the bound, so the pair cannot come closer than 5/7 of it.
//
// bf16 design (the training path):
//   dkv  one block per (128 keys, head, batch row): two consumer warpgroups
//        of 64 keys and one producer warp (288 threads).  K and V of the
//        block go once into shared memory by TMA; Q and dO stream as
//        64-query tiles through a ring of kStages stages, each stage with a
//        full and an empty mbarrier; the producer's one thread keeps the
//        ring loaded while the warpgroups compute.  Per tile each warpgroup
//        runs Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as wgmma m64n64k16 from shared
//        memory (both operands K-major), forms Pᵀ and dSᵀ in the accumulator
//        registers, and runs dV += Pᵀ·dO and dK += dSᵀ·Q with A from
//        registers (the fp32 accumulator layout of 16 columns is the bf16
//        A-register layout of k16) and B = the dO or Q tile read MN-major
//        (transpose bit).  The tile's lse and delta (64 fp32 each) are read
//        by the consumers from L1/L2, issued before the products.
//   dq   one block per (128 queries, head, batch row), the same roles: Q and
//        dO once in shared memory, lse and delta per row in registers, K and
//        V stream through the ring, the tile's key mask is read beside them.
//        S = Q·Kᵀ and dP = dO·Vᵀ from shared memory, dQ += dS·K with A = dS
//        from registers and B = the K tile MN-major.
//   Every tile is a (64 rows × 64 columns) bf16 TMA box with 128-byte
//   swizzle, from a 3-D tensor map (D, T, B·H): rows past T and columns
//   past D arrive as zeros and never from the next head.  dk, dv and dq go
//   back through shared memory in the same swizzled layout and leave by a
//   TMA store, which drops rows past T and columns past D.  D ≤ 64 is one
//   64-column box, 64 < D ≤ 128 two; the wrapper pads a head dim that is not
//   a multiple of 8 (TMA needs 16-byte row strides) and passes the true
//   scale.  P is exp2 by ex2.approx; padded keys and rows past T get P = 0
//   without a branch before a product (ptxas serialises wgmma behind
//   divergent code, C7520).
//   What this does about the four costs of the mma.sync kernels it
//   replaces: (1) loads were synchronous and serialised with the math: the
//   producer warp keeps up to kStages tiles in flight on mbarriers while
//   the warpgroups compute; (2) the transposed operands were gathered from
//   shared memory 16 bits at a time: wgmma reads them MN-major from the
//   swizzled tile, no thread loads a B operand; (3) tiles of 32 queries and
//   mma.sync m16n8k16: 64-row tiles and wgmma, the only path to Hopper's
//   tensor-core rate; (4) scattered 16-bit epilogue stores: one TMA store
//   per 64 × 64 box.
//   What still holds it back (see PERF.md): one block of two warpgroups per
//   SM (168 registers a thread in dkv), and each warpgroup waits for its own
//   products twice per tile, so the tensor cores idle while it computes P.
//
// fp32 (the reference checks): exact fp32 FMAs (no TF32), a block owns 16
// rows, 8 threads per row each holding every 8th head dim; row dot products
// are reduced by warp shuffles.  Any T, head dims 1..128.

#include <initializer_list>

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
// bf16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kStages = 2;  // ring depth; 2, 3 and 4 measured, 2 fastest (PERF.md)
constexpr int kConsumers = 256;                // two warpgroups of 64 rows each
constexpr int kThreadsW = kConsumers + 32;     // + one producer warp
constexpr int kBlockRows = 128;                // rows (keys or queries) a block owns

// Shared memory of both kernels, from a 1024-byte-aligned base:
//   fixed  [ATOMS][2 halves] boxes of the first operand (K or Q), then of the
//          second (V or dO): the block's 128 rows, 64 per warpgroup
//   ring   kStages × ([ATOMS] boxes of the first streamed operand (Q or K),
//          [ATOMS] of the second (dO or V))
//   bars   full[kStages], empty[kStages], fixed
template <int ATOMS>
struct Layout {
  static constexpr uint32_t kFixed = 2 * ATOMS * 2 * kBox;
  static constexpr uint32_t kStage = 2 * ATOMS * kBox;
  static constexpr uint32_t kBars = kFixed + kStages * kStage;
  static constexpr uint32_t kBytes = kBars + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
};

template <int ATOMS>
__global__ void __launch_bounds__(kThreadsW, 1)
attn_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const __grid_constant__ CUtensorMap map_dk,
                               const __grid_constant__ CUtensorMap map_dv,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const uint8_t* __restrict__ key_valid, int n_heads, int seq,
                               float scale, float scale_log2) {
  using L = Layout<ATOMS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t s_k = base, s_v = base + ATOMS * 2 * kBox, s_ring = base + L::kFixed;
  const uint32_t bars = base + L::kBars;
  const uint32_t kv_bar = bars + 16 * kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int bh = b * n_heads + blockIdx.y;
  const int key0 = blockIdx.x * kBlockRows;
  const int n_tiles = (seq + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                 // full: the producer's arrive + bytes
      mbar_init(bars + 8 * (kStages + s), 8);     // empty: one arrive per consumer warp
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(kv_bar, L::kFixed);
      for (int a = 0; a < ATOMS; ++a)
        for (int half = 0; half < 2; ++half) {
          tma_load_3d(s_k + (2 * a + half) * kBox, &map_k, kv_bar, 64 * a, key0 + 64 * half, bh);
          tma_load_3d(s_v + (2 * a + half) * kBox, &map_v, kv_bar, 64 * a, key0 + 64 * half, bh);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(bars + 8 * (kStages + s), (i / kStages - 1) & 1);
        const uint32_t st = s_ring + s * L::kStage;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, L::kStage);
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_3d(st + a * kBox, &map_q, full, 64 * a, 64 * i, bh);
          tma_load_3d(st + (ATOMS + a) * kBox, &map_do, full, 64 * a, 64 * i, bh);
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
  const int key = key0 + 64 * wg + 16 * warp + g;  // this thread's rows: key, key + 8
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;
  const bool ok0 = key < seq && valid[key] != 0;
  const bool ok1 = key + 8 < seq && valid[key + 8] != 0;
  const float* lse_h = lse + static_cast<size_t>(bh) * seq;
  const float* delta_h = delta + static_cast<size_t>(bh) * seq;

  float dk[ATOMS][32], dv[ATOMS][32];
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
#pragma unroll
    for (int r = 0; r < 32; ++r) dk[a][r] = dv[a][r] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t st = s_ring + s * L::kStage;
    // the tile's lse and delta at this thread's query columns 8j + 2t + c
    // (L1/L2 hits: every warp reads the same 64 values), loaded before the
    // products so their latency hides behind them; columns past T get
    // P = 0 below, whatever is read there
    const int q0 = 64 * i;
    float l_r[16], d_r[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = min(q0 + 8 * j + 2 * t + c, seq - 1);
        l_r[2 * j + c] = lse_h[q];
        d_r[2 * j + c] = delta_h[q];
      }
    mbar_wait(bars + 8 * s, (i / kStages) & 1);

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warpgroup's 64 keys × the tile's 64 queries
    float st_acc[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * ATOMS; ++kk)
      wgmma_ss(st_acc, desc_k(s_k + (kk / 4) * 2 * kBox + wg * kBox + (kk % 4) * 32),
               desc_k(st + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * ATOMS; ++kk)
      wgmma_ss(dpt, desc_k(s_v + (kk / 4) * 2 * kBox + wg * kBox + (kk % 4) * 32),
               desc_k(st + (ATOMS + kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();

    // Pᵀ in place of Sᵀ, as predicated selects (0 for a padded key row
    // and for query columns past T); measured faster here than an added
    // −inf bias, unlike dq, whose mask load did branch
    wgmma_wait<1>();
    fence_acc(st_acc);
    const bool tail = q0 + 64 > seq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const bool in0 = !tail || q0 + c < seq;
      const bool in1 = !tail || q0 + c + 1 < seq;
      const float la = l_r[2 * j], lb = l_r[2 * j + 1];
      st_acc[4 * j + 0] = (ok0 && in0) ? fast_exp2(fmaf(st_acc[4 * j + 0], scale_log2, -la)) : 0.f;
      st_acc[4 * j + 1] = (ok0 && in1) ? fast_exp2(fmaf(st_acc[4 * j + 1], scale_log2, -lb)) : 0.f;
      st_acc[4 * j + 2] = (ok1 && in0) ? fast_exp2(fmaf(st_acc[4 * j + 2], scale_log2, -la)) : 0.f;
      st_acc[4 * j + 3] = (ok1 && in1) ? fast_exp2(fmaf(st_acc[4 * j + 3], scale_log2, -lb)) : 0.f;
    }
    // dSᵀ = Pᵀ∘(dPᵀ − D) in place of dPᵀ
    wgmma_wait<0>();
    fence_acc(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float da = d_r[2 * j], db = d_r[2 * j + 1];
      dpt[4 * j + 0] = st_acc[4 * j + 0] * (dpt[4 * j + 0] - da);
      dpt[4 * j + 1] = st_acc[4 * j + 1] * (dpt[4 * j + 1] - db);
      dpt[4 * j + 2] = st_acc[4 * j + 2] * (dpt[4 * j + 2] - da);
      dpt[4 * j + 3] = st_acc[4 * j + 3] * (dpt[4 * j + 3] - db);
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q, 16 queries per step, B read MN-major
    uint32_t pa[4][4], sa[4][4];
    acc_to_a(pa, st_acc);
    acc_to_a(sa, dpt);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        wgmma_rs(dv[a], pa[kq], desc_mn(st + (ATOMS + a) * kBox + kq * 2048));
        wgmma_rs(dk[a], sa[kq], desc_mn(st + a * kBox + kq * 2048));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) {
      fence_acc(dk[a]);
      fence_acc(dv[a]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }

  // dk, dv over this warpgroup's own K and V boxes, then one TMA store each
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) {
    acc_to_box(gbase + (s_k - base) + (2 * a + wg) * kBox, dk[a], scale, warp, g, t);
    acc_to_box(gbase + (s_v - base) + (2 * a + wg) * kBox, dv[a], 1.f, warp, g, t);
  }
  fence_proxy_async();
  warpgroup_sync(wg);
  if ((tid & 127) == 0 && key0 + 64 * wg < seq) {
    for (int a = 0; a < ATOMS; ++a) {
      tma_store_3d(&map_dk, s_k + (2 * a + wg) * kBox, 64 * a, key0 + 64 * wg, bh);
      tma_store_3d(&map_dv, s_v + (2 * a + wg) * kBox, 64 * a, key0 + 64 * wg, bh);
    }
    tma_store_drain();
  }
}

template <int ATOMS>
__global__ void __launch_bounds__(kThreadsW, 1)
attn_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const __grid_constant__ CUtensorMap map_dq,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const uint8_t* __restrict__ key_valid, int n_heads, int seq,
                              float scale, float scale_log2) {
  using L = Layout<ATOMS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t s_q = base, s_do = base + ATOMS * 2 * kBox, s_ring = base + L::kFixed;
  const uint32_t bars = base + L::kBars;
  const uint32_t qdo_bar = bars + 16 * kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int bh = b * n_heads + blockIdx.y;
  const int q0 = blockIdx.x * kBlockRows;
  const int n_tiles = (seq + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 8);
    }
    mbar_init(qdo_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      mbar_expect_tx(qdo_bar, L::kFixed);
      for (int a = 0; a < ATOMS; ++a)
        for (int half = 0; half < 2; ++half) {
          tma_load_3d(s_q + (2 * a + half) * kBox, &map_q, qdo_bar, 64 * a, q0 + 64 * half, bh);
          tma_load_3d(s_do + (2 * a + half) * kBox, &map_do, qdo_bar, 64 * a, q0 + 64 * half, bh);
        }
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
  const int row = q0 + 64 * wg + 16 * warp + g;  // this thread's rows: row, row + 8
  const size_t rows = static_cast<size_t>(bh) * seq;
  const float lse0 = row < seq ? lse[rows + row] : INFINITY;
  const float lse1 = row + 8 < seq ? lse[rows + row + 8] : INFINITY;
  const float dl0 = row < seq ? delta[rows + row] : 0.f;
  const float dl1 = row + 8 < seq ? delta[rows + row + 8] : 0.f;
  const uint8_t* valid = key_valid + static_cast<size_t>(b) * seq;

  float dq[ATOMS][32];
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
#pragma unroll
    for (int r = 0; r < 32; ++r) dq[a][r] = 0.f;

  mbar_wait(qdo_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t st = s_ring + s * L::kStage;
    // bit 2j + c: key 8j + 2t + c of the tile (this thread's columns) is
    // valid and below T; loaded before the products so the latency hides
    // behind them.  Branch-free: a branch before the products makes ptxas
    // serialise them (C7520).
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

    // S = Q·Kᵀ and dP = dO·Vᵀ: this warpgroup's 64 queries × the tile's 64 keys
    float s_acc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * ATOMS; ++kk)
      wgmma_ss(s_acc, desc_k(s_q + (kk / 4) * 2 * kBox + wg * kBox + (kk % 4) * 32),
               desc_k(st + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * ATOMS; ++kk)
      wgmma_ss(dp, desc_k(s_do + (kk / 4) * 2 * kBox + wg * kBox + (kk % 4) * 32),
               desc_k(st + (ATOMS + kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();

    // P in place of S: a −inf bias for padded keys and keys past T
    wgmma_wait<1>();
    fence_acc(s_acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bias0 = ((key_bits >> (2 * j)) & 1u) ? 0.f : -INFINITY;
      const float bias1 = ((key_bits >> (2 * j + 1)) & 1u) ? 0.f : -INFINITY;
      s_acc[4 * j + 0] = fast_exp2(fmaf(s_acc[4 * j + 0], scale_log2, bias0 - lse0));
      s_acc[4 * j + 1] = fast_exp2(fmaf(s_acc[4 * j + 1], scale_log2, bias1 - lse0));
      s_acc[4 * j + 2] = fast_exp2(fmaf(s_acc[4 * j + 2], scale_log2, bias0 - lse1));
      s_acc[4 * j + 3] = fast_exp2(fmaf(s_acc[4 * j + 3], scale_log2, bias1 - lse1));
    }
    // dS = P∘(dP − D) in place of dP
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dp[4 * j + 0] = s_acc[4 * j + 0] * (dp[4 * j + 0] - dl0);
      dp[4 * j + 1] = s_acc[4 * j + 1] * (dp[4 * j + 1] - dl0);
      dp[4 * j + 2] = s_acc[4 * j + 2] * (dp[4 * j + 2] - dl1);
      dp[4 * j + 3] = s_acc[4 * j + 3] * (dp[4 * j + 3] - dl1);
    }

    // dQ += dS·K, 16 keys per step, B = the K tile read MN-major
    uint32_t sa[4][4];
    acc_to_a(sa, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        wgmma_rs(dq[a], sa[kk], desc_mn(st + a * kBox + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) fence_acc(dq[a]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }

  // dq over this warpgroup's own Q boxes, then one TMA store per box
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
    acc_to_box(gbase + (s_q - base) + (2 * a + wg) * kBox, dq[a], scale, warp, g, t);
  fence_proxy_async();
  warpgroup_sync(wg);
  if ((tid & 127) == 0 && q0 + 64 * wg < seq) {
    for (int a = 0; a < ATOMS; ++a)
      tma_store_3d(&map_dq, s_q + (2 * a + wg) * kBox, 64 * a, q0 + 64 * wg, bh);
    tma_store_drain();
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const uint8_t* key_valid;
  int batch, n_heads, seq, dim;
  float scale, scale_log2;
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

// what TMA needs of the bf16 operands; nullptr when every check passes
const char* check_tma(const BwdArgs& a, std::initializer_list<const void*> out) {
  if (encode_tiled() == nullptr) return "cuTensorMapEncodeTiled is not available from the driver";
  if (a.dim % 8 != 0) return "bf16 head dim must be a multiple of 8 (the wrapper pads it)";
  for (const void* p : {a.q, a.k, a.v, a.dout})
    if (!aligned16(p)) return "bf16 backward operands must be 16-byte aligned";
  for (const void* p : out)
    if (!aligned16(p)) return "bf16 backward outputs must be 16-byte aligned";
  return nullptr;
}

const char* const kEncodeFailed = "cuTensorMapEncodeTiled refused a tensor map";

template <int ATOMS>
const char* launch_dkv_bf16(const BwdArgs& a, void* dk, void* dv) {
  if (const char* err = check_tma(a, {dk, dv})) return err;
  const int bh = a.batch * a.n_heads;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!encode_heads(&mq, a.q, bh, a.seq, a.dim) || !encode_heads(&mk, a.k, bh, a.seq, a.dim) ||
      !encode_heads(&mv, a.v, bh, a.seq, a.dim) || !encode_heads(&mdo, a.dout, bh, a.seq, a.dim) ||
      !encode_heads(&mdk, dk, bh, a.seq, a.dim) || !encode_heads(&mdv, dv, bh, a.seq, a.dim))
    return kEncodeFailed;
  const auto kernel = attn_bwd_dkv_bf16_wgmma_kernel<ATOMS>;
  const int smem = static_cast<int>(Layout<ATOMS>::kBytes);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return "cudaFuncSetAttribute refused the dkv kernel's shared memory";
  const dim3 grid((a.seq + kBlockRows - 1) / kBlockRows, a.n_heads, a.batch);
  kernel<<<grid, kThreadsW, smem, a.stream>>>(mq, mk, mv, mdo, mdk, mdv, a.lse, a.delta,
                                              a.key_valid, a.n_heads, a.seq, a.scale,
                                              a.scale_log2);
  return nullptr;
}

template <int ATOMS>
const char* launch_dq_bf16(const BwdArgs& a, void* dq) {
  if (const char* err = check_tma(a, {dq})) return err;
  const int bh = a.batch * a.n_heads;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!encode_heads(&mq, a.q, bh, a.seq, a.dim) || !encode_heads(&mk, a.k, bh, a.seq, a.dim) ||
      !encode_heads(&mv, a.v, bh, a.seq, a.dim) || !encode_heads(&mdo, a.dout, bh, a.seq, a.dim) ||
      !encode_heads(&mdq, dq, bh, a.seq, a.dim))
    return kEncodeFailed;
  const auto kernel = attn_bwd_dq_bf16_wgmma_kernel<ATOMS>;
  const int smem = static_cast<int>(Layout<ATOMS>::kBytes);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return "cudaFuncSetAttribute refused the dq kernel's shared memory";
  const dim3 grid((a.seq + kBlockRows - 1) / kBlockRows, a.n_heads, a.batch);
  kernel<<<grid, kThreadsW, smem, a.stream>>>(mq, mk, mv, mdo, mdq, a.lse, a.delta, a.key_valid,
                                              a.n_heads, a.seq, a.scale, a.scale_log2);
  return nullptr;
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, const uint8_t* key_valid, int batch,
                  int n_heads, int seq, int dim, float scale, cudaStream_t stream) {
  return BwdArgs{q,     k,     v,   dout, lse, delta, key_valid, batch, n_heads, seq, dim, scale,
                 static_cast<float>(static_cast<double>(scale) * 1.4426950408889634), stream};
}

const char* const kBadDim = "head dim outside [1, 128]";

}  // namespace

// Launch on `stream` without synchronising; return nullptr, or why nothing
// was launched.  The caller checks cudaGetLastError.  q, k, v, dout, dq, dk,
// dv: contiguous (B, H, T, D) in one dtype; lse, delta: (B, H, T) fp32;
// key_valid: (B, T) uint8; scale: the softmax scale of the true head dim
// (bf16 takes D padded to a multiple of 8, 16-byte-aligned pointers).
const char* masked_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* delta, const uint8_t* key_valid,
                                            void* dk, void* dv, int batch, int n_heads, int seq,
                                            int dim, float scale, bool bf16,
                                            cudaStream_t stream) {
  if (dim < 1 || dim > 128) return kBadDim;
  const BwdArgs a =
      make_args(q, k, v, dout, lse, delta, key_valid, batch, n_heads, seq, dim, scale, stream);
  if (bf16) return dim <= 64 ? launch_dkv_bf16<1>(a, dk, dv) : launch_dkv_bf16<2>(a, dk, dv);
  if (dim <= 8) launch_dkv_f32<8>(a, dk, dv);
  else if (dim <= 16) launch_dkv_f32<16>(a, dk, dv);
  else if (dim <= 32) launch_dkv_f32<32>(a, dk, dv);
  else if (dim <= 48) launch_dkv_f32<48>(a, dk, dv);
  else if (dim <= 64) launch_dkv_f32<64>(a, dk, dv);
  else if (dim <= 96) launch_dkv_f32<96>(a, dk, dv);
  else launch_dkv_f32<128>(a, dk, dv);
  return nullptr;
}

const char* masked_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse, const float* delta,
                                           const uint8_t* key_valid, void* dq, int batch,
                                           int n_heads, int seq, int dim, float scale, bool bf16,
                                           cudaStream_t stream) {
  if (dim < 1 || dim > 128) return kBadDim;
  const BwdArgs a =
      make_args(q, k, v, dout, lse, delta, key_valid, batch, n_heads, seq, dim, scale, stream);
  if (bf16) return dim <= 64 ? launch_dq_bf16<1>(a, dq) : launch_dq_bf16<2>(a, dq);
  if (dim <= 8) launch_dq_f32<8>(a, dq);
  else if (dim <= 16) launch_dq_f32<16>(a, dq);
  else if (dim <= 32) launch_dq_f32<32>(a, dq);
  else if (dim <= 48) launch_dq_f32<48>(a, dq);
  else if (dim <= 64) launch_dq_f32<64>(a, dq);
  else if (dim <= 96) launch_dq_f32<96>(a, dq);
  else launch_dq_f32<128>(a, dq);
  return nullptr;
}

// Registers, static and dynamic shared memory, local (spill) bytes and the
// thread count of the bf16 backward kernel that serves `dim`: kernel 0 is
// dq, 1 is dkv.  out[5]; returns the cudaFuncGetAttributes error.
cudaError_t masked_attention_bwd_attributes(int kernel, int dim, int* out) {
  cudaFuncAttributes fa{};
  const bool wide = dim > 64;
  const void* fn =
      kernel == 0
          ? (wide ? reinterpret_cast<const void*>(attn_bwd_dq_bf16_wgmma_kernel<2>)
                  : reinterpret_cast<const void*>(attn_bwd_dq_bf16_wgmma_kernel<1>))
          : (wide ? reinterpret_cast<const void*>(attn_bwd_dkv_bf16_wgmma_kernel<2>)
                  : reinterpret_cast<const void*>(attn_bwd_dkv_bf16_wgmma_kernel<1>));
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(wide ? Layout<2>::kBytes : Layout<1>::kBytes);
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = kThreadsW;
  return err;
}

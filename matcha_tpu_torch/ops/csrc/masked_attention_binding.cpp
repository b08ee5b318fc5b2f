// PyTorch binding of the hand-written kernels in this directory.  The only
// file that includes torch/extension.h, so the .cu sources compile with the
// CUDA headers alone.

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

#include <array>
#include <initializer_list>
#include <map>
#include <string>

const char* masked_attention_fwd_launch(const void* q, const void* k, const void* v,
                                        const uint8_t* key_valid, void* out, float* lse,
                                        int batch, int n_heads, int seq, int dim, bool bf16,
                                        float qk_scale_log2, int layout, int chunk,
                                        cudaStream_t stream);
int masked_attention_fwd_layout(int batch, int n_heads, int seq);
cudaError_t masked_attention_fwd_attributes(int layout, int dim, int* out);
const char* masked_attention_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const void* out, const float* lse,
                                        const uint8_t* key_valid, float* delta, float* dq_acc,
                                        void* dq, void* dk, void* dv, int batch, int n_heads,
                                        int seq, int dim, float scale, bool bf16, int chunk,
                                        cudaStream_t stream);
cudaError_t masked_attention_bwd_attributes(int dim, int* out);
long long mas_scratch_words(int batch, int tx, int ty);
cudaError_t mas_launch(const float* value, const int* x_len, const int* y_len, int* idx,
                       uint32_t* scratch, int batch, int tx, int ty, cudaStream_t stream);
cudaError_t mas_attributes(int tx, int ty, int* out);
cudaError_t adamw_norm_launch(const long long* leaves, const long long* chunks, int n_chunks,
                              float* out, const float* given_norm, int* count,
                              int* notfinite_count, unsigned char* last_finite,
                              int* total_notfinite, float grad_clip, float b1, float b2,
                              int skip_nonfinite, int max_errors, cudaStream_t stream);
cudaError_t adamw_update_launch(const long long* leaves, const long long* chunks, int n_chunks,
                                const float* out, float one_minus_b1, float b1, float one_minus_b2,
                                float b2, float eps, float weight_decay, float neg_lr,
                                float grad_clip, cudaStream_t stream);
cudaError_t dit_modulate_fwd_launch(const float* h, const float* scale, const float* shift,
                                    long long ss_stride, void* y, bool bf16, float* mean,
                                    float* rstd, long long rows, int n, int width, float eps,
                                    cudaStream_t stream);
cudaError_t dit_modulate_bwd_launch(const void* dy, bool bf16, const float* h, const float* scale,
                                    long long ss_stride, const float* mean, const float* rstd,
                                    float* dh, float* partials, float* dscale_shift, int batch,
                                    int n, int width, int rows_per_tile, cudaStream_t stream);
cudaError_t dit_rope_heads_launch(const void* q, const void* k, const void* v, const float* rope,
                                  void* oq, void* ok, void* ov, bool bf16, bool backward,
                                  int batch, int n, int heads, int dim_head, cudaStream_t stream);
cudaError_t dit_gated_residual_fwd_launch(const float* h, const float* g, long long g_stride,
                                          const void* y, bool bf16, const float* u, float keep_p,
                                          const uint8_t* row_keep, float* out, uint8_t* bits,
                                          int batch, int n, int width, cudaStream_t stream);
cudaError_t dit_gated_residual_bwd_launch(const float* dout, const float* g, long long g_stride,
                                          const void* y, bool bf16, const uint8_t* bits,
                                          float keep_p, const uint8_t* row_keep, void* dy,
                                          float* partials, float* dg, int batch, int n, int width,
                                          int rows_per_tile, cudaStream_t stream);
cudaError_t dit_gelu_dropout_fwd_launch(const void* x, bool bf16, const float* u, float keep_p,
                                        void* y, uint8_t* bits, long long count,
                                        cudaStream_t stream);
cudaError_t dit_gelu_dropout_bwd_launch(const void* dy, const void* x, bool bf16,
                                        const uint8_t* bits, float keep_p, void* dx,
                                        long long count, cudaStream_t stream);

namespace {

// q, k, v and every tensor in `same`: contiguous (B, H, T, D), one dtype
// (float32 or bfloat16), one CUDA device.  Returns (B, H, T, D).
std::array<int64_t, 4> check_heads(const torch::Tensor& q,
                                   std::initializer_list<const torch::Tensor*> same) {
  TORCH_CHECK(q.dim() == 4, "q must be (B, H, T, D)");
  TORCH_CHECK(q.scalar_type() == torch::kFloat32 || q.scalar_type() == torch::kBFloat16,
              "dtype must be float32 or bfloat16");
  for (const torch::Tensor* t : same) {
    TORCH_CHECK(t->is_cuda() && t->device() == q.device(), "tensors must share one CUDA device");
    TORCH_CHECK(t->is_contiguous(), "attention tensors must be contiguous");
    TORCH_CHECK(t->scalar_type() == q.scalar_type(), "attention tensors must share a dtype");
    TORCH_CHECK(t->sizes() == q.sizes(), "attention tensors must share a (B, H, T, D) shape");
  }
  const int64_t batch = q.size(0), n_heads = q.size(1), seq = q.size(2), dim = q.size(3);
  TORCH_CHECK(dim >= 1 && dim <= 128, "head dim must be in [1, 128]");
  TORCH_CHECK(batch <= 65535 && n_heads <= 65535 && seq <= (1 << 30), "shape too large");
  return {batch, n_heads, seq, dim};
}

void check_mask(const torch::Tensor& key_valid, const torch::Tensor& q, int64_t batch,
                int64_t seq) {
  TORCH_CHECK(key_valid.is_cuda() && key_valid.device() == q.device() &&
                  key_valid.is_contiguous() && key_valid.scalar_type() == torch::kUInt8 &&
                  key_valid.dim() == 2 && key_valid.size(0) == batch &&
                  key_valid.size(1) == seq,
              "key_valid must be a contiguous (B, T) uint8 tensor on q's device");
}

void check_rows(const torch::Tensor& t, const torch::Tensor& q, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == q.device() && t.is_contiguous() &&
                  t.scalar_type() == torch::kFloat32 && t.dim() == 3 && t.size(0) == q.size(0) &&
                  t.size(1) == q.size(1) && t.size(2) == q.size(2),
              name, " must be a contiguous (B, H, T) float32 tensor on q's device");
}

}  // namespace

// Writes out and, when lse has elements, the (B, H, T) fp32 log-sum-exp
// the backward needs; an empty lse skips it.  `scale`: the softmax scale of
// the true head dim (bf16 takes D zero-padded to a multiple of 8).
// `layout` (bf16): 0 by shape, 1 one warpgroup per block, 2 two warpgroups
// splitting the keys.  `chunk` > 0: chunk-causal, query i sees keys below
// (i / chunk + 1) · chunk only.  Allocates nothing.
void masked_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                          const torch::Tensor& v, const torch::Tensor& key_valid,
                          const torch::Tensor& out, const torch::Tensor& lse, double scale,
                          int64_t layout, int64_t chunk) {
  const auto [batch, n_heads, seq, dim] = check_heads(q, {&q, &k, &v, &out});
  check_mask(key_valid, q, batch, seq);
  const bool with_lse = lse.numel() > 0;
  if (with_lse) check_rows(lse, q, "lse");
  if (q.numel() == 0) return;

  const c10::cuda::CUDAGuard guard(q.device());
  const char* err = masked_attention_fwd_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr<uint8_t>(), out.data_ptr(),
      with_lse ? lse.data_ptr<float>() : nullptr, static_cast<int>(batch),
      static_cast<int>(n_heads), static_cast<int>(seq), static_cast<int>(dim),
      q.scalar_type() == torch::kBFloat16, static_cast<float>(scale * 1.4426950408889634),
      static_cast<int>(layout), static_cast<int>(chunk), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == nullptr, "masked_attention_fwd: ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// dq, dk, dv of the masked attention from the forward's out and lse, at
// softmax scale `scale` (that of the true head dim when the wrapper padded
// it).  delta: (B, H, T) fp32 scratch, filled with rowsum(dout * out);
// dq_acc: for bf16 a (B, H, T, D) fp32 scratch the dq products are summed
// in, for fp32 empty.  `chunk`: the forward's.  Writes dq, dk, dv;
// allocates nothing.
void masked_attention_bwd(const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
                          const torch::Tensor& dout, const torch::Tensor& out,
                          const torch::Tensor& lse, const torch::Tensor& key_valid,
                          const torch::Tensor& delta, const torch::Tensor& dq_acc,
                          const torch::Tensor& dq, const torch::Tensor& dk, const torch::Tensor& dv,
                          double scale, int64_t chunk) {
  const auto [batch, n_heads, seq, dim] =
      check_heads(q, {&q, &k, &v, &dout, &out, &dq, &dk, &dv});
  check_mask(key_valid, q, batch, seq);
  check_rows(lse, q, "lse");
  check_rows(delta, q, "delta");
  const bool bf16 = q.scalar_type() == torch::kBFloat16;
  if (bf16)
    TORCH_CHECK(dq_acc.is_cuda() && dq_acc.device() == q.device() && dq_acc.is_contiguous() &&
                    dq_acc.scalar_type() == torch::kFloat32 && dq_acc.sizes() == q.sizes(),
                "dq_acc must be a contiguous (B, H, T, D) float32 tensor on q's device");
  if (q.numel() == 0) return;

  const c10::cuda::CUDAGuard guard(q.device());
  const char* err = masked_attention_bwd_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), out.data_ptr(),
      lse.data_ptr<float>(), key_valid.data_ptr<uint8_t>(), delta.data_ptr<float>(),
      bf16 ? dq_acc.data_ptr<float>() : nullptr, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
      static_cast<int>(batch), static_cast<int>(n_heads), static_cast<int>(seq),
      static_cast<int>(dim), static_cast<float>(scale), bf16, static_cast<int>(chunk),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == nullptr, "masked_attention_bwd: ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

std::map<std::string, int64_t> attributes_map(const int* out) {
  return {{"registers", out[0]}, {"static_smem_bytes", out[1]}, {"dynamic_smem_bytes", out[2]},
          {"local_bytes", out[3]}, {"threads", out[4]}};
}

// cudaFuncGetAttributes of the bf16 backward kernel that serves head dim
// `dim`, on the current device.
std::map<std::string, int64_t> masked_attention_bwd_attributes_binding(int64_t dim) {
  TORCH_CHECK(dim >= 1 && dim <= 128, "head dim must be in [1, 128]");
  int out[5];
  const cudaError_t err = masked_attention_bwd_attributes(static_cast<int>(dim), out);
  TORCH_CHECK(err == cudaSuccess, "cudaFuncGetAttributes: ", cudaGetErrorString(err));
  return attributes_map(out);
}

// the same for the bf16 forward kernel of `layout` (1 or 2)
std::map<std::string, int64_t> masked_attention_fwd_attributes_binding(int64_t layout,
                                                                       int64_t dim) {
  TORCH_CHECK(layout == 1 || layout == 2, "layout must be 1 or 2");
  TORCH_CHECK(dim >= 1 && dim <= 128, "head dim must be in [1, 128]");
  int out[5];
  const cudaError_t err =
      masked_attention_fwd_attributes(static_cast<int>(layout), static_cast<int>(dim), out);
  TORCH_CHECK(err == cudaSuccess, "cudaFuncGetAttributes: ", cudaGetErrorString(err));
  return attributes_map(out);
}

int64_t masked_attention_fwd_layout_binding(int64_t batch, int64_t n_heads, int64_t seq) {
  return masked_attention_fwd_layout(static_cast<int>(batch), static_cast<int>(n_heads),
                                     static_cast<int>(seq));
}

// the same for the MAS kernel that serves (tx, ty); "warp_dp" is 1 for the
// one-warp DP kernel, 0 for the block-wide kernel of Tx > 1024
std::map<std::string, int64_t> mas_attributes_binding(int64_t tx, int64_t ty) {
  TORCH_CHECK(tx >= 1 && ty >= 1 && tx <= (1 << 30) && ty <= (1 << 30), "bad (tx, ty)");
  int out[6];
  const cudaError_t err = mas_attributes(static_cast<int>(tx), static_cast<int>(ty), out);
  TORCH_CHECK(err == cudaSuccess, "cudaFuncGetAttributes: ", cudaGetErrorString(err));
  auto attrs = attributes_map(out);
  attrs["warp_dp"] = out[5];
  return attrs;
}

int64_t mas_scratch_words_binding(int64_t batch, int64_t tx, int64_t ty) {
  return mas_scratch_words(static_cast<int>(batch), static_cast<int>(tx), static_cast<int>(ty));
}

// value: contiguous (B, Tx, Ty) float32; x_lengths, y_lengths: (B,) int32;
// idx: (B, Ty) int32, written; scratch: int32 of mas_scratch_words(B, Tx,
// Ty) elements (empty when the decisions fit in shared memory).
void mas_indices(const torch::Tensor& value, const torch::Tensor& x_lengths,
                 const torch::Tensor& y_lengths, const torch::Tensor& idx,
                 const torch::Tensor& scratch) {
  TORCH_CHECK(value.is_cuda() && value.is_contiguous() && value.scalar_type() == torch::kFloat32 &&
                  value.dim() == 3,
              "value must be a contiguous (B, Tx, Ty) float32 CUDA tensor");
  const int64_t batch = value.size(0), tx = value.size(1), ty = value.size(2);
  for (const torch::Tensor* t : {&x_lengths, &y_lengths}) {
    TORCH_CHECK(t->is_cuda() && t->device() == value.device() && t->is_contiguous() &&
                    t->scalar_type() == torch::kInt32 && t->dim() == 1 && t->size(0) == batch,
                "lengths must be contiguous (B,) int32 tensors on value's device");
  }
  TORCH_CHECK(idx.is_cuda() && idx.device() == value.device() && idx.is_contiguous() &&
                  idx.scalar_type() == torch::kInt32 && idx.dim() == 2 && idx.size(0) == batch &&
                  idx.size(1) == ty,
              "idx must be a contiguous (B, Ty) int32 tensor on value's device");
  TORCH_CHECK(batch <= (1 << 30) && tx <= (1 << 30) && ty <= (1 << 30), "shape too large");
  const int64_t words = mas_scratch_words(static_cast<int>(batch), static_cast<int>(tx),
                                          static_cast<int>(ty));
  TORCH_CHECK(scratch.is_cuda() && scratch.device() == value.device() &&
                  scratch.scalar_type() == torch::kInt32 && scratch.numel() >= words,
              "scratch must be an int32 CUDA tensor of at least ", words, " elements");
  if (batch == 0 || ty == 0) return;
  TORCH_CHECK(tx >= 1, "value must have at least one token row");

  const c10::cuda::CUDAGuard guard(value.device());
  const cudaError_t err = mas_launch(
      value.data_ptr<float>(), x_lengths.data_ptr<int>(), y_lengths.data_ptr<int>(),
      idx.data_ptr<int>(), words > 0 ? reinterpret_cast<uint32_t*>(scratch.data_ptr<int>()) : nullptr,
      static_cast<int>(batch), static_cast<int>(tx), static_cast<int>(ty),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "mas launch refused: ", cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

constexpr int64_t kAdamwScalars = 8;  // adamw.cu's kScalars

// leaves: contiguous (L, 4) int64 CUDA tensor, chunks: (C, 4) int64 on the
// same device (adamw.cu's tables); out: float32 of 8 + C elements there.
int64_t check_adamw_tables(const torch::Tensor& leaves, const torch::Tensor& chunks,
                           const torch::Tensor& out) {
  for (const torch::Tensor* t : {&leaves, &chunks}) {
    TORCH_CHECK(t->is_cuda() && t->is_contiguous() && t->scalar_type() == torch::kInt64 &&
                    t->dim() == 2 && t->size(1) == 4,
                "AdamW tables must be contiguous (N, 4) int64 CUDA tensors");
  }
  TORCH_CHECK(chunks.device() == leaves.device(), "AdamW tables must share one CUDA device");
  const int64_t n_chunks = chunks.size(0);
  TORCH_CHECK(n_chunks < (int64_t{1} << 31), "too many AdamW chunks");
  TORCH_CHECK(out.is_cuda() && out.device() == leaves.device() && out.is_contiguous() &&
                  out.scalar_type() == torch::kFloat32 && out.numel() == kAdamwScalars + n_chunks,
              "out must be a contiguous float32 tensor of 8 + C elements on the tables' device");
  return n_chunks;
}

void check_adamw_scalar(const torch::Tensor& t, const torch::Tensor& like, torch::ScalarType dtype,
                        const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device() && t.numel() == 1 &&
                  t.scalar_type() == dtype,
              name, " must be a one-element ", c10::toString(dtype), " tensor on the tables' device");
}

// The global norm of the table's gradients (or `norm`, when it has an
// element), the clip flag, the finite check and the bias corrections into
// out[0..4]; count, notfinite_count, last_finite and total_notfinite (the
// OptState's device scalars) in place.  One launch, two without `norm`.
void adamw_norm(const torch::Tensor& leaves, const torch::Tensor& chunks, const torch::Tensor& out,
                const torch::Tensor& norm, const torch::Tensor& count,
                const torch::Tensor& notfinite_count, const torch::Tensor& last_finite,
                const torch::Tensor& total_notfinite, double grad_clip, double b1, double b2,
                bool skip_nonfinite, int64_t max_errors) {
  const int64_t n_chunks = check_adamw_tables(leaves, chunks, out);
  const bool given = norm.numel() > 0;
  if (given) check_adamw_scalar(norm, leaves, torch::kFloat32, "norm");
  check_adamw_scalar(count, leaves, torch::kInt32, "count");
  check_adamw_scalar(notfinite_count, leaves, torch::kInt32, "notfinite_count");
  check_adamw_scalar(last_finite, leaves, torch::kBool, "last_finite");
  check_adamw_scalar(total_notfinite, leaves, torch::kInt32, "total_notfinite");

  const c10::cuda::CUDAGuard guard(leaves.device());
  const cudaError_t err = adamw_norm_launch(
      reinterpret_cast<const long long*>(leaves.data_ptr<int64_t>()),
      reinterpret_cast<const long long*>(chunks.data_ptr<int64_t>()), static_cast<int>(n_chunks),
      out.data_ptr<float>(), given ? norm.data_ptr<float>() : nullptr, count.data_ptr<int>(),
      notfinite_count.data_ptr<int>(), reinterpret_cast<unsigned char*>(last_finite.data_ptr<bool>()),
      total_notfinite.data_ptr<int>(), static_cast<float>(grad_clip), static_cast<float>(b1),
      static_cast<float>(b2), skip_nonfinite ? 1 : 0, static_cast<int>(max_errors),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "adamw_norm launch refused: ", cudaGetErrorString(err));
}

// The AdamW update of every chunk, p, mu and nu in place, from out[0..4] as
// adamw_norm wrote them.  The scalars are cast to fp32 here as PyTorch
// casts a Python number in an fp32 tensor's arithmetic.
void adamw_update(const torch::Tensor& leaves, const torch::Tensor& chunks, const torch::Tensor& out,
                  double lr, double b1, double b2, double eps, double weight_decay,
                  double grad_clip) {
  const int64_t n_chunks = check_adamw_tables(leaves, chunks, out);
  const c10::cuda::CUDAGuard guard(leaves.device());
  const cudaError_t err = adamw_update_launch(
      reinterpret_cast<const long long*>(leaves.data_ptr<int64_t>()),
      reinterpret_cast<const long long*>(chunks.data_ptr<int64_t>()), static_cast<int>(n_chunks),
      out.data_ptr<float>(), static_cast<float>(1.0 - b1), static_cast<float>(b1),
      static_cast<float>(1.0 - b2), static_cast<float>(b2), static_cast<float>(eps),
      static_cast<float>(weight_decay), static_cast<float>(-lr), static_cast<float>(grad_clip),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "adamw_update launch refused: ", cudaGetErrorString(err));
}

// ---------------------------------------------------------------------------
// the DiT block's glue (dit_fused.cu): every row-major tensor contiguous and
// 16-byte aligned, on one CUDA device; the narrow operands bfloat16 or
// float32, the carry, the statistics and the uniforms float32
// ---------------------------------------------------------------------------

namespace {

constexpr int64_t kDitMaxWidth = 8192;  // 1,024 threads of 8 columns

void check_dit(const torch::Tensor& t, const torch::Tensor& like, torch::ScalarType dtype,
               int64_t numel, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), name, " must lie on ", like.device());
  TORCH_CHECK(t.is_contiguous() && t.scalar_type() == dtype && t.numel() == numel, name,
              " must be a contiguous ", c10::toString(dtype), " tensor of ", numel, " elements");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, name, " must be 16-byte aligned");
}

// (B, N, C) of a contiguous float32 CUDA carry; C a multiple of 8.
std::array<int64_t, 3> dit_rows(const torch::Tensor& h, const char* name) {
  TORCH_CHECK(h.dim() == 3, name, " must be (B, N, C)");
  const int64_t batch = h.size(0), n = h.size(1), width = h.size(2);
  TORCH_CHECK(width % 8 == 0 && width <= kDitMaxWidth, name, "'s width must be a multiple of 8 up to ",
              kDitMaxWidth);
  TORCH_CHECK(batch <= 65535 && n < (int64_t{1} << 31) && batch * n * width < (int64_t{1} << 40),
              name, " too large");
  check_dit(h, h, h.scalar_type(), batch * n * width, name);
  return {batch, n, width};
}

// A (B, 1, C) float32 view of the adaLN vectors (scale, shift, gate) with
// unit column stride; returns its batch stride.
int64_t dit_vector(const torch::Tensor& t, const torch::Tensor& like, int64_t batch, int64_t width,
                   const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device() && t.scalar_type() == torch::kFloat32 &&
                  t.dim() == 3 && t.size(0) == batch && t.size(1) == 1 && t.size(2) == width &&
                  t.stride(2) == 1 && t.stride(0) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0,
              name, " must be a (B, 1, C) float32 view on ", like.device(),
              " with unit column stride, 16-byte aligned rows");
  return t.stride(0);
}

bool dit_narrow(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.scalar_type() == torch::kBFloat16 || t.scalar_type() == torch::kFloat32, name,
              " must be bfloat16 or float32");
  return t.scalar_type() == torch::kBFloat16;
}

const uint8_t* dit_row_keep(const torch::Tensor& keep, const torch::Tensor& like, int64_t batch,
                            int64_t n) {
  if (keep.numel() == 0) return nullptr;
  TORCH_CHECK(keep.is_cuda() && keep.device() == like.device() && keep.is_contiguous() &&
                  keep.scalar_type() == torch::kBool && keep.dim() == 2 && keep.size(0) == batch &&
                  keep.size(1) == n,
              "keep must be a contiguous (B, N) bool tensor on ", like.device());
  return reinterpret_cast<const uint8_t*>(keep.data_ptr<bool>());
}

void dit_check_launch(cudaError_t err, const char* what) {
  TORCH_CHECK(err == cudaSuccess, what, " launch refused: ", cudaGetErrorString(err));
}

}  // namespace

// y = LN₀(h)·(1 + scale) + shift in y's dtype, and each row's mean and
// rstd.  h: (B, N, C) float32; scale, shift: (B, 1, C) float32 views
// sharing a batch stride; y: (B, N, C); mean, rstd: (B, N) float32.
void dit_modulate_fwd(const torch::Tensor& h, const torch::Tensor& scale,
                      const torch::Tensor& shift, const torch::Tensor& y,
                      const torch::Tensor& mean, const torch::Tensor& rstd, double eps) {
  TORCH_CHECK(h.scalar_type() == torch::kFloat32, "h must be float32");
  const auto [batch, n, width] = dit_rows(h, "h");
  const int64_t ss = dit_vector(scale, h, batch, width, "scale");
  TORCH_CHECK(dit_vector(shift, h, batch, width, "shift") == ss, "scale and shift must share a stride");
  const bool bf16 = dit_narrow(y, "y");
  check_dit(y, h, y.scalar_type(), h.numel(), "y");
  check_dit(mean, h, torch::kFloat32, batch * n, "mean");
  check_dit(rstd, h, torch::kFloat32, batch * n, "rstd");
  const c10::cuda::CUDAGuard guard(h.device());
  dit_check_launch(dit_modulate_fwd_launch(h.data_ptr<float>(), scale.data_ptr<float>(),
                                           shift.data_ptr<float>(), ss, y.data_ptr(), bf16,
                                           mean.data_ptr<float>(), rstd.data_ptr<float>(),
                                           batch * n, static_cast<int>(n), static_cast<int>(width),
                                           static_cast<float>(eps),
                                           c10::cuda::getCurrentCUDAStream().stream()),
                   "dit_modulate_fwd");
}

// dh (B, N, C) float32, and d(scale), d(shift) into dscale_shift (2, B, C)
// float32 through partials (2·B·tiles·C float32, tiles = ceil(N /
// rows_per_tile)).  dy: (B, N, C) in the forward's y dtype.
void dit_modulate_bwd(const torch::Tensor& dy, const torch::Tensor& h, const torch::Tensor& scale,
                      const torch::Tensor& mean, const torch::Tensor& rstd, const torch::Tensor& dh,
                      const torch::Tensor& partials, const torch::Tensor& dscale_shift,
                      int64_t rows_per_tile) {
  TORCH_CHECK(h.scalar_type() == torch::kFloat32, "h must be float32");
  const auto [batch, n, width] = dit_rows(h, "h");
  TORCH_CHECK(rows_per_tile >= 1, "rows_per_tile must be at least 1");
  const int64_t tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int64_t ss = dit_vector(scale, h, batch, width, "scale");
  const bool bf16 = dit_narrow(dy, "dy");
  check_dit(dy, h, dy.scalar_type(), h.numel(), "dy");
  check_dit(mean, h, torch::kFloat32, batch * n, "mean");
  check_dit(rstd, h, torch::kFloat32, batch * n, "rstd");
  check_dit(dh, h, torch::kFloat32, h.numel(), "dh");
  check_dit(partials, h, torch::kFloat32, 2 * batch * tiles * width, "partials");
  check_dit(dscale_shift, h, torch::kFloat32, 2 * batch * width, "dscale_shift");
  const c10::cuda::CUDAGuard guard(h.device());
  dit_check_launch(dit_modulate_bwd_launch(dy.data_ptr(), bf16, h.data_ptr<float>(),
                                           scale.data_ptr<float>(), ss, mean.data_ptr<float>(),
                                           rstd.data_ptr<float>(), dh.data_ptr<float>(),
                                           partials.data_ptr<float>(), dscale_shift.data_ptr<float>(),
                                           static_cast<int>(batch), static_cast<int>(n),
                                           static_cast<int>(width), static_cast<int>(rows_per_tile),
                                           c10::cuda::getCurrentCUDAStream().stream()),
                   "dit_modulate_bwd");
}

// Forward: q, k, v (B, N, H·D) → oq, ok, ov (B, H, N, D), q and k rotated;
// `backward`: (B, H, N, D) gradients → (B, N, H·D), q's and k's rotated
// back.  One dtype; rope: (N, D/2, 2) float32 (cos, sin); D % 8 == 0.
void dit_rope_heads(const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
                    const torch::Tensor& rope, const torch::Tensor& oq, const torch::Tensor& ok,
                    const torch::Tensor& ov, int64_t heads, bool backward) {
  const torch::Tensor& flat = backward ? oq : q;
  const torch::Tensor& split = backward ? q : oq;
  const auto [batch, n, inner] = dit_rows(flat, backward ? "dq" : "q");
  TORCH_CHECK(heads >= 1 && inner % heads == 0 && (inner / heads) % 8 == 0,
              "the head dim must be a multiple of 8");
  const int64_t dim_head = inner / heads;
  TORCH_CHECK(split.dim() == 4 && split.size(0) == batch && split.size(1) == heads &&
                  split.size(2) == n && split.size(3) == dim_head,
              "the head tensors must be (B, H, N, D)");
  const bool bf16 = dit_narrow(q, "q");
  for (const torch::Tensor* t : {&q, &k, &v, &oq, &ok, &ov})
    check_dit(*t, q, q.scalar_type(), flat.numel(), "q, k, v and their outputs");
  check_dit(rope, q, torch::kFloat32, n * dim_head, "rope");
  TORCH_CHECK(rope.dim() == 3 && rope.size(0) == n && rope.size(2) == 2, "rope must be (N, D/2, 2)");
  const c10::cuda::CUDAGuard guard(q.device());
  dit_check_launch(dit_rope_heads_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         rope.data_ptr<float>(), oq.data_ptr(), ok.data_ptr(),
                                         ov.data_ptr(), bf16, backward, static_cast<int>(batch),
                                         static_cast<int>(n), static_cast<int>(heads),
                                         static_cast<int>(dim_head),
                                         c10::cuda::getCurrentCUDAStream().stream()),
                   "dit_rope_heads");
}

// out = h + g·y′ (B, N, C) float32.  u: (B, N, C) float32 uniforms or empty
// (no dropout); keep: (B, N) bool or empty (every row); bits: (B, N, C/8)
// uint8, written where u is given.  p: the dropout probability.
void dit_gated_residual_fwd(const torch::Tensor& h, const torch::Tensor& g, const torch::Tensor& y,
                            const torch::Tensor& u, const torch::Tensor& keep,
                            const torch::Tensor& out, const torch::Tensor& bits, double p) {
  TORCH_CHECK(h.scalar_type() == torch::kFloat32, "h must be float32");
  const auto [batch, n, width] = dit_rows(h, "h");
  const int64_t gs = dit_vector(g, h, batch, width, "g");
  const bool bf16 = dit_narrow(y, "y");
  check_dit(y, h, y.scalar_type(), h.numel(), "y");
  check_dit(out, h, torch::kFloat32, h.numel(), "out");
  const bool dropout = u.numel() > 0;
  if (dropout) {
    check_dit(u, h, torch::kFloat32, h.numel(), "u");
    check_dit(bits, h, torch::kUInt8, h.numel() / 8, "bits");
  }
  const uint8_t* row_keep = dit_row_keep(keep, h, batch, n);
  const c10::cuda::CUDAGuard guard(h.device());
  dit_check_launch(dit_gated_residual_fwd_launch(
                       h.data_ptr<float>(), g.data_ptr<float>(), gs, y.data_ptr(), bf16,
                       dropout ? u.data_ptr<float>() : nullptr, static_cast<float>(1.0 - p),
                       row_keep, out.data_ptr<float>(), dropout ? bits.data_ptr<uint8_t>() : nullptr,
                       static_cast<int>(batch), static_cast<int>(n), static_cast<int>(width),
                       c10::cuda::getCurrentCUDAStream().stream()),
                   "dit_gated_residual_fwd");
}

// dy (B, N, C) in y's dtype and d(g) into dg (B, C) float32 through
// partials (B·tiles·C float32); bits empty: no dropout.
void dit_gated_residual_bwd(const torch::Tensor& dout, const torch::Tensor& g,
                            const torch::Tensor& y, const torch::Tensor& bits,
                            const torch::Tensor& keep, const torch::Tensor& dy,
                            const torch::Tensor& partials, const torch::Tensor& dg, double p,
                            int64_t rows_per_tile) {
  TORCH_CHECK(dout.scalar_type() == torch::kFloat32, "dout must be float32");
  const auto [batch, n, width] = dit_rows(dout, "dout");
  TORCH_CHECK(rows_per_tile >= 1, "rows_per_tile must be at least 1");
  const int64_t tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int64_t gs = dit_vector(g, dout, batch, width, "g");
  const bool bf16 = dit_narrow(y, "y");
  check_dit(y, dout, y.scalar_type(), dout.numel(), "y");
  check_dit(dy, dout, y.scalar_type(), dout.numel(), "dy");
  const bool dropout = bits.numel() > 0;
  if (dropout) check_dit(bits, dout, torch::kUInt8, dout.numel() / 8, "bits");
  check_dit(partials, dout, torch::kFloat32, batch * tiles * width, "partials");
  check_dit(dg, dout, torch::kFloat32, batch * width, "dg");
  const uint8_t* row_keep = dit_row_keep(keep, dout, batch, n);
  const c10::cuda::CUDAGuard guard(dout.device());
  dit_check_launch(dit_gated_residual_bwd_launch(
                       dout.data_ptr<float>(), g.data_ptr<float>(), gs, y.data_ptr(), bf16,
                       dropout ? bits.data_ptr<uint8_t>() : nullptr, static_cast<float>(1.0 - p),
                       row_keep, dy.data_ptr(), partials.data_ptr<float>(), dg.data_ptr<float>(),
                       static_cast<int>(batch), static_cast<int>(n), static_cast<int>(width),
                       static_cast<int>(rows_per_tile), c10::cuda::getCurrentCUDAStream().stream()),
                   "dit_gated_residual_bwd");
}

// y = GELU_tanh(x), dropped where u is given; x, y: (..., W) one dtype, W %
// 8 == 0; u: float32 of x's size or empty; bits: uint8 of a byte per 8
// elements, written where u is given.
void dit_gelu_dropout_fwd(const torch::Tensor& x, const torch::Tensor& u, const torch::Tensor& y,
                          const torch::Tensor& bits, double p) {
  const bool bf16 = dit_narrow(x, "x");
  TORCH_CHECK(x.dim() >= 1 && x.size(-1) % 8 == 0, "x's last dim must be a multiple of 8");
  check_dit(x, x, x.scalar_type(), x.numel(), "x");
  check_dit(y, x, x.scalar_type(), x.numel(), "y");
  const bool dropout = u.numel() > 0;
  if (dropout) {
    check_dit(u, x, torch::kFloat32, x.numel(), "u");
    check_dit(bits, x, torch::kUInt8, x.numel() / 8, "bits");
  }
  const c10::cuda::CUDAGuard guard(x.device());
  dit_check_launch(dit_gelu_dropout_fwd_launch(x.data_ptr(), bf16,
                                               dropout ? u.data_ptr<float>() : nullptr,
                                               static_cast<float>(1.0 - p), y.data_ptr(),
                                               dropout ? bits.data_ptr<uint8_t>() : nullptr,
                                               x.numel(), c10::cuda::getCurrentCUDAStream().stream()),
                   "dit_gelu_dropout_fwd");
}

// dx = dy/(1 − p)·[kept]·GELU′(x) (dy·GELU′(x) with empty bits).
void dit_gelu_dropout_bwd(const torch::Tensor& dy, const torch::Tensor& x, const torch::Tensor& bits,
                          const torch::Tensor& dx, double p) {
  const bool bf16 = dit_narrow(x, "x");
  TORCH_CHECK(x.dim() >= 1 && x.size(-1) % 8 == 0, "x's last dim must be a multiple of 8");
  for (const torch::Tensor* t : {&x, &dy, &dx}) check_dit(*t, x, x.scalar_type(), x.numel(), "x, dy, dx");
  const bool dropout = bits.numel() > 0;
  if (dropout) check_dit(bits, x, torch::kUInt8, x.numel() / 8, "bits");
  const c10::cuda::CUDAGuard guard(x.device());
  dit_check_launch(dit_gelu_dropout_bwd_launch(dy.data_ptr(), x.data_ptr(), bf16,
                                               dropout ? bits.data_ptr<uint8_t>() : nullptr,
                                               static_cast<float>(1.0 - p), dx.data_ptr(),
                                               x.numel(), c10::cuda::getCurrentCUDAStream().stream()),
                   "dit_gelu_dropout_bwd");
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("masked_attention_fwd", &masked_attention_fwd,
        "masked self-attention forward (sm_90a), writes out (and lse) in place", py::arg("q"),
        py::arg("k"), py::arg("v"), py::arg("key_valid"), py::arg("out"), py::arg("lse"),
        py::arg("scale"), py::arg("layout") = 0, py::arg("chunk") = 0);
  m.def("masked_attention_fwd_layout", &masked_attention_fwd_layout_binding,
        "the bf16 forward layout (1 or 2) chosen by shape");
  m.def("masked_attention_fwd_attributes", &masked_attention_fwd_attributes_binding,
        "registers, shared memory and local bytes of a bf16 forward kernel");
  m.def("masked_attention_bwd", &masked_attention_bwd,
        "masked self-attention backward, dq, dk and dv (sm_90a), in place", py::arg("q"),
        py::arg("k"), py::arg("v"), py::arg("dout"), py::arg("out"), py::arg("lse"),
        py::arg("key_valid"), py::arg("delta"), py::arg("dq_acc"), py::arg("dq"), py::arg("dk"),
        py::arg("dv"), py::arg("scale"), py::arg("chunk") = 0);
  m.def("masked_attention_bwd_attributes", &masked_attention_bwd_attributes_binding,
        "registers, shared memory and local bytes of a bf16 backward kernel");
  m.def("mas_scratch_words", &mas_scratch_words_binding,
        "int32 words of global scratch mas_indices needs");
  m.def("mas_attributes", &mas_attributes_binding,
        "registers, shared memory and local bytes of the MAS kernel for (tx, ty)");
  m.def("mas_indices", &mas_indices,
        "monotonic alignment search, forward DP + backtrack (sm_90a), writes idx in place");
  m.def("adamw_norm", &adamw_norm,
        "multi-tensor AdamW, first part: global norm, clip, finite check, bias corrections");
  m.def("adamw_update", &adamw_update,
        "multi-tensor AdamW, second part: p, mu, nu of every chunk in place");
  m.def("dit_modulate_fwd", &dit_modulate_fwd, "DiT: LN0(h)(1 + scale) + shift, mean and rstd");
  m.def("dit_modulate_bwd", &dit_modulate_bwd, "DiT: dh, d(scale) and d(shift) of the modulation");
  m.def("dit_rope_heads", &dit_rope_heads, "DiT: RoPE on q and k with the head layout, v laid out");
  m.def("dit_gated_residual_fwd", &dit_gated_residual_fwd, "DiT: h + g * dropped branch");
  m.def("dit_gated_residual_bwd", &dit_gated_residual_bwd, "DiT: the branch's gradient and d(g)");
  m.def("dit_gelu_dropout_fwd", &dit_gelu_dropout_fwd, "DiT: GELU-tanh with dropout");
  m.def("dit_gelu_dropout_bwd", &dit_gelu_dropout_bwd, "DiT: the backward of GELU-tanh with dropout");
}

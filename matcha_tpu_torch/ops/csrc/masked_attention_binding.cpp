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
                                        float qk_scale_log2, int layout, cudaStream_t stream);
int masked_attention_fwd_layout(int batch, int n_heads, int seq);
cudaError_t masked_attention_fwd_attributes(int layout, int dim, int* out);
const char* masked_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* delta, const uint8_t* key_valid,
                                            void* dk, void* dv, int batch, int n_heads, int seq,
                                            int dim, float scale, bool bf16,
                                            cudaStream_t stream);
const char* masked_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse, const float* delta,
                                           const uint8_t* key_valid, void* dq, int batch,
                                           int n_heads, int seq, int dim, float scale, bool bf16,
                                           cudaStream_t stream);
cudaError_t masked_attention_bwd_attributes(int kernel, int dim, int* out);
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
// splitting the keys.  Allocates nothing.
void masked_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                          const torch::Tensor& v, const torch::Tensor& key_valid,
                          const torch::Tensor& out, const torch::Tensor& lse, double scale,
                          int64_t layout) {
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
      static_cast<int>(layout), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == nullptr, "masked_attention_fwd: ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// dk, dv of the masked attention from the forward's lse and
// delta = rowsum(dout * out) in fp32, at softmax scale `scale` (that of the
// true head dim when the wrapper padded it).  Writes dk, dv; allocates
// nothing.
void masked_attention_bwd_dkv(const torch::Tensor& q, const torch::Tensor& k,
                              const torch::Tensor& v, const torch::Tensor& dout,
                              const torch::Tensor& lse, const torch::Tensor& delta,
                              const torch::Tensor& key_valid, const torch::Tensor& dk,
                              const torch::Tensor& dv, double scale) {
  const auto [batch, n_heads, seq, dim] = check_heads(q, {&q, &k, &v, &dout, &dk, &dv});
  check_mask(key_valid, q, batch, seq);
  check_rows(lse, q, "lse");
  check_rows(delta, q, "delta");
  if (q.numel() == 0) return;

  const c10::cuda::CUDAGuard guard(q.device());
  const char* err = masked_attention_bwd_dkv_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr<float>(),
      delta.data_ptr<float>(), key_valid.data_ptr<uint8_t>(), dk.data_ptr(), dv.data_ptr(),
      static_cast<int>(batch), static_cast<int>(n_heads), static_cast<int>(seq),
      static_cast<int>(dim), static_cast<float>(scale), q.scalar_type() == torch::kBFloat16,
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == nullptr, "masked_attention_bwd_dkv: ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// dq of the masked attention; same inputs as masked_attention_bwd_dkv.
void masked_attention_bwd_dq(const torch::Tensor& q, const torch::Tensor& k,
                             const torch::Tensor& v, const torch::Tensor& dout,
                             const torch::Tensor& lse, const torch::Tensor& delta,
                             const torch::Tensor& key_valid, const torch::Tensor& dq,
                             double scale) {
  const auto [batch, n_heads, seq, dim] = check_heads(q, {&q, &k, &v, &dout, &dq});
  check_mask(key_valid, q, batch, seq);
  check_rows(lse, q, "lse");
  check_rows(delta, q, "delta");
  if (q.numel() == 0) return;

  const c10::cuda::CUDAGuard guard(q.device());
  const char* err = masked_attention_bwd_dq_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr<float>(),
      delta.data_ptr<float>(), key_valid.data_ptr<uint8_t>(), dq.data_ptr(),
      static_cast<int>(batch), static_cast<int>(n_heads), static_cast<int>(seq),
      static_cast<int>(dim), static_cast<float>(scale), q.scalar_type() == torch::kBFloat16,
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == nullptr, "masked_attention_bwd_dq: ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

std::map<std::string, int64_t> attributes_map(const int* out) {
  return {{"registers", out[0]}, {"static_smem_bytes", out[1]}, {"dynamic_smem_bytes", out[2]},
          {"local_bytes", out[3]}, {"threads", out[4]}};
}

// cudaFuncGetAttributes of the bf16 backward kernel ("dq" or "dkv") that
// serves head dim `dim`, on the current device.
std::map<std::string, int64_t> masked_attention_bwd_attributes_binding(const std::string& kernel,
                                                                       int64_t dim) {
  TORCH_CHECK(kernel == "dq" || kernel == "dkv", "kernel must be \"dq\" or \"dkv\"");
  TORCH_CHECK(dim >= 1 && dim <= 128, "head dim must be in [1, 128]");
  int out[5];
  const cudaError_t err =
      masked_attention_bwd_attributes(kernel == "dq" ? 0 : 1, static_cast<int>(dim), out);
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

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("masked_attention_fwd", &masked_attention_fwd,
        "masked self-attention forward (sm_90a), writes out (and lse) in place", py::arg("q"),
        py::arg("k"), py::arg("v"), py::arg("key_valid"), py::arg("out"), py::arg("lse"),
        py::arg("scale"), py::arg("layout") = 0);
  m.def("masked_attention_fwd_layout", &masked_attention_fwd_layout_binding,
        "the bf16 forward layout (1 or 2) chosen by shape");
  m.def("masked_attention_fwd_attributes", &masked_attention_fwd_attributes_binding,
        "registers, shared memory and local bytes of a bf16 forward kernel");
  m.def("masked_attention_bwd_dkv", &masked_attention_bwd_dkv,
        "masked self-attention backward, dk and dv (sm_90a), in place");
  m.def("masked_attention_bwd_dq", &masked_attention_bwd_dq,
        "masked self-attention backward, dq (sm_90a), in place");
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
}

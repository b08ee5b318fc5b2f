// PyTorch binding of the hand-written kernels in this directory.  The only
// file that includes torch/extension.h, so the .cu sources compile with the
// CUDA headers alone.

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

#include <cmath>

bool masked_attention_fwd_launch(const void* q, const void* k, const void* v,
                                 const uint8_t* key_valid, void* out, int batch,
                                 int n_heads, int seq, int dim, bool bf16,
                                 float qk_scale_log2, cudaStream_t stream);

// q, k, v, out: contiguous (B, H, T, D), all float32 or all bfloat16, on one
// CUDA device.  key_valid: contiguous (B, T) uint8, nonzero = valid key.
// Writes out; allocates nothing.
void masked_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                          const torch::Tensor& v, const torch::Tensor& key_valid,
                          const torch::Tensor& out) {
  for (const torch::Tensor* t : {&q, &k, &v, &out}) {
    TORCH_CHECK(t->is_cuda() && t->device() == q.device(), "tensors must share one CUDA device");
    TORCH_CHECK(t->is_contiguous(), "q, k, v and out must be contiguous");
    TORCH_CHECK(t->scalar_type() == q.scalar_type(), "q, k, v and out must share a dtype");
    TORCH_CHECK(t->sizes() == q.sizes(), "q, k, v and out must share a (B, H, T, D) shape");
  }
  TORCH_CHECK(q.dim() == 4, "q must be (B, H, T, D)");
  TORCH_CHECK(q.scalar_type() == torch::kFloat32 || q.scalar_type() == torch::kBFloat16,
              "dtype must be float32 or bfloat16");
  const int64_t batch = q.size(0), n_heads = q.size(1), seq = q.size(2), dim = q.size(3);
  TORCH_CHECK(dim >= 1 && dim <= 128, "head dim must be in [1, 128]");
  TORCH_CHECK(key_valid.is_cuda() && key_valid.device() == q.device() &&
                  key_valid.is_contiguous() && key_valid.scalar_type() == torch::kUInt8 &&
                  key_valid.dim() == 2 && key_valid.size(0) == batch &&
                  key_valid.size(1) == seq,
              "key_valid must be a contiguous (B, T) uint8 tensor on q's device");
  TORCH_CHECK(batch <= 65535 && n_heads <= 65535 && seq <= (1 << 30), "shape too large");
  if (q.numel() == 0) return;

  const c10::cuda::CUDAGuard guard(q.device());
  const float qk_scale_log2 =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(dim)) * 1.4426950408889634);
  const bool launched = masked_attention_fwd_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr<uint8_t>(), out.data_ptr(),
      static_cast<int>(batch), static_cast<int>(n_heads), static_cast<int>(seq),
      static_cast<int>(dim), q.scalar_type() == torch::kBFloat16, qk_scale_log2,
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(launched, "no kernel instance for head dim ", dim);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("masked_attention_fwd", &masked_attention_fwd,
        "masked self-attention forward (sm_90a), writes out in place");
}

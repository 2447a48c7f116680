// Python bindings of the port's kernels.  The only source that includes
// PyTorch's headers: the Python wrappers (ops/cuda/*.py) check devices,
// dtypes, shapes and contiguity and allocate the outputs; these functions
// pass pointers and the current stream to the launchers and check the
// launch.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <cstdint>
#include <vector>

#include "kernels.h"

namespace {

void grid_encode_fwd(const torch::Tensor& x, int64_t x_stride_b, const torch::Tensor& table,
                     const torch::Tensor& level_params, const torch::Tensor& out,
                     int64_t n_dims, int64_t n_features, int64_t out_stride_b,
                     int64_t out_stride_f, const std::vector<int64_t>& hash_factors,
                     bool coherent_add, int64_t interp) {
  TORCH_CHECK(hash_factors.size() == 4, "grid_encode_fwd: four hash factors");
  const c10::cuda::CUDAGuard guard(x.device());
  uint32_t factors[4];
  for (int d = 0; d < 4; ++d) factors[d] = static_cast<uint32_t>(hash_factors[d]);
  C10_CUDA_CHECK(tcnn_tpu_torch::grid_encode_fwd_launch(
      x.data_ptr<float>(), x_stride_b, table.data_ptr(), table.scalar_type() == at::kBFloat16,
      level_params.data_ptr<int32_t>(), out.data_ptr(), x.size(0),
      static_cast<int>(n_dims), static_cast<int>(level_params.size(0)),
      static_cast<int>(n_features), out_stride_b, out_stride_f, factors, coherent_add,
      static_cast<int>(interp), c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_mlp_fwd(const torch::Tensor& x, int64_t x_stride_b, int64_t x_stride_d,
                   const std::vector<torch::Tensor>& weights, const torch::Tensor& y,
                   int64_t y_stride_b, int64_t y_stride_d, int64_t act, int64_t out_act,
                   bool soa_in, bool soa_out) {
  const c10::cuda::CUDAGuard guard(x.device());
  std::vector<const void*> ptrs;
  for (const auto& w : weights) ptrs.push_back(w.data_ptr());
  const auto& w_in = weights.front();
  C10_CUDA_CHECK(tcnn_tpu_torch::fused_mlp_fwd_launch(
      x.data_ptr(), x_stride_b, x_stride_d, static_cast<int>(w_in.size(0)), ptrs.data(),
      static_cast<int>(weights.size()), static_cast<int>(w_in.size(1)),
      static_cast<int>(weights.back().size(1)), y.data_ptr(), y_stride_b, y_stride_d,
      y.scalar_type() == at::kBFloat16, soa_out ? y.size(1) : y.size(0),
      x.scalar_type() == at::kBFloat16, static_cast<int>(act), static_cast<int>(out_act),
      soa_in, soa_out, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void grid_encode_bwd(const torch::Tensor& x, int64_t x_stride_b, const torch::Tensor& dcols,
                     const torch::Tensor& level_params, const torch::Tensor& grad,
                     const torch::Tensor& out, int64_t n_dims, int64_t n_features,
                     int64_t dc_stride_b, int64_t dc_stride_f,
                     const std::vector<int64_t>& hash_factors, bool coherent_add,
                     int64_t interp) {
  TORCH_CHECK(hash_factors.size() == 4, "grid_encode_bwd: four hash factors");
  const c10::cuda::CUDAGuard guard(x.device());
  uint32_t factors[4];
  for (int d = 0; d < 4; ++d) factors[d] = static_cast<uint32_t>(hash_factors[d]);
  C10_CUDA_CHECK(tcnn_tpu_torch::grid_encode_bwd_launch(
      x.data_ptr<float>(), x_stride_b, dcols.data_ptr(), dcols.scalar_type() == at::kBFloat16,
      level_params.data_ptr<int32_t>(), grad.data_ptr<float>(), out.data_ptr(),
      out.scalar_type() == at::kBFloat16, grad.numel(), x.size(0),
      static_cast<int>(n_dims), static_cast<int>(level_params.size(0)),
      static_cast<int>(n_features), dc_stride_b, dc_stride_f, factors, coherent_add,
      static_cast<int>(interp), c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_mlp_bwd(const torch::Tensor& x, int64_t x_stride_b, int64_t x_stride_d,
                   const std::vector<torch::Tensor>& weights, const torch::Tensor& g,
                   int64_t g_stride_b, int64_t g_stride_d, const torch::Tensor& dx,
                   int64_t dx_stride_b, int64_t dx_stride_d, const torch::Tensor& partials,
                   const torch::Tensor& dw, int64_t batch, int64_t act, int64_t out_act,
                   bool soa_in) {
  const c10::cuda::CUDAGuard guard(x.device());
  std::vector<const void*> ptrs;
  for (const auto& w : weights) ptrs.push_back(w.data_ptr());
  const auto& w_in = weights.front();
  C10_CUDA_CHECK(tcnn_tpu_torch::fused_mlp_bwd_launch(
      x.data_ptr(), x_stride_b, x_stride_d, static_cast<int>(w_in.size(0)), ptrs.data(),
      static_cast<int>(weights.size()), static_cast<int>(w_in.size(1)),
      static_cast<int>(weights.back().size(1)), g.data_ptr<float>(), g_stride_b,
      g_stride_d, dx.data_ptr(), dx_stride_b, dx_stride_d,
      dx.scalar_type() == at::kBFloat16, partials.data_ptr<float>(),
      static_cast<int>(partials.size(0)), dw.data_ptr<float>(), batch,
      x.scalar_type() == at::kBFloat16, static_cast<int>(act), static_cast<int>(out_act),
      soa_in, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

int64_t fused_mlp_bwd_smem_bytes(int64_t d_in, int64_t d_out, int64_t width,
                                 int64_t n_layers, bool compute_bf16) {
  return tcnn_tpu_torch::fused_mlp_bwd_smem_bytes(
      static_cast<int>(d_in), static_cast<int>(d_out), static_cast<int>(width),
      static_cast<int>(n_layers), compute_bf16);
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("grid_encode_fwd", &grid_encode_fwd, "grid-encode forward (kernel G)");
  m.def("fused_mlp_fwd", &fused_mlp_fwd, "fused-MLP forward (kernel M)");
  m.def("grid_encode_bwd", &grid_encode_bwd, "grid-encode backward (kernel GB)");
  m.def("fused_mlp_bwd", &fused_mlp_bwd, "fused-MLP backward (kernel MB)");
  m.def("fused_mlp_bwd_smem_bytes", &fused_mlp_bwd_smem_bytes,
        "shared memory of one kernel-MB CTA");
}

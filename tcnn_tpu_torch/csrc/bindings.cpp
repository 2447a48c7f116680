// Python bindings of the port's kernels.  The only source that includes
// PyTorch's headers: the Python wrappers (ops/cuda/*.py) check devices,
// dtypes, shapes and contiguity and allocate the outputs; these functions
// pass pointers and the current stream to the launchers and check the
// launch.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <algorithm>
#include <cstdint>
#include <vector>

#include "kernels.h"

namespace {

// An optional tensor: an undefined tensor (None in Python) passes null.
template <typename T>
T* optional_ptr(const c10::optional<torch::Tensor>& t) {
  return t.has_value() && t->defined() ? t->data_ptr<T>() : nullptr;
}

void grid_encode_fwd(const torch::Tensor& x, int64_t x_stride_b,
                     const c10::optional<torch::Tensor>& level_frac, const torch::Tensor& table,
                     const torch::Tensor& level_params, const torch::Tensor& out,
                     int64_t n_dims, int64_t n_features, int64_t out_stride_b,
                     int64_t out_stride_f, const std::vector<int64_t>& hash_factors,
                     int64_t hash_kind, int64_t interp, bool sharded,
                     const c10::optional<torch::Tensor>& u) {
  TORCH_CHECK(hash_factors.size() == 7, "grid_encode_fwd: seven hash factors");
  const c10::cuda::CUDAGuard guard(x.device());
  uint32_t factors[7];
  for (int d = 0; d < 7; ++d) factors[d] = static_cast<uint32_t>(hash_factors[d]);
  C10_CUDA_CHECK(tcnn_tpu_torch::grid_encode_fwd_launch(
      x.data_ptr<float>(), x_stride_b, optional_ptr<float>(level_frac), table.data_ptr(),
      table.scalar_type() == at::kBFloat16, level_params.data_ptr<int32_t>(), out.data_ptr(),
      x.size(0),
      static_cast<int>(n_dims), static_cast<int>(level_params.size(0)),
      static_cast<int>(n_features), out_stride_b, out_stride_f, factors, static_cast<int>(hash_kind),
      static_cast<int>(interp), sharded, optional_ptr<float>(u),
      c10::cuda::getCurrentCUDAStream()));
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

void grid_encode_bwd(const torch::Tensor& x, int64_t x_stride_b,
                     const c10::optional<torch::Tensor>& level_frac, const torch::Tensor& dcols,
                     const torch::Tensor& level_params, const torch::Tensor& items,
                     const std::vector<int64_t>& groups, const torch::Tensor& grad,
                     const torch::Tensor& out, int64_t n_dims, int64_t n_features,
                     int64_t dc_stride_b, int64_t dc_stride_f,
                     const std::vector<int64_t>& hash_factors, int64_t hash_kind,
                     int64_t interp, const c10::optional<torch::Tensor>& u, bool sharded) {
  TORCH_CHECK(hash_factors.size() == 7, "grid_encode_bwd: seven hash factors");
  TORCH_CHECK(groups.size() % 4 == 0, "grid_encode_bwd: four fields per launch group");
  const c10::cuda::CUDAGuard guard(x.device());
  uint32_t factors[7];
  for (int d = 0; d < 7; ++d) factors[d] = static_cast<uint32_t>(hash_factors[d]);
  const std::vector<int32_t> g(groups.begin(), groups.end());
  C10_CUDA_CHECK(tcnn_tpu_torch::grid_encode_bwd_launch(
      x.data_ptr<float>(), x_stride_b, optional_ptr<float>(level_frac), dcols.data_ptr(),
      dcols.scalar_type() == at::kBFloat16, level_params.data_ptr<int32_t>(),
      static_cast<int>(level_params.size(0)), items.data_ptr<int32_t>(), g.data(),
      static_cast<int>(g.size() / 4), grad.data_ptr<float>(), out.data_ptr(),
      out.scalar_type() == at::kBFloat16, grad.numel(), static_cast<int>(n_dims),
      static_cast<int>(n_features), dc_stride_b, dc_stride_f, factors, static_cast<int>(hash_kind),
      static_cast<int>(interp), optional_ptr<float>(u), x.size(0), sharded,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_mlp_bwd(const torch::Tensor& x, int64_t x_stride_b, int64_t x_stride_d,
                   const std::vector<torch::Tensor>& weights, const torch::Tensor& g,
                   int64_t g_stride_b, int64_t g_stride_d, const torch::Tensor& dx,
                   int64_t dx_stride_b, int64_t dx_stride_d, const torch::Tensor& dw,
                   int64_t batch, int64_t act, int64_t out_act, bool soa_in) {
  const c10::cuda::CUDAGuard guard(x.device());
  std::vector<const void*> ptrs;
  for (const auto& w : weights) ptrs.push_back(w.data_ptr());
  const auto& w_in = weights.front();
  torch::Tensor partials;   // the CTAs' partial dW, sized by the launcher
  C10_CUDA_CHECK(tcnn_tpu_torch::fused_mlp_bwd_launch(
      x.data_ptr(), x_stride_b, x_stride_d, static_cast<int>(w_in.size(0)), ptrs.data(),
      static_cast<int>(weights.size()), static_cast<int>(w_in.size(1)),
      static_cast<int>(weights.back().size(1)), g.data_ptr<float>(), g_stride_b,
      g_stride_d, dx.data_ptr(), dx_stride_b, dx_stride_d,
      dx.scalar_type() == at::kBFloat16,
      [&](int64_t n) {
        partials = torch::empty({n}, dw.options());
        return partials.data_ptr<float>();
      },
      dw.data_ptr<float>(), batch, x.scalar_type() == at::kBFloat16, static_cast<int>(act),
      static_cast<int>(out_act), soa_in, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void grid_encode_bwd_input(const torch::Tensor& x, int64_t x_stride_b,
                           const c10::optional<torch::Tensor>& level_frac,
                           const torch::Tensor& table, const torch::Tensor& dcols,
                           const torch::Tensor& level_params, const torch::Tensor& dx,
                           int64_t n_dims, int64_t n_features, int64_t dc_stride_b,
                           int64_t dc_stride_f, const std::vector<int64_t>& hash_factors,
                           int64_t hash_kind, int64_t interp, bool sharded) {
  TORCH_CHECK(hash_factors.size() == 7, "grid_encode_bwd_input: seven hash factors");
  const c10::cuda::CUDAGuard guard(x.device());
  uint32_t factors[7];
  for (int d = 0; d < 7; ++d) factors[d] = static_cast<uint32_t>(hash_factors[d]);
  C10_CUDA_CHECK(tcnn_tpu_torch::grid_encode_bwd_input_launch(
      x.data_ptr<float>(), x_stride_b, optional_ptr<float>(level_frac), table.data_ptr(),
      table.scalar_type() == at::kBFloat16, dcols.data_ptr(),
      dcols.scalar_type() == at::kBFloat16, level_params.data_ptr<int32_t>(),
      dx.data_ptr<float>(), x.size(0), static_cast<int>(n_dims),
      static_cast<int>(level_params.size(0)), static_cast<int>(n_features), dc_stride_b,
      dc_stride_f, factors, static_cast<int>(hash_kind), static_cast<int>(interp), sharded,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void grid_encode_bwd_bwd(const torch::Tensor& x, int64_t x_stride_b,
                         const c10::optional<torch::Tensor>& level_frac, const torch::Tensor& table,
                         const torch::Tensor& dcols, const torch::Tensor& ddx,
                         const torch::Tensor& level_params, const torch::Tensor& items,
                         const std::vector<int64_t>& groups,
                         const c10::optional<torch::Tensor>& d_dcols,
                         const c10::optional<torch::Tensor>& dx_part,
                         const c10::optional<torch::Tensor>& d_x,
                         const c10::optional<torch::Tensor>& grad,
                         const c10::optional<torch::Tensor>& out, int64_t n_dims,
                         int64_t n_features, int64_t dc_stride_b, int64_t dc_stride_f,
                         const std::vector<int64_t>& hash_factors, int64_t hash_kind,
                         int64_t interp, bool sharded) {
  TORCH_CHECK(hash_factors.size() == 7, "grid_encode_bwd_bwd: seven hash factors");
  TORCH_CHECK(groups.size() % 4 == 0, "grid_encode_bwd_bwd: four fields per launch group");
  const c10::cuda::CUDAGuard guard(x.device());
  uint32_t factors[7];
  for (int d = 0; d < 7; ++d) factors[d] = static_cast<uint32_t>(hash_factors[d]);
  const std::vector<int32_t> g(groups.begin(), groups.end());
  const bool has_out = out.has_value() && out->defined();
  C10_CUDA_CHECK(tcnn_tpu_torch::grid_encode_bwd_bwd_launch(
      x.data_ptr<float>(), x_stride_b, optional_ptr<float>(level_frac), table.data_ptr(),
      table.scalar_type() == at::kBFloat16,
      dcols.data_ptr(), dcols.scalar_type() == at::kBFloat16, ddx.data_ptr<float>(),
      level_params.data_ptr<int32_t>(), static_cast<int>(level_params.size(0)),
      items.data_ptr<int32_t>(), g.data(), static_cast<int>(g.size() / 4),
      optional_ptr<float>(d_dcols), optional_ptr<float>(dx_part), optional_ptr<float>(d_x),
      optional_ptr<float>(grad), has_out ? out->data_ptr() : nullptr,
      has_out && out->scalar_type() == at::kBFloat16, has_out ? out->numel() : 0, x.size(0),
      static_cast<int>(n_dims), static_cast<int>(n_features), dc_stride_b, dc_stride_f,
      factors, static_cast<int>(hash_kind), static_cast<int>(interp), sharded,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void grid_encode_third(const torch::Tensor& x, int64_t x_stride_b,
                       const c10::optional<torch::Tensor>& level_frac, const torch::Tensor& table,
                       const torch::Tensor& dcols, const torch::Tensor& ddx,
                       const torch::Tensor& ct_dx, const torch::Tensor& level_params,
                       const torch::Tensor& items, const std::vector<int64_t>& groups,
                       const c10::optional<torch::Tensor>& d_dcols,
                       const c10::optional<torch::Tensor>& dx_part,
                       const c10::optional<torch::Tensor>& d_x,
                       const c10::optional<torch::Tensor>& grad,
                       const c10::optional<torch::Tensor>& out, int64_t n_dims,
                       int64_t n_features, int64_t dc_stride_b, int64_t dc_stride_f,
                       const std::vector<int64_t>& hash_factors, int64_t hash_kind,
                       int64_t interp, bool sharded) {
  TORCH_CHECK(hash_factors.size() == 7, "grid_encode_third: seven hash factors");
  TORCH_CHECK(groups.size() % 4 == 0, "grid_encode_third: four fields per launch group");
  const c10::cuda::CUDAGuard guard(x.device());
  uint32_t factors[7];
  for (int d = 0; d < 7; ++d) factors[d] = static_cast<uint32_t>(hash_factors[d]);
  const std::vector<int32_t> g(groups.begin(), groups.end());
  const bool has_out = out.has_value() && out->defined();
  C10_CUDA_CHECK(tcnn_tpu_torch::grid_encode_third_launch(
      x.data_ptr<float>(), x_stride_b, optional_ptr<float>(level_frac), table.data_ptr(),
      table.scalar_type() == at::kBFloat16, dcols.data_ptr(),
      dcols.scalar_type() == at::kBFloat16, ddx.data_ptr<float>(), ct_dx.data_ptr<float>(),
      level_params.data_ptr<int32_t>(), static_cast<int>(level_params.size(0)),
      items.data_ptr<int32_t>(), g.data(), static_cast<int>(g.size() / 4),
      optional_ptr<float>(d_dcols), optional_ptr<float>(dx_part), optional_ptr<float>(d_x),
      optional_ptr<float>(grad), has_out ? out->data_ptr() : nullptr,
      has_out && out->scalar_type() == at::kBFloat16, has_out ? out->numel() : 0, x.size(0),
      static_cast<int>(n_dims), static_cast<int>(n_features), dc_stride_b, dc_stride_f,
      factors, static_cast<int>(hash_kind), static_cast<int>(interp), sharded,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void row_scatter(const torch::Tensor& idx, const torch::Tensor& g, int64_t g_stride_i,
                 int64_t g_stride_k, int64_t n_features, const torch::Tensor& acc,
                 const torch::Tensor& out, int64_t n_rows) {
  const c10::cuda::CUDAGuard guard(acc.device());
  C10_CUDA_CHECK(tcnn_tpu_torch::row_scatter_launch(
      idx.data_ptr<int32_t>(), g.data_ptr<float>(), g_stride_i, g_stride_k, idx.numel(),
      static_cast<int>(n_features), acc.data_ptr<float>(), out.data_ptr(),
      out.scalar_type() == at::kBFloat16, n_rows, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void sort_keys(const torch::Tensor& x, int64_t x_stride_b,
               const c10::optional<torch::Tensor>& level_frac, const torch::Tensor& dcols,
               int64_t dc_stride_b, int64_t dc_stride_f, const torch::Tensor& level_params,
               int64_t n_dims, int64_t n_features, const std::vector<int64_t>& hash_factors,
               int64_t hash_kind, int64_t interp, bool sharded,
               const c10::optional<torch::Tensor>& u, int64_t sentinel,
               const torch::Tensor& keys, const torch::Tensor& vals) {
  TORCH_CHECK(hash_factors.size() == 7, "sort_keys: seven hash factors");
  const c10::cuda::CUDAGuard guard(x.device());
  uint32_t factors[7];
  for (int d = 0; d < 7; ++d) factors[d] = static_cast<uint32_t>(hash_factors[d]);
  C10_CUDA_CHECK(tcnn_tpu_torch::sort_keys_launch(
      x.data_ptr<float>(), x_stride_b, optional_ptr<float>(level_frac), dcols.data_ptr(),
      dcols.scalar_type() == at::kBFloat16, dc_stride_b, dc_stride_f,
      level_params.data_ptr<int32_t>(), static_cast<int>(level_params.size(0)), x.size(0),
      static_cast<int>(n_dims), static_cast<int>(n_features), factors,
      static_cast<int>(hash_kind), static_cast<int>(interp), sharded, optional_ptr<float>(u),
      static_cast<int32_t>(sentinel), keys.data_ptr<int32_t>(), vals.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void segment_sum(const torch::Tensor& keys, const torch::Tensor& order, const torch::Tensor& vals,
                 int64_t n_rows, const torch::Tensor& out) {
  const c10::cuda::CUDAGuard guard(out.device());
  const int n_features = static_cast<int>(vals.size(1));
  // the tiles' head and tail sums, in use until the launches have run
  const torch::Tensor scratch = torch::empty(
      {tcnn_tpu_torch::segment_sum_scratch_floats(keys.numel(), n_features)},
      vals.options());
  C10_CUDA_CHECK(tcnn_tpu_torch::segment_sum_launch(
      keys.data_ptr<int32_t>(), order.data_ptr<int64_t>(), vals.data_ptr<float>(),
      keys.numel(), n_features, n_rows, scratch.data_ptr<float>(), out.data_ptr(),
      out.scalar_type() == at::kBFloat16, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Launches kernel SR on chunks of at most kShampooRootMaxMatrices matrices;
// returns the number of launches.
int64_t shampoo_root(const torch::Tensor& step, const std::vector<torch::Tensor>& mats,
                     const std::vector<torch::Tensor>& roots, double identity,
                     const torch::Tensor& stats, int64_t max_sweeps) {
  const c10::cuda::CUDAGuard guard(step.device());
  const int count = static_cast<int>(mats.size());
  TORCH_CHECK(roots.size() == mats.size() && stats.size(0) == count,
              "shampoo_root: as many roots and stats rows as matrices");
  TORCH_CHECK(max_sweeps >= 1 && max_sweeps <= tcnn_tpu_torch::kShampooRootMaxSweeps,
              "shampoo_root: max_sweeps 1 to ", tcnn_tpu_torch::kShampooRootMaxSweeps);
  int64_t launches = 0;
  for (int first = 0; first < count; first += tcnn_tpu_torch::kShampooRootMaxMatrices) {
    const int chunk = std::min(count - first, tcnn_tpu_torch::kShampooRootMaxMatrices);
    std::vector<const float*> mat_ptrs(chunk);
    std::vector<float*> root_ptrs(chunk);
    std::vector<int> sizes(chunk);
    int64_t scratch_floats = 0;
    for (int i = 0; i < chunk; ++i) {
      const int64_t n = mats[first + i].size(0);
      TORCH_CHECK(n >= 1 && n <= tcnn_tpu_torch::kShampooRootMaxN,
                  "shampoo_root: a matrix of 1 to ", tcnn_tpu_torch::kShampooRootMaxN,
                  " rows, got ", n);
      mat_ptrs[i] = mats[first + i].data_ptr<float>();
      root_ptrs[i] = roots[first + i].data_ptr<float>();
      sizes[i] = static_cast<int>(n);
      scratch_floats += tcnn_tpu_torch::shampoo_root_scratch_floats(sizes[i]);
    }
    // A and Vᵀ of each matrix and its pair buffer, in use until the launch has run
    const torch::Tensor scratch = torch::empty({scratch_floats}, mats[first].options());
    C10_CUDA_CHECK(tcnn_tpu_torch::shampoo_root_launch(
        step.data_ptr<int32_t>(), mat_ptrs.data(), root_ptrs.data(), sizes.data(), chunk,
        identity, scratch.data_ptr<float>(), stats.data_ptr<int32_t>() + 2 * first,
        static_cast<int>(max_sweeps), c10::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    ++launches;
  }
  return launches;
}

int64_t fused_mlp_bwd_smem_bytes(int64_t d_in, int64_t d_out, int64_t width,
                                 int64_t n_layers, bool compute_bf16, int64_t act,
                                 int64_t out_act) {
  return tcnn_tpu_torch::fused_mlp_bwd_smem_bytes(
      static_cast<int>(d_in), static_cast<int>(d_out), static_cast<int>(width),
      static_cast<int>(n_layers), compute_bf16, static_cast<int>(act),
      static_cast<int>(out_act));
}

int64_t fused_mlp_fwd_smem_bytes(int64_t d_in, int64_t d_out, int64_t width,
                                 int64_t n_layers, bool compute_bf16, bool soa_in) {
  return tcnn_tpu_torch::fused_mlp_fwd_smem_bytes(
      static_cast<int>(d_in), static_cast<int>(d_out), static_cast<int>(width),
      static_cast<int>(n_layers), compute_bf16, soa_in);
}

void fused_mlp_wide_fwd(const torch::Tensor& x, int64_t x_stride_b, int64_t x_stride_d,
                        const torch::Tensor& w, const torch::Tensor& y, int64_t y_stride_b,
                        int64_t y_stride_d, int64_t batch, int64_t act) {
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(tcnn_tpu_torch::fused_mlp_wide_fwd_launch(
      x.data_ptr(), x_stride_b, x_stride_d, static_cast<int>(w.size(0)), w.data_ptr(),
      static_cast<int>(w.size(1)), y.data_ptr(), y_stride_b, y_stride_d,
      y.scalar_type() == at::kBFloat16, batch, x.scalar_type() == at::kBFloat16,
      static_cast<int>(act), c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_mlp_wide_bwd(const torch::Tensor& x, int64_t x_stride_b, int64_t x_stride_d,
                        const torch::Tensor& w, const torch::Tensor& g, int64_t g_stride_b,
                        int64_t g_stride_d, const torch::Tensor& dx, int64_t dx_stride_b,
                        int64_t dx_stride_d, const torch::Tensor& dw, int64_t batch,
                        int64_t act) {
  const c10::cuda::CUDAGuard guard(x.device());
  torch::Tensor partials;   // the CTAs' partial dW, sized by the launcher
  C10_CUDA_CHECK(tcnn_tpu_torch::fused_mlp_wide_bwd_launch(
      x.data_ptr(), x_stride_b, x_stride_d, static_cast<int>(w.size(0)), w.data_ptr(),
      static_cast<int>(w.size(1)), g.data_ptr<float>(), g_stride_b, g_stride_d, dx.data_ptr(),
      dx_stride_b, dx_stride_d, dx.scalar_type() == at::kBFloat16,
      [&](int64_t n) {
        partials = torch::empty({n}, dw.options());
        return partials.data_ptr<float>();
      },
      dw.data_ptr<float>(), batch, x.scalar_type() == at::kBFloat16, static_cast<int>(act),
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("grid_encode_fwd", &grid_encode_fwd, "grid-encode forward (kernel G)");
  m.def("fused_mlp_fwd", &fused_mlp_fwd, "fused-MLP forward (kernel M)");
  m.def("grid_encode_bwd", &grid_encode_bwd, "grid-encode backward (kernel GB)");
  m.def("fused_mlp_bwd", &fused_mlp_bwd, "fused-MLP backward (kernel MB)");
  m.def("grid_encode_bwd_input", &grid_encode_bwd_input,
        "grid-encode input gradient (kernel GI)");
  m.def("grid_encode_bwd_bwd", &grid_encode_bwd_bwd, "grid-encode second order (kernel GG)");
  m.def("grid_encode_third", &grid_encode_third, "grid-encode third order (kernel GT)");
  m.def("row_scatter", &row_scatter, "row scatter-add (kernel RS)");
  m.def("sort_keys", &sort_keys, "grid table-gradient updates as sort keys and values (kernel SK)");
  m.def("segment_sum", &segment_sum, "segment sums of sorted updates (kernel SS)");
  m.def("shampoo_root", &shampoo_root, "Shampoo's preconditioner roots on refresh steps (kernel SR)");
  m.attr("shampoo_root_max_sweeps") = tcnn_tpu_torch::kShampooRootMaxSweeps;
  m.def("fused_mlp_bwd_smem_bytes", &fused_mlp_bwd_smem_bytes,
        "shared memory of one kernel-MB CTA");
  m.def("fused_mlp_fwd_smem_bytes", &fused_mlp_fwd_smem_bytes,
        "shared memory of one kernel-M CTA");
  m.def("fused_mlp_wide_fwd", &fused_mlp_wide_fwd,
        "fused-MLP forward of one layer streamed in chunks of its inputs (kernel M, wide)");
  m.def("fused_mlp_wide_bwd", &fused_mlp_wide_bwd,
        "fused-MLP backward of one layer streamed in chunks of its inputs (kernel MB, wide)");
}

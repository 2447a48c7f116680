// Kernel GI: multiresolution grid encoding, the input gradient.
//
//   dx[b, d] = sum_l sum_c  d w_c(b, l) / dx_d  *  sum_k table[row_c(b, l), k] * dcols[l*F+k, b]
//
// There is no TPU kernel for it: the JAX package forms it in jnp, the
// re-gather of the corner rows and their dot with the cotangent in
// _finish_interp_bwd (grid_ops.py:1104-1119) and autodiff of
// _build_indices_weights (:476-523) for d w / dx.  The CUDA original's
// counterpart is kernel_grid_backward_input (grid.h:893).
//
// Design: one thread per sample, looping over the levels in order, so the
// sum over levels and corners is taken in one fixed order and the result
// is deterministic (no atomics).  The corner rows and weights come from
// LevelCorners (grid_common.cuh), exactly as kernel G computes them, and
// d w_c / dx_d from its per-dim closed-form derivatives by the product
// rule.  x and dcols are read through strides (dcols SoA (L*F, B), or the
// transpose of an AoS gradient), the table and dcols as float32 or
// bfloat16 (a run-time flag, so one instance per (D, F) serves all four
// dtype pairs).  Dead levels (at or above max_level) add nothing, nor do
// the levels a sample's coarse-to-fine mask drops (level_frac, as in
// kernels G and GB: grid_common.cuh's level_threshold; null, no mask).
//
// Bound on the H100: it reads x, dcols and the table rows the batch
// touches and writes dx.  At the SDF sample's shape (3-D, 8 levels, F = 2,
// B = 2^18, f32 table of 0.87 MB) that is 3.1 + 16.8 + 0.9 + 3.1 MB, about
// 7 us at 3.35 TB/s; like G, its 2^24 random row reads hit a table that
// stays in the 50 MB L2, so the corner arithmetic and the L2 bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

template <int D, int F>
__global__ void __launch_bounds__(kGridThreads)
grid_encode_bwd_input_kernel(const float* __restrict__ x, const float* __restrict__ level_frac,
                             const void* __restrict__ table,
                             bool table_bf16, const void* __restrict__ dcols, bool dcols_bf16,
                             const int32_t* __restrict__ level_params, float* __restrict__ dx,
                             int64_t batch, int n_levels, int64_t x_stride_b,
                             int64_t dc_stride_b, int64_t dc_stride_f, HashConsts hc,
                             int interp) {
  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (b >= batch) return;
  const float* xb = x + b * x_stride_b;
  // the levels below thr are the sample's (every level without a mask)
  const float thr = level_frac ? level_threshold(level_frac[b], n_levels)
                               : __int_as_float(0x7f800000);
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;

  for (int level = 0; level < n_levels; ++level) {
    const int32_t* lp = level_params + level * kLevelFields;
    if (lp[4] == 0 || !(float(level) < thr)) continue;  // at or above max_level, or masked
    float dy[F];
#pragma unroll
    for (int k = 0; k < F; ++k)
      dy[k] = load_any(dcols, dcols_bf16, b * dc_stride_b + int64_t(level * F + k) * dc_stride_f);
    const LevelCorners<D> lc(lp, xb, interp);
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      float t[F];
      load_row_any<F>(table, table_bf16, lc.row(c, hc), t);
      float val = 0.0f;
#pragma unroll
      for (int k = 0; k < F; ++k) val += t[k] * dy[k];
      float g[D];
      lc.weight_grad(c, g);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += g[d] * val;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dx[b * D + d] = acc[d];
}

struct BwdInputLaunch {
  const float* x;
  const float* level_frac;
  const void* table;
  bool table_bf16;
  const void* dcols;
  bool dcols_bf16;
  const int32_t* level_params;
  float* dx;
  int64_t batch;
  int n_levels;
  int64_t x_stride_b, dc_stride_b, dc_stride_f;
  HashConsts hc;
  int interp;
  cudaStream_t stream;

  template <int D, int F>
  cudaError_t run() const {
    const unsigned grid = unsigned((batch + kGridThreads - 1) / kGridThreads);
    grid_encode_bwd_input_kernel<D, F><<<grid, kGridThreads, 0, stream>>>(
        x, level_frac, table, table_bf16, dcols, dcols_bf16, level_params, dx, batch, n_levels,
        x_stride_b, dc_stride_b, dc_stride_f, hc, interp);
    return cudaGetLastError();
  }
};

}  // namespace

cudaError_t grid_encode_bwd_input_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const void* dcols, bool dcols_bf16, const int32_t* level_params,
    float* dx, int64_t batch, int n_dims, int n_levels, int n_features, int64_t dc_stride_b,
    int64_t dc_stride_f, const uint32_t hash_factors[4], bool coherent_add, int interp,
    cudaStream_t stream) {
  if (batch <= 0 || n_levels <= 0 || interp < 0 || interp > 2 || x_stride_b < n_dims)
    return cudaErrorInvalidValue;
  HashConsts hc;
  for (int d = 0; d < 4; ++d) hc.factors[d] = hash_factors[d];
  hc.coherent_add = coherent_add ? 1 : 0;
  return dispatch_df(n_dims, n_features,
                     BwdInputLaunch{x, level_frac, table, table_bf16, dcols, dcols_bf16,
                                    level_params, dx, batch, n_levels, x_stride_b, dc_stride_b,
                                    dc_stride_f, hc, interp, stream});
}

}  // namespace tcnn_tpu_torch

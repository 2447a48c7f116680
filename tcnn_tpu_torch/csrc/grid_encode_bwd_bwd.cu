// Kernel GG: multiresolution grid encoding, second order: the backward of
// kernel GI's input gradient, given ddx (B, D), the cotangent of dx.
//
// For each sample b and live level l, with w'_c = sum_d d w_c / dx_d * ddx[b, d]:
//   d_dcols[l*F+k, b] = sum_c w'_c * table[row_c, k]
//   d_x[b, e]        += sum_c sum_d d2 w_c / dx_d dx_e * ddx[b, d]
//                              * sum_k table[row_c, k] * dcols[l*F+k, b]
//   rows[(s*C + c)*B + b] = row_c,   g[(s*C + c)*B + b, k] = w'_c * dcols[l*F+k, b]
// where s counts the live levels before l.  (rows, g) feed kernel RS
// (row_scatter.cu), whose scatter-add of g at rows is the table gradient of
// the input gradient: the transpose of the corner re-gather, which the JAX
// package computes as the transpose of jnp.take(table2d, idx3)
// (grid_ops.py:1110-1111) and, one order up, as its row-scatter kernel
// (scatter.py::_scatter_kernel, through fast_take_flat, scatter.py:539).
// These are the CUDA original's backward-backward kernels (grid.h:902-1026:
// ddLdx_ddLdy, ddLdx_dx, ddLdx_dgrid).  There is no TPU kernel for GG
// itself: JAX forms it by autodiff of jnp code.
//
// Design: one thread per sample, looping over the levels in order (d_x is
// summed over levels in one fixed order, deterministic); each output is
// written only when its pointer is given (d_x only when x needs a
// gradient, rows and g only when the table does).  The corner rows,
// weights and weight derivatives come from LevelCorners (grid_common.cuh),
// as in kernels G and GI.  The scatter stays a separate kernel (RS),
// mirroring the JAX structure: at the SDF shape (3-D, 8 levels, F = 2,
// B = 2^18) the (rows, g) round trip is 2^24 updates of 12 bytes, 201 MB
// written here and read again by RS.  Forming g inside the scatter loop,
// as GB does, would save that traffic (a later change).
//
// Coarse-to-fine: with per-sample level fractions (level_frac, as in G, GB
// and GI; null, no mask) GG runs its run-time-D instance
// (grid_encode_bwd_bwd_wide_kernel), a run-time test per sample: a
// (sample, level) the mask drops loads nothing and writes nothing, so it
// adds nothing to d_x, and its d_dcols, rows and g keep the wrapper's fill
// (0, row -1, which RS skips, and 0).  A test in the 1- to 4-D instances
// moved their unmasked bits at 3 dims (the compiler fused other products),
// so they take no mask.  Rng grids
// and 5 to 7 dims run one instance with D at run time
// (grid_encode_bwd_bwd_wide_kernel), each corner's row in full.  Shard mode
// (a sharded table: grid_common.cuh, shard_owns) runs that instance's
// kShard copy: a corner the shard does not hold loads nothing, adds nothing
// to d_dcols or d_x, and writes row -1 (which RS skips) and g = 0; the
// kShard = false copy keeps its code and bits.
//
// Bound on the H100: the writes of rows and g dominate, 201 MB, with x,
// ddx, dcols (16.8 MB), d_dcols (16.8 MB) and d_x: about 0.07 ms at
// 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

template <int D, int F>
__global__ void __launch_bounds__(kGridThreads)
grid_encode_bwd_bwd_kernel(const float* __restrict__ x, const void* __restrict__ table,
                           bool table_bf16, const void* __restrict__ dcols, bool dcols_bf16,
                           const float* __restrict__ ddx, const int32_t* __restrict__ level_params,
                           float* __restrict__ d_dcols, float* __restrict__ d_x,
                           int32_t* __restrict__ rows, float* __restrict__ g, int64_t batch,
                           int n_levels, int64_t x_stride_b, int64_t dc_stride_b,
                           int64_t dc_stride_f, HashConsts hc, int interp) {
  constexpr int C = 1 << D;
  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (b >= batch) return;
  const float* xb = x + b * x_stride_b;
  float v[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    v[d] = ddx[b * D + d];
    acc[d] = 0.0f;
  }

  int slot = 0;  // live levels before this one
  for (int level = 0; level < n_levels; ++level) {
    const int32_t* lp = level_params + level * kLevelFields;
    if (lp[4] == 0) {  // at or above max_level: no d_dcols, no update
      if (d_dcols != nullptr) {
#pragma unroll
        for (int k = 0; k < F; ++k) d_dcols[int64_t(level * F + k) * batch + b] = 0.0f;
      }
      continue;
    }
    float dy[F];
#pragma unroll
    for (int k = 0; k < F; ++k)
      dy[k] = load_any(dcols, dcols_bf16, b * dc_stride_b + int64_t(level * F + k) * dc_stride_f);
    const LevelCorners<D> lc(lp, xb, interp);
    float dd[F];
#pragma unroll
    for (int k = 0; k < F; ++k) dd[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint32_t row = lc.row(c, hc);
      float t[F];
      load_row_any<F>(table, table_bf16, row, t);
      float gw[D];
      lc.weight_grad(c, gw);
      float wp = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) wp += gw[d] * v[d];
#pragma unroll
      for (int k = 0; k < F; ++k) dd[k] += wp * t[k];
      if (d_x != nullptr) {
        float val = 0.0f;
#pragma unroll
        for (int k = 0; k < F; ++k) val += t[k] * dy[k];
        float hv[D];
        lc.weight_hess_vec(c, v, hv);
#pragma unroll
        for (int e = 0; e < D; ++e) acc[e] += hv[e] * val;
      }
      if (rows != nullptr) {
        const int64_t i = int64_t(slot * C + c) * batch + b;
        rows[i] = int32_t(row);
#pragma unroll
        for (int k = 0; k < F; ++k) g[i * F + k] = wp * dy[k];
      }
    }
    if (d_dcols != nullptr) {
#pragma unroll
      for (int k = 0; k < F; ++k) d_dcols[int64_t(level * F + k) * batch + b] = dd[k];
    }
    ++slot;
  }
  if (d_x != nullptr) {
#pragma unroll
    for (int d = 0; d < D; ++d) d_x[b * D + d] = acc[d];
  }
}

// Rng grids and 5 to 7 dims: one instance with D, F and the dtypes at run
// time (WideCorners), the same outputs in the same orders.  kShard: a
// sharded table, only the corners it holds.
template <bool kShard>
__global__ void __launch_bounds__(kGridThreads)
grid_encode_bwd_bwd_wide_kernel(const float* __restrict__ x,
                                const float* __restrict__ level_frac, const void* table,
                                bool table_bf16, const void* dcols, bool dcols_bf16,
                                const float* __restrict__ ddx,
                                const int32_t* __restrict__ level_params,
                                float* __restrict__ d_dcols, float* __restrict__ d_x,
                                int32_t* __restrict__ rows, float* __restrict__ g,
                                int64_t batch, int n_levels, int n_dims, int n_features,
                                int64_t x_stride_b, int64_t dc_stride_b, int64_t dc_stride_f,
                                HashConsts hc, int interp) {
  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (b >= batch) return;
  const int C = 1 << n_dims, F = n_features;
  float v[kMaxDims], acc[kMaxDims];
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    v[d] = d < n_dims ? ddx[b * n_dims + d] : 0.0f;
    acc[d] = 0.0f;
  }
  const float thr = level_frac ? level_threshold(level_frac[b], n_levels)
                               : __int_as_float(0x7f800000);
  int slot = 0;
  for (int level = 0; level < n_levels; ++level) {
    const int32_t* lp = level_params + level * kLevelFields;
    if (lp[4] == 0) {
      if (d_dcols != nullptr)
        for (int k = 0; k < F; ++k) d_dcols[int64_t(level * F + k) * batch + b] = 0.0f;
      continue;
    }
    if (!(float(level) < thr)) {   // masked: the wrapper's fill stays
      ++slot;
      continue;
    }
    const WideCorners lc(lp, x + b * x_stride_b, n_dims, interp);
    float dy[8], dd[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      dd[k] = 0.0f;
      dy[k] = k < F
          ? load_any(dcols, dcols_bf16, b * dc_stride_b + int64_t(level * F + k) * dc_stride_f)
          : 0.0f;
    }
    for (int c = 0; c < C; ++c) {
      const uint32_t row = lc.row(c, hc);
      const int64_t i = int64_t(slot * C + c) * batch + b;
      if constexpr (kShard) {
        if (!shard_owns(lp, row)) {
          if (rows != nullptr) {
            rows[i] = -1;
            for (int k = 0; k < F; ++k) g[i * F + k] = 0.0f;
          }
          continue;
        }
      }
      float t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        t[k] = k < F ? load_any(table, table_bf16, int64_t(row) * F + k) : 0.0f;
      float gw[kMaxDims];
      lc.weight_grad(c, gw);
      float wp = 0.0f;
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) wp += gw[d] * v[d];
#pragma unroll
      for (int k = 0; k < 8; ++k) dd[k] += wp * t[k];
      if (d_x != nullptr) {
        float val = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) val += t[k] * dy[k];
        float hv[kMaxDims];
        lc.weight_hess_vec(c, v, hv);
#pragma unroll
        for (int e = 0; e < kMaxDims; ++e) acc[e] += hv[e] * val;
      }
      if (rows != nullptr) {
        rows[i] = int32_t(row);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < F) g[i * F + k] = wp * dy[k];
      }
    }
    if (d_dcols != nullptr) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < F) d_dcols[int64_t(level * F + k) * batch + b] = dd[k];
    }
    ++slot;
  }
  if (d_x != nullptr)
    for (int d = 0; d < n_dims; ++d) d_x[b * n_dims + d] = acc[d];
}

struct BwdBwdLaunch {
  const float* x;
  const void* table;
  bool table_bf16;
  const void* dcols;
  bool dcols_bf16;
  const float* ddx;
  const int32_t* level_params;
  float *d_dcols, *d_x;
  int32_t* rows;
  float* g;
  int64_t batch;
  int n_levels;
  int64_t x_stride_b, dc_stride_b, dc_stride_f;
  HashConsts hc;
  int interp;
  cudaStream_t stream;

  template <int D, int F>
  cudaError_t run() const {
    const unsigned grid = unsigned((batch + kGridThreads - 1) / kGridThreads);
    grid_encode_bwd_bwd_kernel<D, F><<<grid, kGridThreads, 0, stream>>>(
        x, table, table_bf16, dcols, dcols_bf16, ddx, level_params, d_dcols, d_x, rows, g,
        batch, n_levels, x_stride_b, dc_stride_b, dc_stride_f, hc, interp);
    return cudaGetLastError();
  }
};

}  // namespace

cudaError_t grid_encode_bwd_bwd_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16,
    const void* dcols, bool dcols_bf16, const float* ddx, const int32_t* level_params,
    float* d_dcols, float* d_x, int32_t* rows, float* g, int64_t batch, int n_dims,
    int n_levels, int n_features, int64_t dc_stride_b, int64_t dc_stride_f,
    const uint32_t hash_factors[7], int hash_kind, int interp, bool sharded,
    cudaStream_t stream) {
  if (batch <= 0 || n_levels <= 0 || interp < 0 || interp > 2 || x_stride_b < n_dims ||
      (rows == nullptr) != (g == nullptr) || n_dims < 1 || n_dims > kMaxDims ||
      n_features < 1 || n_features > 8)
    return cudaErrorInvalidValue;
  const HashConsts hc = make_hash_consts(hash_factors, hash_kind);
  if (sharded || wide_instance(n_dims, hash_kind) || level_frac != nullptr) {
    const auto kernel = sharded ? grid_encode_bwd_bwd_wide_kernel<true>
                                : grid_encode_bwd_bwd_wide_kernel<false>;
    kernel<<<unsigned((batch + kGridThreads - 1) / kGridThreads), kGridThreads, 0, stream>>>(
        x, level_frac, table, table_bf16, dcols, dcols_bf16, ddx, level_params, d_dcols, d_x,
        rows, g, batch, n_levels, n_dims, n_features, x_stride_b, dc_stride_b, dc_stride_f,
        hc, interp);
    return cudaGetLastError();
  }
  return dispatch_df(n_dims, n_features,
                     BwdBwdLaunch{x, table, table_bf16, dcols, dcols_bf16, ddx, level_params,
                                  d_dcols, d_x, rows, g, batch, n_levels, x_stride_b,
                                  dc_stride_b, dc_stride_f, hc, interp, stream});
}

}  // namespace tcnn_tpu_torch

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
// Bound on the H100: it reads x, dcols and the table rows the batch
// touches and writes dx.  At the SDF sample's shape (3-D, 8 levels, F = 2,
// B = 2^18, f32 table of 0.87 MB) that is 3.1 + 16.8 + 0.9 + 3.1 MB, about
// 7 us at 3.35 TB/s; like G, its 2^24 random row reads hit a table that
// stays in the 50 MB L2, so the latency of those reads and the corner
// arithmetic bound it.
//
// Design (kernel G's, grid_encode.cu, carried over to the sum over levels):
//  * a thread takes one sample and walks the levels in order, so that the
//    sum over levels and corners is taken in one fixed order (levels in
//    order, corners 0 .. 2^D-1, features in order) and dx is
//    deterministic, with no atomics;
//  * per level, every row first (LevelCorners::rows, from per-dim terms),
//    then every load (the 2^D rows and the F cotangents), then the sums:
//    all of a level's loads are in flight together;
//  * the table's and the cotangent's dtypes are template parameters, so
//    the loads carry no dtype test;
//  * the threads of a warp walk the same level at the same time, so a
//    level's constants are one broadcast load per warp;
//  * at most 64 registers a thread where its loads in flight allow
//    (min_ctas): 32 warps an SM, every one with a level's loads in flight.
// Measured on the H100 (PERF.md, tools/kernel_ablation.py): two samples a
// thread, four, one level a warp (eight warps summing in shared memory),
// and CTAs of 256 to 1024 threads walking the levels in lockstep were no
// faster; the kernel issues about as many instructions per (sample,
// level) as G, and its table rows missing in L1 cost about a third of its
// time (rows folded into 4096: 0.0310 against 0.0461 ms).
// The sums are those of the first design (one corner's load at a time),
// in the same order with the same expressions, so dx keeps its bits.  x
// and dcols are read through strides (dcols SoA (L*F, B), or the
// transpose of an AoS gradient).  Dead levels (at or above max_level) add
// nothing, nor do the levels a sample's coarse-to-fine mask drops
// (level_frac, as in kernels G and GB: grid_common.cuh's level_threshold;
// null, no mask), tested at run time: a level the sample does not keep
// loads nothing.  Rng grids, 5 to 7 dims and more than 8 features a level
// run one instance with D at run time (grid_encode_bwd_input_wide_kernel),
// each corner's row in full; the features in
// groups of 8 in one thread, so that dx stays deterministic with no atomics.
// Shard mode (a sharded table: grid_common.cuh, shard_owns) runs that
// instance's kShard copy, which adds no term for a corner the shard does
// not hold; the 1- to 4-D instances, and the kShard = false copy, keep
// their code and so their bits (a test in their sums could change which
// products the compiler fuses).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

// CTAs per SM the launch bounds ask the register allocator for: 4 (at most
// 64 registers a thread, 1024 threads an SM) where a thread's rows in
// flight take at most 16 floats; 1 where they take more, so that the loads
// in flight are not spilled.
template <int D, int F>
__host__ __device__ constexpr int min_ctas() {
  return (1 << D) * F <= 16 ? 4 : 1;
}

// Thread (blockIdx.x, threadIdx.x) takes sample b.  T: the table's element
// type; TD: the cotangent's.
template <typename T, typename TD, int D, int F>
__global__ void __launch_bounds__(kGridThreads, min_ctas<D, F>())
grid_encode_bwd_input_kernel(const float* __restrict__ x, const float* __restrict__ level_frac,
                             const T* __restrict__ table, const TD* __restrict__ dcols,
                             const int32_t* __restrict__ level_params, float* __restrict__ dx,
                             int64_t batch, int n_levels, int64_t x_stride_b,
                             int64_t dc_stride_b, int64_t dc_stride_f, HashConsts hc,
                             int interp) {
  constexpr int C = 1 << D;
  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (b >= batch) return;
  float xv[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xv[d] = x[b * x_stride_b + d];
    acc[d] = 0.0f;
  }
  // The levels below thr are the sample's: every level, or its mask's.
  const float thr = level_frac ? level_threshold(level_frac[b], n_levels)
                               : __int_as_float(0x7f800000);

  for (int level = 0; level < n_levels; ++level) {
    const int32_t* lp = level_params + level * kLevelFields;
    if (lp[4] == 0 || !(float(level) < thr)) continue;   // at or above max_level, or masked
    const bool pow2 = (uint32_t(lp[1]) & (uint32_t(lp[1]) - 1)) == 0;
    LevelCorners<D> lc(lp, xv, interp);
    uint32_t rows[C];
    lc.rows(hc, pow2, rows);
    float dy[F];
    float t[C][F];
#pragma unroll
    for (int k = 0; k < F; ++k)
      dy[k] = to_f32(dcols[b * dc_stride_b + int64_t(level * F + k) * dc_stride_f]);
#pragma unroll
    for (int c = 0; c < C; ++c) load_row<T, F>(table + int64_t(rows[c]) * F, t[c]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float val = 0.0f;
#pragma unroll
      for (int k = 0; k < F; ++k) val += t[c][k] * dy[k];
      float g[D];
      lc.weight_grad(c, g);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += g[d] * val;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dx[b * D + d] = acc[d];
}

// Rng grids, 5 to 7 dims and F > 8: one instance with D, F and the dtypes
// at run time (WideCorners), the same sums in the same order, each corner's
// row loaded as it is used.  kShard: a sharded table, only the corners it
// holds.  A level's features in groups of at most 8, one after another
// (one group where F <= 8), each group over every corner again, loaded four
// features a load where F is a multiple of 4; dx sums the levels in order,
// in each the groups in order, in each the corners in order.
template <bool kShard>
__global__ void __launch_bounds__(kGridThreads)
grid_encode_bwd_input_wide_kernel(const float* __restrict__ x,
                                  const float* __restrict__ level_frac, const void* table,
                                  bool table_bf16, const void* dcols, bool dcols_bf16,
                                  const int32_t* __restrict__ level_params,
                                  float* __restrict__ dx, int64_t batch, int n_levels,
                                  int n_dims, int n_features, int64_t x_stride_b,
                                  int64_t dc_stride_b, int64_t dc_stride_f, HashConsts hc,
                                  int interp) {
  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (b >= batch) return;
  float acc[kMaxDims] = {};
  const float thr = level_frac ? level_threshold(level_frac[b], n_levels)
                               : __int_as_float(0x7f800000);
  for (int level = 0; level < n_levels; ++level) {
    const int32_t* lp = level_params + level * kLevelFields;
    if (lp[4] == 0 || !(float(level) < thr)) continue;
    // features [g0, g0 + nf) of the row
    for (int g0 = 0; g0 < n_features; g0 += kFeatureGroup) {
      const int nf = min(kFeatureGroup, n_features - g0);
      const WideCorners lc(lp, x + b * x_stride_b, n_dims, interp);
      float dy[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dy[k] = k < nf ? load_any(dcols, dcols_bf16,
                                  b * dc_stride_b +
                                      (int64_t(level) * n_features + g0 + k) * dc_stride_f)
                       : 0.0f;
      for (int c = 0; c < (1 << n_dims); ++c) {
        const uint32_t r = lc.row(c, hc);
        if constexpr (kShard) {
          if (!shard_owns(lp, r)) continue;
        }
        const int64_t row = int64_t(r) * n_features + g0;
        float t[8], val = 0.0f;
        load_group(table, table_bf16, row, nf, n_features, t);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < nf) val += t[k] * dy[k];
        float g[kMaxDims];
        lc.weight_grad(c, g);
#pragma unroll
        for (int d = 0; d < kMaxDims; ++d) acc[d] += g[d] * val;
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d)
    if (d < n_dims) dx[b * n_dims + d] = acc[d];
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

  template <typename T, typename TD, int D, int F>
  cudaError_t launch() const {
    const unsigned grid = unsigned((batch + kGridThreads - 1) / kGridThreads);
    grid_encode_bwd_input_kernel<T, TD, D, F><<<grid, kGridThreads, 0, stream>>>(
        x, level_frac, static_cast<const T*>(table), static_cast<const TD*>(dcols),
        level_params, dx, batch, n_levels, x_stride_b, dc_stride_b, dc_stride_f, hc, interp);
    return cudaGetLastError();
  }

  template <typename T, int D, int F>
  cudaError_t launch_t() const {
    return dcols_bf16 ? launch<T, __nv_bfloat16, D, F>() : launch<T, float, D, F>();
  }

  template <int D, int F>
  cudaError_t run() const {
    return table_bf16 ? launch_t<__nv_bfloat16, D, F>() : launch_t<float, D, F>();
  }
};

}  // namespace

cudaError_t grid_encode_bwd_input_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const void* dcols, bool dcols_bf16, const int32_t* level_params,
    float* dx, int64_t batch, int n_dims, int n_levels, int n_features, int64_t dc_stride_b,
    int64_t dc_stride_f, const uint32_t hash_factors[7], int hash_kind, int interp,
    bool sharded, cudaStream_t stream) {
  if (batch <= 0 || n_levels <= 0 || interp < 0 || interp > 2 || x_stride_b < n_dims ||
      n_dims < 1 || n_dims > kMaxDims || n_features < 1)
    return cudaErrorInvalidValue;
  const HashConsts hc = make_hash_consts(hash_factors, hash_kind);
  if (sharded || wide_instance(n_dims, hash_kind, n_features)) {
    const auto kernel = sharded ? grid_encode_bwd_input_wide_kernel<true>
                                : grid_encode_bwd_input_wide_kernel<false>;
    kernel<<<unsigned((batch + kGridThreads - 1) / kGridThreads), kGridThreads, 0, stream>>>(
        x, level_frac, table, table_bf16, dcols, dcols_bf16, level_params, dx, batch,
        n_levels, n_dims, n_features, x_stride_b, dc_stride_b, dc_stride_f, hc, interp);
    return cudaGetLastError();
  }
  return dispatch_df(n_dims, n_features,
                     BwdInputLaunch{x, level_frac, table, table_bf16, dcols, dcols_bf16,
                                    level_params, dx, batch, n_levels, x_stride_b, dc_stride_b,
                                    dc_stride_f, hc, interp, stream});
}

}  // namespace tcnn_tpu_torch

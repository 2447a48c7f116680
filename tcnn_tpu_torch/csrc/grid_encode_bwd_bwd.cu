// Kernel GG: multiresolution grid encoding, second order: the backward of
// kernel GI's input gradient, given ddx (B, D), the cotangent of dx.
//
// For each sample b and live level l, with w'_c = sum_d d w_c / dx_d * ddx[b, d]:
//   d_dcols[l*F+k, b]   = sum_c w'_c * table[row_c, k]
//   d_x[b, e]          += sum_c sum_d d2 w_c / dx_d dx_e * ddx[b, d]
//                                * sum_k table[row_c, k] * dcols[l*F+k, b]
//   d_table[row_c, k]  += w'_c * dcols[l*F+k, b]
// the table gradient accumulated in fp32 and cast once to the table's
// dtype.  It is kernel GB's update with w' in place of w: the transpose of
// the corner re-gather, which the JAX package computes as the transpose of
// jnp.take(table2d, idx3) (grid_ops.py:1110-1111) and, one order up, as
// its row-scatter kernel (scatter.py::_scatter_kernel, through
// fast_take_flat, scatter.py:539).  These are the CUDA original's
// backward-backward kernels (grid.h:902-1026: ddLdx_ddLdy, ddLdx_dx,
// ddLdx_dgrid), which add into the grid gradient directly, as GG does.
// There is no TPU kernel for GG itself: JAX forms it by autodiff of jnp code.
//
// Bound on the H100: at the SDF shape (3-D, 8 levels, F = 2, B = 2^18, fp32
// table) it reads x, ddx, dcols (16.8 MB) and the touched table rows and
// writes d_dcols (16.8 MB), d_x and the 0.9 MB table gradient, about 45 MB,
// 0.014 ms at 3.35 TB/s; its arithmetic, 20D + 6F fp32 operations per
// (sample, level, corner) (72 here), 1.2 GFLOP, takes 0.018 ms at 67
// TFLOP/s, so operations bound it.  Keeping the updates out of device
// memory keeps it near that bound; one thread per (sample, level) fills
// the card at the SDF fit's 2^14 samples.
//
// Design: the work items of kernel GB's plan (ops/cuda/grid_encode.py::
// gb_plan, with GG's own chunk sizes; plan_items.cuh, shared with GT), all
// in one launch, one CTA per item (level, rows [row_lo, row_lo + n_rows),
// samples [b0, b1)), one thread per (sample, level) of the item.  The corner rows and weights come from
// LevelCorners (grid_common.cuh), as in G, GB and GI; w'_c and the Hessian
// of w_c times ddx from its dir_grad_hess, prefix and suffix products of
// the per-dim factors, O(D) per corner.  A thread loads the table
// rows of a group of corners at once (corner_group), then sums them.
//  * The table gradient: a window item (n_rows > 0) sums w'_c * dy of the
//    corners that land in its rows in shared memory and flushes the window
//    (scatter_common.cuh: window_zero, window_add, window_flush); a direct
//    item adds each corner with global atomics (float2 and float4 where F
//    allows, one float4 for the dim-0 pair r, r + 1, r even, at F = 2, as
//    GB).  No (rows, g) buffer exists; a row that nothing touches stays an
//    exact 0 (Adam's lazy step counters rely on that), and a corner with
//    w' = 0 adds nothing.
//  * d_dcols and d_x: a level cut into two windows has two items over the
//    same samples; only the first part's CTA (row_lo at the level's first
//    row, or a direct item) computes them, reading the table rows of all
//    corners, and the other part adds its rows' updates alone.  d_dcols is
//    written per (sample, level).  d_x sums over the levels and stays
//    deterministic: each (sample, level) writes its partial into
//    dx_part (L, B, D), and sum_levels_kernel adds the live levels'
//    partials in level order.  No atomics touch d_dcols or d_x, so two
//    launches give the same bits; the table gradient's atomics do not.
//  * Each output is computed only where its pointer is given (d_x only when
//    x needs a gradient, the table gradient only when the table does).
//
// Rng grids, 5 to 7 dims, a per-sample level mask (level_frac, as in G, GB
// and GI) and shard mode run one instance with D and F at run time
// (grid_encode_bwd_bwd_wide_kernel, WideCorners) on the same plan; the 1-
// to 4-D instances carry no code of them.  A (sample, level) the mask drops
// loads nothing and adds nothing: its d_dcols and d_x partial are written
// as 0.  Shard mode (its kShard copy; grid_common.cuh, shard_owns): a
// corner the shard does not hold loads nothing and adds nothing to any
// output; the plan windows only the shard's block (gb_plan), and the table
// gradient has the shard's rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"
#include "plan_items.cuh"
#include "scatter_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kGgThreads = 256;   // ops/cuda/grid_encode.py: GG_THREADS

struct GgParams {
  const float* x;
  const float* level_frac;   // null: no per-sample mask (run-time-D instance only)
  const void* table;
  const void* dcols;
  const float* ddx;
  const int32_t* level_params;
  const int32_t* items;      // this launch's items, kItemFields each
  float* d_dcols;            // (n_levels * F, B), or null
  float* dx_part;            // (n_levels, B, D) partials of d_x, or null
  float* grad;               // fp32 table gradient, or null
  int64_t batch, x_stride_b, dc_stride_b, dc_stride_f;
  HashConsts hc;
  int n_levels, interp;
  bool table_bf16, dcols_bf16;
};

template <int D, int F>
__global__ void __launch_bounds__(kGgThreads)
grid_encode_bwd_bwd_kernel(GgParams a) {
  extern __shared__ float win[];
  constexpr int C = 1 << D;
  const PlanItem it(a);
  if (!it.outputs && a.grad == nullptr) return;
  if (it.window) {
    window_zero(win, int(it.n_rows) * F);
    __syncthreads();
  }
  for (int64_t b = it.b0 + threadIdx.x; b < it.b1; b += kGgThreads) {
    float xb[D], v[D], dy[F];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xb[d] = __ldg(a.x + b * a.x_stride_b + d);
      v[d] = __ldg(a.ddx + b * D + d);
    }
#pragma unroll
    for (int k = 0; k < F; ++k)
      dy[k] = load_any(a.dcols, a.dcols_bf16,
                       b * a.dc_stride_b + int64_t(it.level * F + k) * a.dc_stride_f);
    const LevelCorners<D> lc(it.lp, xb, a.interp);
    uint32_t rows[C];
    lc.rows(a.hc, (uint32_t(it.lp[1]) & (uint32_t(it.lp[1]) - 1)) == 0, rows);
    float dd[F], acc[D];
#pragma unroll
    for (int k = 0; k < F; ++k) dd[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;
    // G corners at a time: their table rows loaded together, then their
    // sums and their updates
    constexpr int G = corner_group<D, F>();
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += G) {
      float t[G][F], wp[G];
      if (it.outputs) {
#pragma unroll
        for (int g = 0; g < G; ++g) load_row_any<F>(a.table, a.table_bf16, rows[c0 + g], t[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (it.outputs && a.dx_part != nullptr) {
          float hv[D], val = 0.0f;
          wp[g] = lc.dir_grad_hess(c0 + g, v, hv);
#pragma unroll
          for (int k = 0; k < F; ++k) val += t[g][k] * dy[k];
#pragma unroll
          for (int e = 0; e < D; ++e) acc[e] += hv[e] * val;
        } else {
          wp[g] = lc.dir_grad(c0 + g, v);
        }
        if (it.outputs) {
#pragma unroll
          for (int k = 0; k < F; ++k) dd[k] += wp[g] * t[g][k];
        }
      }
      if (a.grad != nullptr) {
#pragma unroll
        for (int g = 0; g < G; g += 2)
          scatter_pair<F>(a.grad, it, win, {rows[c0 + g], rows[c0 + g + 1]},
                          {wp[g], wp[g + 1]}, dy);
      }
    }
    if (it.outputs) {
      if (a.d_dcols != nullptr) {
#pragma unroll
        for (int k = 0; k < F; ++k) a.d_dcols[int64_t(it.level * F + k) * a.batch + b] = dd[k];
      }
      if (a.dx_part != nullptr) {
        float* p = a.dx_part + (int64_t(it.level) * a.batch + b) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) p[d] = acc[d];
      }
    }
  }
  if (it.window) {
    __syncthreads();
    window_flush<scatter_vec(F)>(win, int(it.n_rows) * F,
                                 a.grad + int64_t(uint32_t(it.offset + it.row_lo)) * F);
  }
}

// Rng grids, 5 to 7 dims, a per-sample mask and (kShard) shard mode: one
// instance with D, F and the dtypes at run time (WideCorners), the same
// plan, outputs and orders; in direct items a float2 atomic per two
// features where F is even, else one per feature.
template <bool kShard>
__global__ void __launch_bounds__(kGgThreads)
grid_encode_bwd_bwd_wide_kernel(GgParams a, int n_dims, int n_features) {
  extern __shared__ float win[];
  const PlanItem it(a);
  if (!it.outputs && a.grad == nullptr) return;
  const int C = 1 << n_dims, F = n_features;
  if (it.window) {
    window_zero(win, int(it.n_rows) * F);
    __syncthreads();
  }
  for (int64_t b = it.b0 + threadIdx.x; b < it.b1; b += kGgThreads) {
    const bool live = !a.level_frac ||
                      float(it.level) < level_threshold(a.level_frac[b], a.n_levels);
    float acc[kMaxDims], dd[8];
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) acc[d] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) dd[k] = 0.0f;
    if (live) {   // masked: nothing loaded, nothing added, zero outputs below
      float v[kMaxDims], dy[8];
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) v[d] = d < n_dims ? a.ddx[b * n_dims + d] : 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dy[k] = k < F ? load_any(a.dcols, a.dcols_bf16,
                                 b * a.dc_stride_b + int64_t(it.level * F + k) * a.dc_stride_f)
                      : 0.0f;
      const WideCorners lc(it.lp, a.x + b * a.x_stride_b, n_dims, a.interp);
      for (int c = 0; c < C; ++c) {
        const uint32_t row = lc.row(c, a.hc);
        if constexpr (kShard) {
          if (!shard_owns(it.lp, row)) continue;
        }
        float t[8], wp;
        if (it.outputs) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            t[k] = k < F ? load_any(a.table, a.table_bf16, int64_t(row) * F + k) : 0.0f;
        }
        if (it.outputs && a.dx_part != nullptr) {
          float hv[kMaxDims], val = 0.0f;
          wp = lc.dir_grad_hess(c, v, hv);
#pragma unroll
          for (int k = 0; k < 8; ++k) val += t[k] * dy[k];
#pragma unroll
          for (int e = 0; e < kMaxDims; ++e) acc[e] += hv[e] * val;
        } else {
          wp = lc.dir_grad(c, v);
        }
        if (it.outputs) {
#pragma unroll
          for (int k = 0; k < 8; ++k) dd[k] += wp * t[k];
        }
        if (a.grad != nullptr) scatter_one(a.grad, it, win, row, wp, dy, F);
      }
    }
    if (it.outputs) {
      if (a.d_dcols != nullptr) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < F) a.d_dcols[int64_t(it.level * F + k) * a.batch + b] = dd[k];
      }
      if (a.dx_part != nullptr) {
        float* p = a.dx_part + (int64_t(it.level) * a.batch + b) * n_dims;
        for (int d = 0; d < n_dims; ++d) p[d] = acc[d];
      }
    }
  }
  if (it.window) {
    __syncthreads();
    window_flush<1>(win, int(it.n_rows) * F,
                    a.grad + int64_t(uint32_t(it.offset + it.row_lo)) * F);
  }
}

template <int D, int F>
struct GgInstance {
  static auto kernel() { return grid_encode_bwd_bwd_kernel<D, F>; }
};

}  // namespace

cudaError_t grid_encode_bwd_bwd_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const void* dcols, bool dcols_bf16, const float* ddx,
    const int32_t* level_params, int n_levels, const int32_t* items, const int32_t* groups,
    int n_groups, float* d_dcols, float* dx_part, float* d_x, float* grad, void* out,
    bool out_bf16, int64_t n_params, int64_t batch, int n_dims, int n_features,
    int64_t dc_stride_b, int64_t dc_stride_f, const uint32_t hash_factors[7], int hash_kind,
    int interp, bool sharded, cudaStream_t stream) {
  if (batch <= 0 || n_levels <= 0 || !groups_valid(groups, n_groups) || interp < 0 ||
      interp > 2 || x_stride_b < n_dims || (d_x == nullptr) != (dx_part == nullptr) ||
      (grad == nullptr) != (out == nullptr) || (grad != nullptr && n_params <= 0) ||
      (!out_bf16 && out != grad) || n_dims < 1 || n_dims > kMaxDims || n_features < 1 ||
      n_features > 8)
    return cudaErrorInvalidValue;
  const GgParams a{x, level_frac, table, dcols, ddx, level_params, items, d_dcols, dx_part,
                   grad, batch, x_stride_b, dc_stride_b, dc_stride_f,
                   make_hash_consts(hash_factors, hash_kind), n_levels, interp, table_bf16,
                   dcols_bf16};
  cudaError_t err = cudaSuccess;
  if (grad != nullptr) err = cudaMemsetAsync(grad, 0, size_t(n_params) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if (sharded || wide_instance(n_dims, hash_kind) || level_frac != nullptr) {
    const auto kernel = sharded ? grid_encode_bwd_bwd_wide_kernel<true>
                                : grid_encode_bwd_bwd_wide_kernel<false>;
    err = launch_groups<kGgThreads>(kernel, a, groups, n_groups, stream, n_dims, n_features);
  } else {
    err = dispatch_df(n_dims, n_features,
                      PlanLaunch<kGgThreads, GgParams, GgInstance>{a, groups, n_groups, stream});
  }
  if (err != cudaSuccess) return err;
  if (d_x != nullptr) {
    const int64_t n = batch * n_dims;
    sum_levels_kernel<<<unsigned((n + kGridThreads - 1) / kGridThreads), kGridThreads, 0,
                        stream>>>(dx_part, level_params, n_levels, n, d_x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (grad == nullptr || !out_bf16) return cudaSuccess;
  cast_to_bf16_kernel<<<unsigned((n_params + kGridThreads - 1) / kGridThreads), kGridThreads,
                        0, stream>>>(grad, static_cast<__nv_bfloat16*>(out), n_params);
  return cudaGetLastError();
}

}  // namespace tcnn_tpu_torch

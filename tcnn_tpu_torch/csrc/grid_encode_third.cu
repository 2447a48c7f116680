// Kernel GT: multiresolution grid encoding, third order: the blocks of
// kernel GG's backward that no other kernel computes.
//
// GG maps (T, x, dcols, v) to (d_dcols, d_x, d_table), v its ddx; its d_x
// is sum_c (d2 w_c / dx2) v <T_c, dcols_l>.  Given beta (B, D), the
// cotangent of that d_x, and with u_c = beta^T (d2 w_c / dx2) v per
// (sample, level, corner):
//   d_dcols[l*F+k, b]  = sum_c u_c * table[row_c, k]
//   d_x[b, e]          = sum_l sum_c (d3 w_c / dx3)[beta, v, e]
//                                 * sum_k table[row_c, k] * dcols[l*F+k, b]
//   d_table[row_c, k] += u_c * dcols[l*F+k, b]
// the table gradient accumulated in fp32 and cast once to the table's
// dtype.  Every other block of GG's backward is a launch of G, GI or GG
// (ops/grid_ops.py: GridBwdBwdFunction.backward); d2 w / dx2 is symmetric,
// so the block in v is GG's d_x at ddx = beta.  There is no TPU kernel for
// GT: the JAX package forms the third derivative by autodiff of jnp code
// (the backward of _grid_interpolate's custom VJP, grid_ops.py:917-1122).
//
// The weights' derivatives along two directions: w_c is a product of
// per-dim factors phi_d(x_d), so along x + s*beta + t*v each factor is
// phi + phi'(s beta_d + t v_d) + phi'' s t beta_d v_d + ..., and u_c is
// the st coefficient of their product; (d3 w_c / dx3)[beta, v, e] is the
// st coefficient of the same product with factor e replaced by its
// derivative in x_e.  Prefix products over the dims below e and suffix
// products over those above, in (1, s, t, st) coefficients (Jet), give
// every e in O(D) per corner.  Per dim the factor's first, second and
// third derivatives are the closed forms of Linear (1, 0, 0) and
// Smoothstep (6f(1-f), 6-12f, -12), times scale, scale^2 and scale^3;
// Nearest has none (grid_common.cuh, interp_derivatives).
//
// Bound on the H100 at the SDF shape (3-D, 8 levels, F = 2, B = 2^18,
// fp32 table), all three outputs: it reads x, v, beta and dcols (26 MB)
// and the touched table rows and writes d_dcols (16.8 MB), d_x and the
// table gradient, about 48 MB, 0.014 ms at 3.35 TB/s; its arithmetic as
// the 1- to 4-D instances do it (chip_smoke.py: gt_flops), 876 operations
// per (sample, level) at D = 3, F = 2, 1.84 GFLOP, takes 0.027 ms at 67
// TFLOP/s: operations bound it.  The curvature step's parameter pass asks
// for d_dcols and the table gradient alone (x needs no gradient there):
// 324 operations per (sample, level), 0.68 GFLOP, 0.010 ms, against about
// 45 MB, 0.013 ms: bytes bound it.
//
// Design: kernel GG's (grid_encode_bwd_bwd.cu), on the items of kernel
// GB's plan with GG's chunks (plan_items.cuh; ops/cuda/grid_encode.py::
// gb_plan, gg_chunks), all in one launch, one CTA per item and one
// (sample, level) a thread.  The coarse levels, whose few rows take
// thousands of updates each, sum the table gradient in shared-memory
// windows; the fine levels add by direct atomics, one float4 for a dim-0
// pair of rows at F = 2; a corner with u = 0 adds nothing, and a row that
// nothing touches stays an exact 0.  Only the first part of a level cut in
// two windows computes d_dcols and d_x's per-level partial; d_x sums the
// live levels' partials in level order (sum_levels_kernel), so d_dcols and
// d_x have the same bits from launch to launch.  The 1- to 4-D instances
// (D and F at compile time) take each corner's row from LevelCorners::rows
// (2D multiplies for 2^D corners), load the table rows of a group of
// corners at once (corner_group) and keep the per-dim jets of both bits
// in registers; each corner's prefix product gives u, and only where d_x
// is asked for the suffix products and the d3 w entries are formed.
//
// Rng grids, 5 to 7 dims, a per-sample level mask (level_frac, as in G,
// GB, GI and GG) and shard mode run one instance with D and F at run time
// (grid_encode_third_wide_kernel, WideCorners) on the same plan; the 1- to
// 4-D instances carry none of that code.  A masked (sample, level) loads
// nothing and adds nothing and writes zeros to d_dcols and its d_x
// partial.  Shard mode (its kShard copy; shard_owns): a corner the shard
// does not hold loads nothing and adds nothing to any output; the plan
// windows only the shard's block, and the table gradient has the shard's
// rows.  Each output is computed only where its pointer is given.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_ablation.py
// --baseline, one run): 0.2574 ms at the SDF shape and 2^18 with all
// outputs, 0.2333 with the curvature step's; the design before this one
// (one thread per (sample, level) over a grid of levels, the corners in
// the run-time-D loop, every update a direct atomic) 1.3786 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"
#include "plan_items.cuh"
#include "scatter_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kGtThreads = 256;   // GG_THREADS (ops/cuda/grid_encode.py): GG's chunks

struct GtParams {
  const float* x;
  const float* level_frac;   // null: no per-sample mask (run-time-D instance only)
  const void* table;
  const void* dcols;
  const float* ddx;          // v
  const float* ct_dx;        // beta
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

// A polynomial in two variables s, t truncated to 1, s, t and st.
struct Jet {
  float o, s, t, st;
};

__device__ __forceinline__ Jet jet_mul(const Jet& a, const Jet& b) {
  return {a.o * b.o, a.o * b.s + a.s * b.o, a.o * b.t + a.t * b.o,
          a.o * b.st + a.s * b.t + a.t * b.s + a.st * b.o};
}

// The st coefficient of a * b.
__device__ __forceinline__ float jet_st(const Jet& a, const Jet& b) {
  return a.o * b.st + a.s * b.t + a.t * b.s + a.st * b.o;
}

// A factor along s beta + t v from its value and derivatives f1, f2 in x_d.
__device__ __forceinline__ Jet factor_jet(float f, float f1, float f2, float be, float v) {
  return {f, f1 * be, f1 * v, f2 * be * v};
}

template <int D, int F>
__global__ void __launch_bounds__(kGtThreads)
grid_encode_third_kernel(GtParams a) {
  extern __shared__ float win[];
  constexpr int C = 1 << D;
  const PlanItem it(a);
  if (!it.outputs && a.grad == nullptr) return;
  if (it.window) {
    window_zero(win, int(it.n_rows) * F);
    __syncthreads();
  }
  const bool want_x = it.outputs && a.dx_part != nullptr;
  const float scale = __int_as_float(it.lp[0]);
  const float d3w1 = a.interp == 2 ? -12.0f * scale * scale * scale : 0.0f;
  for (int64_t b = it.b0 + threadIdx.x; b < it.b1; b += kGtThreads) {
    float xb[D], v[D], be[D], dy[F];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xb[d] = __ldg(a.x + b * a.x_stride_b + d);
      v[d] = __ldg(a.ddx + b * D + d);
      be[d] = __ldg(a.ct_dx + b * D + d);
    }
#pragma unroll
    for (int k = 0; k < F; ++k)
      dy[k] = load_any(a.dcols, a.dcols_bf16,
                       b * a.dc_stride_b + int64_t(it.level * F + k) * a.dc_stride_f);
    const LevelCorners<D> lc(it.lp, xb, a.interp);
    uint32_t rows[C];
    lc.rows(a.hc, (uint32_t(it.lp[1]) & (uint32_t(it.lp[1]) - 1)) == 0, rows);
    // per dim and bit h of a corner: its factor's jet fj, and (d_x) the jet
    // of its derivative in x_d, qj
    Jet fj[D][2], qj[D][2];
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h << d;
        const float f1 = lc.dfactor(c, d), f2 = lc.d2factor(c, d);
        fj[d][h] = factor_jet(lc.factor(c, d), f1, f2, be[d], v[d]);
        if (want_x) qj[d][h] = factor_jet(f1, f2, h ? d3w1 : -d3w1, be[d], v[d]);
      }
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
      float t[G][F], u[G];
      if (it.outputs) {
#pragma unroll
        for (int g = 0; g < G; ++g) load_row_any<F>(a.table, a.table_bf16, rows[c0 + g], t[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = c0 + g;
        // pre[d]: the product of the factors of the dims below d
        Jet pre[D + 1];
        pre[1] = fj[0][c & 1];
#pragma unroll
        for (int d = 1; d < D; ++d) pre[d + 1] = jet_mul(pre[d], fj[d][(c >> d) & 1]);
        u[g] = pre[D].st;
        if (want_x) {
          float val = 0.0f;
#pragma unroll
          for (int k = 0; k < F; ++k) val += t[g][k] * dy[k];
          Jet suf;   // the product of the factors of the dims above e
#pragma unroll
          for (int e = D - 1; e >= 0; --e) {
            const int h = (c >> e) & 1;
            const Jet dq = e == 0 ? qj[0][h] : jet_mul(pre[e], qj[e][h]);
            acc[e] += (e == D - 1 ? dq.st : jet_st(dq, suf)) * val;
            if (e > 0) suf = e == D - 1 ? fj[e][h] : jet_mul(fj[e][h], suf);
          }
        }
        if (it.outputs) {
#pragma unroll
          for (int k = 0; k < F; ++k) dd[k] += u[g] * t[g][k];
        }
      }
      if (a.grad != nullptr) {
#pragma unroll
        for (int g = 0; g < G; g += 2)
          scatter_pair<F>(a.grad, it, win, {rows[c0 + g], rows[c0 + g + 1]}, {u[g], u[g + 1]},
                          dy);
      }
    }
    if (it.outputs) {
      if (a.d_dcols != nullptr) {
#pragma unroll
        for (int k = 0; k < F; ++k) a.d_dcols[int64_t(it.level * F + k) * a.batch + b] = dd[k];
      }
      if (want_x) {
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
// plan, outputs and orders; each corner's row and jets in full.
template <bool kShard>
__global__ void __launch_bounds__(kGtThreads)
grid_encode_third_wide_kernel(GtParams a, int n_dims, int n_features) {
  extern __shared__ float win[];
  const PlanItem it(a);
  if (!it.outputs && a.grad == nullptr) return;
  const int D = n_dims, F = n_features, C = 1 << n_dims;
  if (it.window) {
    window_zero(win, int(it.n_rows) * F);
    __syncthreads();
  }
  const bool want_x = it.outputs && a.dx_part != nullptr;
  const float scale = __int_as_float(it.lp[0]);
  const float d3w1 = a.interp == 2 ? -12.0f * scale * scale * scale : 0.0f;
  for (int64_t b = it.b0 + threadIdx.x; b < it.b1; b += kGtThreads) {
    const bool live = !a.level_frac ||
                      float(it.level) < level_threshold(a.level_frac[b], a.n_levels);
    float dd[8], acc[kMaxDims];
#pragma unroll
    for (int k = 0; k < 8; ++k) dd[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) acc[d] = 0.0f;
    if (live) {   // masked: nothing loaded, nothing added, zero outputs below
      float v[kMaxDims], be[kMaxDims], dy[8];
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) {
        v[d] = d < D ? a.ddx[b * D + d] : 0.0f;
        be[d] = d < D ? a.ct_dx[b * D + d] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dy[k] = k < F ? load_any(a.dcols, a.dcols_bf16,
                                 b * a.dc_stride_b + int64_t(it.level * F + k) * a.dc_stride_f)
                      : 0.0f;
      const WideCorners lc(it.lp, a.x + b * a.x_stride_b, D, a.interp);
      for (int c = 0; c < C; ++c) {
        const uint32_t row = lc.row(c, a.hc);
        if constexpr (kShard) {
          if (!shard_owns(it.lp, row)) continue;
        }
        // pre[d]: the product of the factors of the dims below d
        Jet pre[kMaxDims + 1];
        pre[0] = {1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int d = 0; d < kMaxDims; ++d)
          pre[d + 1] = d < D ? jet_mul(pre[d], factor_jet(lc.factor(c, d), lc.dfactor(c, d),
                                                          lc.d2factor(c, d), be[d], v[d]))
                             : pre[d];
        const float u = pre[kMaxDims].st;
        float t[8];
        if (it.outputs) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            t[k] = k < F ? load_any(a.table, a.table_bf16, int64_t(row) * F + k) : 0.0f;
#pragma unroll
          for (int k = 0; k < 8; ++k) dd[k] += u * t[k];
        }
        if (want_x) {
          float val = 0.0f;
#pragma unroll
          for (int k = 0; k < 8; ++k) val += t[k] * dy[k];
          Jet suf = {1.0f, 0.0f, 0.0f, 0.0f};   // the dims above e
#pragma unroll
          for (int e = kMaxDims - 1; e >= 0; --e) {
            if (e >= D) continue;
            const float f1 = lc.dfactor(c, e), f2 = lc.d2factor(c, e);
            const float f3 = ((c >> e) & 1) ? d3w1 : -d3w1;
            acc[e] += jet_st(jet_mul(pre[e], factor_jet(f1, f2, f3, be[e], v[e])), suf) * val;
            suf = jet_mul(factor_jet(lc.factor(c, e), f1, f2, be[e], v[e]), suf);
          }
        }
        if (a.grad != nullptr) scatter_one(a.grad, it, win, row, u, dy, F);
      }
    }
    if (it.outputs) {
      if (a.d_dcols != nullptr) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < F) a.d_dcols[int64_t(it.level * F + k) * a.batch + b] = dd[k];
      }
      if (want_x) {
        float* p = a.dx_part + (int64_t(it.level) * a.batch + b) * D;
        for (int d = 0; d < D; ++d) p[d] = acc[d];
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
struct GtInstance {
  static auto kernel() { return grid_encode_third_kernel<D, F>; }
};

}  // namespace

cudaError_t grid_encode_third_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const void* dcols, bool dcols_bf16, const float* ddx, const float* ct_dx,
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
  const GtParams a{x, level_frac, table, dcols, ddx, ct_dx, level_params, items, d_dcols,
                   dx_part, grad, batch, x_stride_b, dc_stride_b, dc_stride_f,
                   make_hash_consts(hash_factors, hash_kind), n_levels, interp, table_bf16,
                   dcols_bf16};
  cudaError_t err = cudaSuccess;
  if (grad != nullptr) err = cudaMemsetAsync(grad, 0, size_t(n_params) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if (sharded || wide_instance(n_dims, hash_kind) || level_frac != nullptr) {
    const auto kernel = sharded ? grid_encode_third_wide_kernel<true>
                                : grid_encode_third_wide_kernel<false>;
    err = launch_groups<kGtThreads>(kernel, a, groups, n_groups, stream, n_dims, n_features);
  } else {
    err = dispatch_df(n_dims, n_features,
                      PlanLaunch<kGtThreads, GtParams, GtInstance>{a, groups, n_groups, stream});
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

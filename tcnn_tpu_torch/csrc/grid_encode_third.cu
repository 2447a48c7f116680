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
// products over those above, in (1, s, t, st) coefficients, give every e
// in O(D) per corner.  Per dim the factor's first, second and third
// derivatives are the closed forms of Linear (1, 0, 0) and Smoothstep
// (6f(1-f), 6-12f, -12), times scale, scale^2 and scale^3; Nearest has
// none (grid_common.cuh, interp_derivatives).
//
// Bound on the H100: at the SDF shape (3-D, 8 levels, F = 2, B = 2^18,
// fp32 table) it reads x, v, beta and dcols (about 26 MB) and the touched
// table rows and writes d_dcols (16.8 MB), d_x and the table gradient,
// about 50 MB, 0.015 ms at 3.35 TB/s; its arithmetic, about 50D + 6F fp32
// operations per (sample, level, corner), 3.4 GFLOP, takes about 0.05 ms
// at 67 TFLOP/s: operations bound it (chip_smoke.py: gt_flops).
//
// Design, simple first: one thread per (sample, level), blockIdx.y the
// level, D and F at run time in one instance (WideCorners: any hash, 1 to
// 7 dims), the corners in a loop, each row computed and loaded as it is
// used.  The table gradient by fp32 global atomics (float2 where F is
// even); d_dcols written per (sample, level); d_x's per-level partials
// written to dx_part and summed in level order (sum_levels_kernel), so
// d_dcols and d_x have the same bits from launch to launch.  Each output
// only where its pointer is given.  A per-sample level mask (level_frac,
// as in G, GB, GI and GG), a dead level and, in shard mode, a corner the
// shard does not hold (shard_owns) load nothing and add nothing; a masked
// or dead (sample, level) writes zeros to d_dcols and its d_x partial.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"
#include "scatter_common.cuh"

namespace tcnn_tpu_torch {
namespace {

struct GtParams {
  const float* x;
  const float* level_frac;   // null: no per-sample mask
  const void* table;
  const void* dcols;
  const float* ddx;          // v
  const float* ct_dx;        // beta
  const int32_t* level_params;
  float* d_dcols;            // (n_levels * F, B), or null
  float* dx_part;            // (n_levels, B, D) partials of d_x, or null
  float* grad;               // fp32 table gradient, or null
  int64_t batch, x_stride_b, dc_stride_b, dc_stride_f;
  HashConsts hc;
  int n_levels, n_dims, n_features, interp;
  bool table_bf16, dcols_bf16, sharded;
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

__global__ void __launch_bounds__(kGridThreads)
grid_encode_third_kernel(GtParams a) {
  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  const int level = blockIdx.y;
  if (b >= a.batch) return;
  const int32_t* lp = a.level_params + level * kLevelFields;
  const int D = a.n_dims, F = a.n_features, C = 1 << D;
  const bool live = lp[4] != 0 &&
      (!a.level_frac || float(level) < level_threshold(a.level_frac[b], a.n_levels));
  float dd[8], acc[kMaxDims];
#pragma unroll
  for (int k = 0; k < 8; ++k) dd[k] = 0.0f;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) acc[d] = 0.0f;
  if (live) {   // masked or dead: nothing loaded, nothing added, zero outputs below
    float v[kMaxDims], be[kMaxDims], dy[8];
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      v[d] = d < D ? a.ddx[b * D + d] : 0.0f;
      be[d] = d < D ? a.ct_dx[b * D + d] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      dy[k] = k < F ? load_any(a.dcols, a.dcols_bf16,
                               b * a.dc_stride_b + int64_t(level * F + k) * a.dc_stride_f)
                    : 0.0f;
    const WideCorners lc(lp, a.x + b * a.x_stride_b, D, a.interp);
    const float scale = __int_as_float(lp[0]);
    const float d3w1 = a.interp == 2 ? -12.0f * scale * scale * scale : 0.0f;
    const bool read_table = a.d_dcols != nullptr || a.dx_part != nullptr;
    for (int c = 0; c < C; ++c) {
      const uint32_t row = lc.row(c, a.hc);
      if (a.sharded && !shard_owns(lp, row)) continue;
      // pre[d]: the product of the factors of the dims below d along s beta + t v
      Jet pre[kMaxDims + 1];
      pre[0] = {1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) {
        if (d < D) {
          const float f1 = lc.dfactor(c, d), f2 = lc.d2factor(c, d);
          pre[d + 1] = jet_mul(pre[d], {lc.factor(c, d), f1 * be[d], f1 * v[d],
                                        f2 * be[d] * v[d]});
        } else {
          pre[d + 1] = pre[d];
        }
      }
      const float u = pre[kMaxDims].st;
      float t[8];
      if (read_table) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          t[k] = k < F ? load_any(a.table, a.table_bf16, int64_t(row) * F + k) : 0.0f;
      }
      if (a.d_dcols != nullptr) {
#pragma unroll
        for (int k = 0; k < 8; ++k) dd[k] += u * t[k];
      }
      if (a.dx_part != nullptr) {
        float val = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) val += t[k] * dy[k];
        Jet suf = {1.0f, 0.0f, 0.0f, 0.0f};   // the dims above e
#pragma unroll
        for (int e = kMaxDims - 1; e >= 0; --e) {
          if (e >= D) continue;
          const float f1 = lc.dfactor(c, e), f2 = lc.d2factor(c, e);
          const float f3 = ((c >> e) & 1) ? d3w1 : -d3w1;
          const Jet q = {f1, f2 * be[e], f2 * v[e], f3 * be[e] * v[e]};   // d factor_e / dx_e
          acc[e] += jet_st(jet_mul(pre[e], q), suf) * val;
          suf = jet_mul({lc.factor(c, e), f1 * be[e], f1 * v[e], f2 * be[e] * v[e]}, suf);
        }
      }
      if (a.grad == nullptr || u == 0.0f) continue;
      float* p = a.grad + int64_t(row) * F;
      if (F % 2 == 0) {
#pragma unroll
        for (int k = 0; k < 8; k += 2)
          if (k < F) global_add<2>(p + k, {__fmul_rn(u, dy[k]), __fmul_rn(u, dy[k + 1])});
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < F) atomicAdd(p + k, __fmul_rn(u, dy[k]));
      }
    }
  }
  if (a.d_dcols != nullptr) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < F) a.d_dcols[int64_t(level * F + k) * a.batch + b] = dd[k];
  }
  if (a.dx_part != nullptr) {
    float* p = a.dx_part + (int64_t(level) * a.batch + b) * D;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d)
      if (d < D) p[d] = acc[d];
  }
}

}  // namespace

cudaError_t grid_encode_third_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const void* dcols, bool dcols_bf16, const float* ddx, const float* ct_dx,
    const int32_t* level_params, int n_levels, float* d_dcols, float* dx_part, float* d_x,
    float* grad, void* out, bool out_bf16, int64_t n_params, int64_t batch, int n_dims,
    int n_features, int64_t dc_stride_b, int64_t dc_stride_f, const uint32_t hash_factors[7],
    int hash_kind, int interp, bool sharded, cudaStream_t stream) {
  if (batch <= 0 || n_levels <= 0 || n_levels > 65535 || interp < 0 || interp > 2 ||
      x_stride_b < n_dims || (d_x == nullptr) != (dx_part == nullptr) ||
      (grad == nullptr) != (out == nullptr) || (grad != nullptr && n_params <= 0) ||
      (!out_bf16 && out != grad) || n_dims < 1 || n_dims > kMaxDims || n_features < 1 ||
      n_features > 8)
    return cudaErrorInvalidValue;
  const GtParams a{x, level_frac, table, dcols, ddx, ct_dx, level_params, d_dcols, dx_part,
                   grad, batch, x_stride_b, dc_stride_b, dc_stride_f,
                   make_hash_consts(hash_factors, hash_kind), n_levels, n_dims, n_features,
                   interp, table_bf16, dcols_bf16, sharded};
  cudaError_t err = cudaSuccess;
  if (grad != nullptr) err = cudaMemsetAsync(grad, 0, size_t(n_params) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const dim3 blocks(unsigned((batch + kGridThreads - 1) / kGridThreads), unsigned(n_levels));
  grid_encode_third_kernel<<<blocks, kGridThreads, 0, stream>>>(a);
  err = cudaGetLastError();
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

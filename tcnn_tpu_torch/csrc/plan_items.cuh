// The work items of kernel GB's plan (ops/cuda/grid_encode.py::gb_plan) as
// kernels GG (grid_encode_bwd_bwd.cu) and GT (grid_encode_third.cu) run
// them: one CTA per item (level, rows [row_lo, row_lo + n_rows), samples
// [b0, b1)), one thread per (sample, level) of the item, all items of a
// group in one launch.
//  * A window item (n_rows > 0) sums the table-gradient updates of the
//    corners that land in its rows in shared memory and flushes them
//    (scatter_common.cuh); a direct item adds each corner with global
//    atomics, one float4 for the dim-0 pair r, r + 1 (r even) at F = 2.
//    A corner whose weight derivative is 0 adds nothing, so a row that
//    nothing touches stays an exact 0.
//  * Outputs per (sample, level) (d_dcols, d_x's per-level partials): a
//    level cut into two windows has two items over the same samples; only
//    the first part's CTA (row_lo at the level's, or the shard's block's,
//    first row, or a direct item) writes them, so each has one writer.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "scatter_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kItemFields = 5;   // level, row_lo, n_rows (0: direct), b0, b1 (gb_plan)

// Corners whose table rows a thread loads at once: a power of two, at least
// 2 (scatter_pair's dim-0 pairs), at most 2^D, their rows in at most 16
// floats where that allows (more would spill).
template <int D, int F>
__host__ __device__ constexpr int corner_group() {
  int g = 16;
  while (g > 2 && g * F > 16) g /= 2;
  return g < (1 << D) ? g : (1 << D);
}

// The item of this CTA and what the CTA computes of it.
struct PlanItem {
  int level;
  const int32_t* lp;
  uint32_t row_lo, n_rows, offset;
  int64_t b0, b1;
  bool outputs;   // the per-(sample, level) outputs of the item's samples
  bool window;    // the table gradient summed in shared memory

  // items: the launch's items; any_output: an output per (sample, level)
  // is asked for; grad: the table gradient is.
  __device__ __forceinline__ PlanItem(const int32_t* items, const int32_t* level_params,
                                      bool any_output, bool grad) {
    const int32_t* it = items + int64_t(blockIdx.x) * kItemFields;
    level = it[0];
    row_lo = uint32_t(it[1]);
    n_rows = uint32_t(it[2]);
    b0 = it[3];
    b1 = it[4];
    lp = level_params + level * kLevelFields;
    offset = uint32_t(lp[2]);
    // the first part of a windowed level starts at the level's (the
    // shard's block's) first row: held row lp[15] less the row base lp[2]
    const bool first = n_rows == 0 || row_lo == uint32_t(lp[15]) - offset;
    outputs = first && any_output;
    window = n_rows != 0 && grad;
  }

  // A plan kernel's parameters: its items, level_params and outputs
  // (d_dcols, dx_part, grad, each null where not asked for).
  template <typename Params>
  __device__ __forceinline__ explicit PlanItem(const Params& a)
      : PlanItem(a.items, a.level_params, a.d_dcols != nullptr || a.dx_part != nullptr,
                 a.grad != nullptr) {}
};

// Adds the corner pair's updates wp_h * dy (h = 0, 1: corners c, c + 1) of
// one sample to the table gradient: into the window, or by global atomics.
template <int F>
__device__ __forceinline__ void scatter_pair(float* grad, const PlanItem& it, float* win,
                                             const uint32_t (&row)[2], const float (&wp)[2],
                                             const float (&dy)[F]) {
  if (it.window) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t r = row[h] - it.offset - it.row_lo;   // wraps above n_rows below row_lo
      if (wp[h] == 0.0f || r >= it.n_rows) continue;
#pragma unroll
      for (int k = 0; k < F; ++k) window_add(win + r * F + k, __fmul_rn(wp[h], dy[k]));
    }
    return;
  }
  if constexpr (F == 2) {
    if (row[1] == row[0] + 1 && (row[0] & 1) == 0) {   // one 16-byte atomic for the pair
      if (wp[0] != 0.0f || wp[1] != 0.0f) {
        const float v[4] = {__fmul_rn(wp[0], dy[0]), __fmul_rn(wp[0], dy[1]),
                            __fmul_rn(wp[1], dy[0]), __fmul_rn(wp[1], dy[1])};
        global_add<4>(grad + int64_t(row[0]) * 2, v);
      }
      return;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (wp[h] != 0.0f) add_row<F>(grad + int64_t(row[h]) * F, wp[h], dy);
}

// The run-time-D instances' update of one corner, F features at run time:
// into the window, or by global atomics, a float2 per two features where F
// is even, else one per feature.
__device__ __forceinline__ void scatter_one(float* grad, const PlanItem& it, float* win,
                                            uint32_t row, float wp, const float (&dy)[8],
                                            int F) {
  if (wp == 0.0f) return;
  if (it.window) {
    const uint32_t r = row - it.offset - it.row_lo;   // wraps above n_rows below row_lo
    if (r >= it.n_rows) return;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < F) window_add(win + r * F + k, __fmul_rn(wp, dy[k]));
    return;
  }
  float* p = grad + int64_t(row) * F;
  if (F % 2 == 0) {
#pragma unroll
    for (int k = 0; k < 8; k += 2)
      if (k < F) global_add<2>(p + k, {__fmul_rn(wp, dy[k]), __fmul_rn(wp, dy[k + 1])});
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < F) atomicAdd(p + k, __fmul_rn(wp, dy[k]));
  }
}

// Launches `kernel` once per group of the plan (host groups: first item,
// items, window bytes, parts), kThreads a CTA, with p.items at the group's
// first item; a window only where the table gradient is asked for.
template <int kThreads, typename Params, typename Kernel, typename... Args>
cudaError_t launch_groups(Kernel kernel, const Params& a, const int32_t* groups, int n_groups,
                          cudaStream_t stream, Args... args) {
  for (int i = 0; i < n_groups; ++i) {
    const int32_t* g = groups + 4 * i;
    Params p = a;
    p.items = a.items + int64_t(g[0]) * kItemFields;
    const int smem = a.grad ? g[2] : 0;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<g[1], kThreads, smem, stream>>>(p, args...);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// dispatch_df's launch of a plan kernel's 1- to 4-D instances:
// Instance<D, F>::kernel() is the (D, F) instance.
template <int kThreads, typename Params, template <int, int> class Instance>
struct PlanLaunch {
  Params a;
  const int32_t* groups;   // host: (first item, items, window bytes, parts) per launch
  int n_groups;
  cudaStream_t stream;

  template <int D, int F>
  cudaError_t run() const {
    return launch_groups<kThreads>(Instance<D, F>::kernel(), a, groups, n_groups, stream);
  }
};

// The launchers' checks of a plan's groups: items in each, a window within
// one CTA's shared memory, one part (no clusters).
inline bool groups_valid(const int32_t* groups, int n_groups) {
  if (n_groups < 0) return false;
  for (int i = 0; i < n_groups; ++i)
    if (groups[4 * i + 1] <= 0 || groups[4 * i + 2] < 0 ||
        groups[4 * i + 2] > kWindowMaxBytes || groups[4 * i + 3] != 1)
      return false;
  return true;
}

}  // namespace
}  // namespace tcnn_tpu_torch

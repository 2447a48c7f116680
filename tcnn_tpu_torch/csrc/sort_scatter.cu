// Kernels SK and SS: the grid's first-order table gradient by sort and
// segment sum, deterministic by construction.  The counterpart of
// tcnn_tpu/ops/sort_scatter.py::sort_segment_scatter and of the
// TCNN_TPU_SCATTER=sortseg branch of _grid_interpolate_vjp_bwd
// (tcnn_tpu/ops/grid_ops.py:962-977), which the JAX package also takes on
// every GPU backend: "deterministic there too, unlike XLA's atomic GPU
// scatter-add".  Kernel GB (grid_encode_bwd.cu) computes the same sums
// with fp32 atomics, whose order, and so whose last bits, change from run
// to run.
//
// Neither kernel replaces a TPU kernel: JAX forms the route in XLA ops
// (argsort, cumsum, one scatter), outside any pallas_call.  The route is
//   SK: every update (live level l, corner c, sample b), in JAX's (l, c, b)
//       order (idx3.reshape(-1), grid_ops.py:974-977), as an int32 row key
//       and F fp32 values w_c * dy;
//   torch.sort(keys, stable=True): each row's updates stay in that order
//       (the counterpart of jnp.argsort, an XLA op outside any kernel);
//   SS: each row's run of updates summed in sorted order, each touched row
//       written once, no atomics.
//
// SK: one thread per (sample, level), the corners' rows and weights as
// kernel GB computes them (grid_common.cuh: WideCorners, the same f32
// level geometry, __fmul_rn/__fadd_rn rounding, uint32 wrap, fastmod and
// hash kinds; stochastic interpolation's one-hot corner from the uniforms
// u), so that its keys and values equal the plain version's
// (build_indices_weights(scatter=True) and the products) bit for bit.  An
// update that adds nothing, a (sample, level) the per-sample mask drops or
// (shard mode) a corner another rank's shard holds, gets the key n_rows,
// past the last row: it sorts to the end and SS skips it.  Its value is
// 0 * dy, as the plain version forms it.  Bound: it reads x and dcols and
// writes M = L*C*B keys and M*F values; at config_btf (2^18 samples, 16
// levels, 16 corners, F = 2) 768 MB of output, 0.23 ms at 3.35 TB/s.  The
// writes are coalesced: neighbouring threads are neighbouring samples,
// whose updates are neighbours in (l, c, b) order.
//
// SS: given the sorted keys and the sort's permutation `order`, the value
// of sorted position i is vals[order[i]].  The positions are cut into
// spans of kSpan; pass 1, a thread per span, walks its span in order:
//   * the head, the positions that continue a run from the span before,
//     summed into head[s];
//   * each run that starts and ends in the span, summed and written to its
//     row (a run of an invalid key, n_rows or below 0, is skipped);
//   * a run that starts in the span and goes on past its end, summed into
//     tail[s].
// Pass 2, a thread per span whose tail run goes on, adds the heads of the
// spans that follow, in span order, while the run covers them, and writes
// the row.  Every sum runs in one fixed order, so the result has the same
// bits from launch to launch; a coarse row's run of thousands of updates
// (config_hash level 0: about 2^20 updates on fewer than 300 rows) costs
// pass 2 one add per kSpan positions.  No key is searched for on the host,
// so the route stays capturable in a CUDA graph.  The fp32 table is zeroed
// first (a row no update reached stays an exact 0) and, for a bf16 table,
// cast once at the end, as _finish_interp_bwd casts (grid_ops.py:1102).
// Bound: it reads the keys, the permutation and the values once (16 bytes
// an update at F = 2) and writes the table.  The values are gathered
// through the permutation, one random 4F-byte read per update.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

constexpr int kSkThreads = 256;
constexpr int kSsThreads = 256;
constexpr int kSpan = 32;   // sorted positions a thread of SS walks in pass 1

struct SkParams {
  const float* x;
  int64_t x_stride_b;
  const float* level_frac;   // null: no per-sample mask
  int n_levels;
  const void* dcols;
  bool dcols_bf16;
  int64_t dc_stride_b, dc_stride_f;
  const int32_t* level_params;
  HashConsts hc;
  int interp;
  bool sharded;
  const float* u;            // stochastic interpolation's uniforms, or null
  int n_dims, n_features;
  int64_t batch;
  int32_t sentinel;          // the key of an update that adds nothing: n_rows
  int32_t* keys;
  float* vals;
};

// One thread per (sample b, level blockIdx.y).  A sample's features in
// groups of at most 8, each group over every corner again (one group
// where F <= 8); the keys are written with the first group.
__global__ void __launch_bounds__(kSkThreads) sort_keys_kernel(SkParams a) {
  const int level = blockIdx.y;
  const int32_t* lp = a.level_params + level * kLevelFields;
  if (!lp[4]) return;   // a dead level has no updates
  const int64_t b = int64_t(blockIdx.x) * kSkThreads + threadIdx.x;
  if (b >= a.batch) return;
  int p = 0;   // the level's position among the live levels
  for (int k = 0; k < level; ++k) p += a.level_params[k * kLevelFields + 4] != 0;
  const bool keep =
      !a.level_frac || float(level) < level_threshold(a.level_frac[b], a.n_levels);
  const WideCorners lc(lp, a.x + b * a.x_stride_b, a.n_dims, a.interp);
  const int pick = a.u ? lc.stochastic_corner(a.u[int64_t(level) * a.batch + b]) : -1;
  const int C = 1 << a.n_dims, F = a.n_features;
  for (int g0 = 0; g0 < F; g0 += kFeatureGroup) {
    const int nf = min(kFeatureGroup, F - g0);
    float dy[kFeatureGroup];
#pragma unroll
    for (int f = 0; f < kFeatureGroup; ++f)
      dy[f] = f < nf ? load_any(a.dcols, a.dcols_bf16,
                                b * a.dc_stride_b + (int64_t(level) * F + g0 + f) * a.dc_stride_f)
                     : 0.0f;
    for (int c = 0; c < C; ++c) {
      const uint32_t r = lc.row(c, a.hc);
      const bool on = keep && (!a.sharded || shard_owns(lp, r));
      float w = pick < 0 ? lc.weight(c) : (c == pick ? 1.0f : 0.0f);
      if (!on) w = 0.0f;
      const int64_t m = (int64_t(p) * C + c) * a.batch + b;
      if (g0 == 0) a.keys[m] = on ? int32_t(r) : a.sentinel;
      float* v = a.vals + m * F + g0;
#pragma unroll
      for (int f = 0; f < kFeatureGroup; ++f)
        if (f < nf) v[f] = __fmul_rn(w, dy[f]);
    }
  }
}

struct SsParams {
  const int32_t* keys;   // sorted
  const int64_t* order;  // sorted position -> update
  const float* vals;     // (m, n_features), update-major
  int64_t m, n_rows, n_spans;
  int n_features;
  float* head;           // (n_spans, n_features)
  float* tail;           // (n_spans, n_features)
  float* grad;           // (n_rows, n_features), zeroed
};

__device__ __forceinline__ bool valid_row(int32_t key, int64_t n_rows) {
  return key >= 0 && int64_t(key) < n_rows;
}

// Sums features [g0, g0 + nf) of the sorted positions from i while their key
// is `key`, up to `end`, into acc in position order; returns the first
// position past them.  An invalid key's positions are passed over unread.
__device__ __forceinline__ int64_t run_sum(const SsParams& a, int64_t i, int64_t end,
                                           int32_t key, int g0, int nf,
                                           float (&acc)[kFeatureGroup]) {
  const bool sum = valid_row(key, a.n_rows);
  for (; i < end && a.keys[i] == key; ++i) {
    if (!sum) continue;
    const float* v = a.vals + a.order[i] * a.n_features + g0;
#pragma unroll
    for (int f = 0; f < kFeatureGroup; ++f)
      if (f < nf) acc[f] += v[f];
  }
  return i;
}

// Pass 1: a thread per span of kSpan sorted positions.
__global__ void __launch_bounds__(kSsThreads) segment_sum_spans_kernel(SsParams a) {
  const int64_t s = int64_t(blockIdx.x) * kSsThreads + threadIdx.x;
  if (s >= a.n_spans) return;
  const int64_t i0 = s * kSpan, i1 = min(i0 + kSpan, a.m);
  const int F = a.n_features;
  for (int g0 = 0; g0 < F; g0 += kFeatureGroup) {
    const int nf = min(kFeatureGroup, F - g0);
    int64_t i = i0;
    if (s > 0) {   // the head: the run of the span before, going on here
      float acc[kFeatureGroup] = {};
      i = run_sum(a, i, i1, a.keys[i0 - 1], g0, nf, acc);
#pragma unroll
      for (int f = 0; f < kFeatureGroup; ++f)
        if (f < nf) a.head[s * F + g0 + f] = acc[f];
    }
    while (i < i1) {   // the runs that start in this span
      const int32_t key = a.keys[i];
      float acc[kFeatureGroup] = {};
      i = run_sum(a, i, i1, key, g0, nf, acc);
      float* dst = nullptr;
      if (i == i1 && i1 < a.m && a.keys[i1] == key)   // goes on past the span
        dst = a.tail + s * F + g0;
      else if (valid_row(key, a.n_rows))
        dst = a.grad + int64_t(key) * F + g0;
      if (dst) {
#pragma unroll
        for (int f = 0; f < kFeatureGroup; ++f)
          if (f < nf) dst[f] = acc[f];
      }
    }
  }
}

// Pass 2: a thread per span whose last run starts in it and goes on past
// its end: that run's tail, then the heads of the spans it covers, in order.
__global__ void __launch_bounds__(kSsThreads) segment_sum_runs_kernel(SsParams a) {
  const int64_t s = int64_t(blockIdx.x) * kSsThreads + threadIdx.x;
  if (s >= a.n_spans - 1) return;   // the last span's runs all end in it
  const int64_t i0 = s * kSpan, i1 = i0 + kSpan;
  const int32_t key = a.keys[i1 - 1];
  if (a.keys[i1] != key || (s > 0 && a.keys[i0 - 1] == key) || !valid_row(key, a.n_rows))
    return;   // no run goes on, the run is an earlier span's, or it is skipped
  const int F = a.n_features;
  for (int g0 = 0; g0 < F; g0 += kFeatureGroup) {
    const int nf = min(kFeatureGroup, F - g0);
    float acc[kFeatureGroup];
#pragma unroll
    for (int f = 0; f < kFeatureGroup; ++f) acc[f] = f < nf ? a.tail[s * F + g0 + f] : 0.0f;
    for (int64_t k = s + 1; k < a.n_spans; ++k) {
#pragma unroll
      for (int f = 0; f < kFeatureGroup; ++f)
        if (f < nf) acc[f] += a.head[k * F + g0 + f];
      const int64_t end = min((k + 1) * kSpan, a.m);
      if (end == a.m || a.keys[end] != key) break;   // the run ends in span k
    }
#pragma unroll
    for (int f = 0; f < kFeatureGroup; ++f)
      if (f < nf) a.grad[int64_t(key) * F + g0 + f] = acc[f];
  }
}

}  // namespace

cudaError_t sort_keys_launch(const float* x, int64_t x_stride_b, const float* level_frac,
                             const void* dcols, bool dcols_bf16, int64_t dc_stride_b,
                             int64_t dc_stride_f, const int32_t* level_params, int n_levels,
                             int64_t batch, int n_dims, int n_features,
                             const uint32_t hash_factors[7], int hash_kind, int interp,
                             bool sharded, const float* u, int32_t sentinel, int32_t* keys,
                             float* vals, cudaStream_t stream) {
  if (batch < 0 || n_levels <= 0 || n_levels > 65535 || n_dims < 1 || n_dims > kMaxDims ||
      n_features < 1 || interp < 0 || interp > 2 || x_stride_b < n_dims || sentinel < 0 ||
      (sharded && u != nullptr))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const SkParams a{x, x_stride_b, level_frac, n_levels, dcols, dcols_bf16, dc_stride_b,
                   dc_stride_f, level_params, make_hash_consts(hash_factors, hash_kind),
                   interp, sharded, u, n_dims, n_features, batch, sentinel, keys, vals};
  const dim3 grid(unsigned((batch + kSkThreads - 1) / kSkThreads), unsigned(n_levels));
  sort_keys_kernel<<<grid, kSkThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t segment_sum_launch(const int32_t* keys, const int64_t* order, const float* vals,
                               int64_t m, int n_features, int64_t n_rows, float* scratch,
                               float* grad, void* out, bool out_bf16, cudaStream_t stream) {
  if (m < 0 || n_features < 1 || n_rows < 1 || n_rows > INT_MAX || (!out_bf16 && out != grad))
    return cudaErrorInvalidValue;
  const int64_t n = n_rows * n_features;
  cudaError_t err = cudaMemsetAsync(grad, 0, size_t(n) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if (m > 0) {
    const int64_t n_spans = (m + kSpan - 1) / kSpan;
    const SsParams a{keys, order, vals, m, n_rows, n_spans, n_features,
                     scratch, scratch + n_spans * n_features, grad};
    const unsigned blocks = unsigned((n_spans + kSsThreads - 1) / kSsThreads);
    segment_sum_spans_kernel<<<blocks, kSsThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (n_spans > 1) {
      segment_sum_runs_kernel<<<blocks, kSsThreads, 0, stream>>>(a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  if (!out_bf16) return cudaSuccess;
  cast_to_bf16_kernel<<<unsigned((n + kGridThreads - 1) / kGridThreads), kGridThreads, 0,
                        stream>>>(grad, static_cast<__nv_bfloat16*>(out), n);
  return cudaGetLastError();
}

// The scratch of segment_sum_launch: head and tail, n_spans * n_features
// floats each.
int64_t segment_sum_scratch_floats(int64_t m, int n_features) {
  return 2 * ((m + kSpan - 1) / kSpan) * n_features;
}

}  // namespace tcnn_tpu_torch

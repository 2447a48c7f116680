// Kernel RS: row scatter-add,  out[idx[i]*F + k] += g[i, k],  i < M, k < F.
//
// Replaces the TPU's scatter.py::_scatter_kernel (:106), the function of
// scatter_add_rows / scatter_add_rows_flat (zeros((n, F)).at[idx].add(g)),
// and scatter.py::_scatter_cols_kernel (:187), the same with g given as F
// separate (M,) streams (scatter_add_cols).  On the TPU both keep the whole
// gradient table in VMEM in a lane-packed layout and apply the updates one
// by one in a serial scalar loop, deterministic by program order.  g is
// read through two strides, g[i*stride_i + k*stride_k], so row 10's F
// column streams, stacked as an (F, M) tensor, are the same call with
// strides (1, M).  Indices outside [0, n_rows) are skipped, as jnp's
// .at[].add drops those beyond the table.  The fp32 buffer is zeroed
// first and, for a bfloat16 table, cast once at the end.
//
// In the port it is the table gradient of the grid's input gradient: kernel
// GG writes (rows, g) and RS scatters them (the JAX package's transpose of
// its corner re-gather, grid_ops.py:1110-1111).
//
// Bound on the H100: it reads idx and g once (12 bytes an update at F = 2)
// and writes the table: at the SDF shape (2^24 updates, 108 k rows x 2)
// 201 MB + 0.9 MB, about 0.06 ms at 3.35 TB/s.  What held the first
// design (one fp32 atomic per update into L2) at 23x that bound was
// contention: GG writes its updates level by level, and the SDF grid's
// level 0 puts 2^21 updates on 64 rows, which serialise at the L2.  So
// each CTA takes a contiguous chunk of kRsChunk updates, finds the
// chunk's row range [lo, hi] (a block min and max) and, where
// (hi - lo + 1) * F fp32 values fit in its window of kRsWindowBytes of
// shared memory, sums the chunk there with shared atomics and flushes the
// window with one global atomic per nonzero group of V values
// (scatter_common.cuh, shared with kernel GB).  A chunk whose rows spread
// wider takes the direct path: one global atomic per (update, group of V
// features), V = 4 where F allows (float4), else 2 (float2), else 1.  RS
// knows nothing of grid levels: any caller whose chunks are narrow gains.
// The sum order of the atomics varies from run to run: the result matches
// a serial sum only to the fp32 sum-order bound, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"
#include "scatter_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kRsThreads = 512;
constexpr int kRsPerThread = 16;                        // updates a thread holds
constexpr int kRsChunk = kRsThreads * kRsPerThread;     // updates per CTA
constexpr int kRsWindowBytes = 96 * 1024;               // two CTAs per SM

template <int V>
__global__ void __launch_bounds__(kRsThreads)
row_scatter_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g,
                   float* __restrict__ out, int64_t m, int n_features, int64_t n_rows,
                   int64_t g_stride_i, int64_t g_stride_k, int window_floats) {
  extern __shared__ float win[];
  __shared__ int s_lo, s_hi;
  const int tid = threadIdx.x;
  const int64_t i0 = int64_t(blockIdx.x) * kRsChunk;
  // This thread's updates i0 + tid + j * kRsThreads; -1 where out of range.
  int32_t r[kRsPerThread];
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int j = 0; j < kRsPerThread; ++j) {
    const int64_t i = i0 + tid + j * kRsThreads;
    const int32_t v = i < m ? idx[i] : -1;
    r[j] = v >= 0 && v < n_rows ? v : -1;
    if (r[j] >= 0) {
      lo = min(lo, r[j]);
      hi = max(hi, r[j]);
    }
  }
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (tid % 32 == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  lo = s_lo;
  hi = s_hi;
  if (hi < 0) return;  // no update of the chunk lies in the table

  const int groups = n_features / V;
  const auto value = [&](int j, int q, float (&v)[V]) {
    const int64_t i = i0 + tid + j * kRsThreads;
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = g[i * g_stride_i + int64_t(q * V + u) * g_stride_k];
  };
  const int64_t span = int64_t(hi - lo + 1) * n_features;
  if (span <= window_floats) {
    window_zero(win, int(span));
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRsPerThread; ++j) {
      if (r[j] < 0) continue;
      float* p = win + (r[j] - lo) * n_features;
      for (int q = 0; q < groups; ++q) {
        float v[V];
        value(j, q, v);
#pragma unroll
        for (int u = 0; u < V; ++u) window_add(p + q * V + u, v[u]);
      }
    }
    __syncthreads();
    window_flush<V>(win, int(span), out + int64_t(lo) * n_features);
    return;
  }
#pragma unroll
  for (int j = 0; j < kRsPerThread; ++j) {
    if (r[j] < 0) continue;
    for (int q = 0; q < groups; ++q) {
      float v[V];
      value(j, q, v);
      global_add<V>(out + int64_t(r[j]) * n_features + q * V, v);
    }
  }
}

template <int V>
cudaError_t launch_rs(const int32_t* idx, const float* g, float* acc, int64_t m, int n_features,
                      int64_t n_rows, int64_t g_stride_i, int64_t g_stride_k,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(row_scatter_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kRsWindowBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = unsigned((m + kRsChunk - 1) / kRsChunk);
  row_scatter_kernel<V><<<blocks, kRsThreads, kRsWindowBytes, stream>>>(
      idx, g, acc, m, n_features, n_rows, g_stride_i, g_stride_k,
      kRsWindowBytes / int(sizeof(float)));
  return cudaGetLastError();
}

}  // namespace

cudaError_t row_scatter_launch(const int32_t* idx, const float* g, int64_t g_stride_i,
                               int64_t g_stride_k, int64_t m, int n_features, float* acc,
                               void* out, bool out_bf16, int64_t n_rows, cudaStream_t stream) {
  if (m < 0 || n_features <= 0 || n_rows <= 0 || n_rows >= INT_MAX ||
      (!out_bf16 && out != acc))
    return cudaErrorInvalidValue;
  const int64_t n = n_rows * n_features;
  cudaError_t err = cudaMemsetAsync(acc, 0, size_t(n) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if (m > 0) {
    const int v = scatter_vec(n_features);
    err = v == 4   ? launch_rs<4>(idx, g, acc, m, n_features, n_rows, g_stride_i, g_stride_k, stream)
          : v == 2 ? launch_rs<2>(idx, g, acc, m, n_features, n_rows, g_stride_i, g_stride_k, stream)
                   : launch_rs<1>(idx, g, acc, m, n_features, n_rows, g_stride_i, g_stride_k, stream);
    if (err != cudaSuccess) return err;
  }
  if (!out_bf16) return cudaSuccess;
  cast_to_bf16_kernel<<<unsigned((n + kGridThreads - 1) / kGridThreads), kGridThreads, 0,
                        stream>>>(acc, static_cast<__nv_bfloat16*>(out), n);
  return cudaGetLastError();
}

}  // namespace tcnn_tpu_torch

// Kernel RS: row scatter-add,  out[idx[i]*F + k] += g[i, k],  i < M, k < F.
//
// Replaces the TPU's scatter.py::_scatter_kernel (:106), the function of
// scatter_add_rows / scatter_add_rows_flat (zeros((n, F)).at[idx].add(g)),
// and scatter.py::_scatter_cols_kernel (:187), the same with g given as F
// separate (M,) streams (scatter_add_cols).  On the TPU both keep the whole
// gradient table in VMEM in a lane-packed layout and apply the updates one
// by one in a serial scalar loop, deterministic by program order.  Here the
// updates run in parallel with fp32 atomics into an L2-resident buffer:
// one thread per (update, group of V features), V = 4 where F allows
// (one float4 atomic), else 2 (float2), else 1.  g is read through two
// strides, g[i*stride_i + k*stride_k], so row 10's F column streams, stacked
// as an (F, M) tensor, are the same call with strides (1, M).  The sum
// order of the atomics varies from run to run: the result matches a serial
// sum only to the fp32 sum-order bound, not bit for bit.  Indices outside
// [0, n_rows) are skipped, as jnp's .at[].add drops those beyond the
// table.  The fp32 buffer is zeroed first and, for a bfloat16 table, cast
// once at the end.
//
// In the port it is the table gradient of the grid's input gradient: kernel
// GG writes (rows, g) and RS scatters them (the JAX package's transpose of
// its corner re-gather, grid_ops.py:1110-1111).
//
// Bound on the H100: it reads idx and g once (12 bytes an update at F = 2)
// and writes the table: at the SDF shape (2^24 updates, 108 k rows x 2)
// 201 MB + 0.9 MB, about 0.06 ms at 3.35 TB/s.  The atomics land in L2;
// a row of a coarse level takes thousands of them and they contend.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

template <int V>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[V]) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    return;
  } else if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#endif
#pragma unroll
  for (int q = 0; q < V; ++q) atomicAdd(p + q, v[q]);
}

template <int V>
__global__ void __launch_bounds__(kGridThreads)
row_scatter_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g,
                   float* __restrict__ out, int64_t m, int n_features, int64_t n_rows,
                   int64_t g_stride_i, int64_t g_stride_k) {
  const int groups = n_features / V;
  const int64_t t = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (t >= m * groups) return;
  const int64_t i = t / groups;
  const int k0 = int(t - i * groups) * V;
  const int64_t r = idx[i];
  if (r < 0 || r >= n_rows) return;
  float v[V];
#pragma unroll
  for (int q = 0; q < V; ++q) v[q] = g[i * g_stride_i + int64_t(k0 + q) * g_stride_k];
  add_vec<V>(out + r * n_features + k0, v);
}

}  // namespace

cudaError_t row_scatter_launch(const int32_t* idx, const float* g, int64_t g_stride_i,
                               int64_t g_stride_k, int64_t m, int n_features, float* acc,
                               void* out, bool out_bf16, int64_t n_rows, cudaStream_t stream) {
  if (m < 0 || n_features <= 0 || n_rows <= 0 || (!out_bf16 && out != acc))
    return cudaErrorInvalidValue;
  const int64_t n = n_rows * n_features;
  cudaError_t err = cudaMemsetAsync(acc, 0, size_t(n) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if (m > 0) {
    const int v = n_features % 4 == 0 ? 4 : n_features % 2 == 0 ? 2 : 1;
    const int64_t threads = m * (n_features / v);
    const unsigned blocks = unsigned((threads + kGridThreads - 1) / kGridThreads);
    if (v == 4)
      row_scatter_kernel<4><<<blocks, kGridThreads, 0, stream>>>(
          idx, g, acc, m, n_features, n_rows, g_stride_i, g_stride_k);
    else if (v == 2)
      row_scatter_kernel<2><<<blocks, kGridThreads, 0, stream>>>(
          idx, g, acc, m, n_features, n_rows, g_stride_i, g_stride_k);
    else
      row_scatter_kernel<1><<<blocks, kGridThreads, 0, stream>>>(
          idx, g, acc, m, n_features, n_rows, g_stride_i, g_stride_k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!out_bf16) return cudaSuccess;
  cast_to_bf16_kernel<<<unsigned((n + kGridThreads - 1) / kGridThreads), kGridThreads, 0,
                        stream>>>(acc, static_cast<__nv_bfloat16*>(out), n);
  return cudaGetLastError();
}

}  // namespace tcnn_tpu_torch

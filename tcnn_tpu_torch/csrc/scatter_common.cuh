// On-chip accumulation shared by the scatter kernels RS (row_scatter.cu),
// GB (grid_encode_bwd.cu), GG (grid_encode_bwd_bwd.cu) and GT
// (grid_encode_third.cu).
//
// Both add many fp32 updates into rows of a table in device memory, and on
// the coarse rows thousands of updates land on one address, where fp32
// atomics in L2 serialise.  So a CTA first sums its updates of a range of
// rows, its window, in shared memory: window_zero, window_add (a shared
// atomic, or a remote one into another CTA of the cluster, whose window
// holds the row), and window_flush, which adds the window into the table
// with one global atomic per group of V values that holds a nonzero one.
// A row that no update reached is never written, so it stays an exact 0
// (Adam's lazy step counters rely on that).  The kernels differ only in
// how an update's row and value are formed.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tcnn_tpu_torch {
namespace {

// Shared memory one CTA may take on sm_90 (dynamic, after
// cudaFuncAttributeMaxDynamicSharedMemorySize).
constexpr int kWindowMaxBytes = 232448;

// Values per global atomic for rows of F features: 4 (float4) where F
// allows it, else 2 (float2), else 1.
__host__ __device__ constexpr int scatter_vec(int f) { return f % 4 == 0 ? 4 : f % 2 == 0 ? 2 : 1; }

// p[0, V) += v in device memory: one vector atomic on sm_90 (p 4V-byte
// aligned), else V scalar ones.
template <int V>
__device__ __forceinline__ void global_add(float* p, const float (&v)[V]) {
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

// p[0, F) += w * dy in device memory, F / V atomics of V values
// (scatter_vec), each product rounded once.
template <int F>
__device__ __forceinline__ void add_row(float* p, float w, const float (&dy)[F]) {
  constexpr int V = scatter_vec(F);
#pragma unroll
  for (int q = 0; q < F / V; ++q) {
    float v[V];
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = __fmul_rn(w, dy[q * V + u]);
    global_add<V>(p + q * V, v);
  }
}

// win[0, n) = 0.
__device__ __forceinline__ void window_zero(float* win, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) win[i] = 0.0f;
}

// *p += v, p in this CTA's window or, through a pointer that
// cooperative_groups' map_shared_rank gave, in another CTA's of the cluster.
__device__ __forceinline__ void window_add(float* p, float v) { atomicAdd(p, v); }

// dst[0, n) += win[0, n), n a multiple of V and dst 4V-byte aligned: one
// V-wide global atomic per group of V values that holds a nonzero value.
template <int V>
__device__ __forceinline__ void window_flush(const float* win, int n, float* dst) {
  for (int i = threadIdx.x * V; i < n; i += blockDim.x * V) {
    float v[V];
    bool any = false;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      v[q] = win[i + q];
      any |= v[q] != 0.0f;
    }
    if (any) global_add<V>(dst + i, v);
  }
}

}  // namespace
}  // namespace tcnn_tpu_torch

// Kernel G: multiresolution grid encoding, forward.
//
// Replaces the TPU's grid_matmul.py::_gather_kernel (:861) and
// grid_matmul.py::_gather_kernel_xor (:734), together with the XLA ops
// that built their inputs (grid_ops.py::_build_indices_weights).  Both
// TPU kernels compute cols[l*F+f, b] = sum_c w_c(b) * table[idx_c(b), f];
// on the TPU that gather had to be a one-hot matmul on the MXU, routed
// per level by size.  Hopper gathers directly, so one kernel covers every
// level: no per-level routing, no packing, no XOR pairing.
//
// Design: one thread per (sample, level); blockIdx.y is the level, so a
// warp shares the level constants and writes 32 consecutive samples of an
// SoA output row.  Each thread builds its 2^D corner indices and weights
// in registers, reads the 2^D table rows (one vector load per row when
// F*sizeof(T) is 4, 8 or 16 bytes), accumulates the F features in fp32
// and writes them in the table's dtype.  Table values are read exactly;
// the TPU's two-term bf16 split of f32 tables is not copied.  x is read
// through a row stride, so a column slice of a wider input (the grid's
// part of a Composite encoding) is read in place.
//
// Bound on the H100: at the config_hash shape (B = 2^18, 16 levels, F = 2,
// bf16 table of 1.4 MB) the function moves about 19.4 MB to and from
// device memory (2 MB of x, 1.4 MB of table, 16 MB of output), about
// 6 us at 3.35 TB/s.  Its 16.8 M random 4-byte row reads hit a table that
// stays in the 50 MB L2, so the kernel is bound by L2 sector traffic and
// by the integer work of the hash and the modulo, not by DRAM.
//
// The index and weight arithmetic, and the hazards it handles, are in
// grid_common.cuh, shared with the backward kernel GB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

// The F features of one table row, as fp32.
template <typename T, int F>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&v)[F]) {
  constexpr int kBytes = F * int(sizeof(T));
  if constexpr (kBytes == 4 || kBytes == 8 || kBytes == 16) {
    using V = std::conditional_t<kBytes == 4, unsigned int,
                                 std::conditional_t<kBytes == 8, uint2, uint4>>;
    const V raw = __ldg(reinterpret_cast<const V*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = to_f32(e[f]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = to_f32(p[f]);
  }
}

template <typename T, int D, int F>
__global__ void __launch_bounds__(kGridThreads)
grid_encode_fwd_kernel(const float* __restrict__ x, const T* __restrict__ table,
                       const int32_t* __restrict__ level_params,
                       T* __restrict__ out, int64_t batch, int64_t x_stride_b,
                       int64_t out_stride_b, int64_t out_stride_f, HashConsts hc,
                       int interp) {
  const int level = blockIdx.y;
  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (b >= batch) return;
  const int32_t* lp = level_params + level * kLevelFields;
  T* o = out + b * out_stride_b + int64_t(level) * F * out_stride_f;

  if (lp[4] == 0) {  // at or above max_level: zeros
#pragma unroll
    for (int f = 0; f < F; ++f) o[f * out_stride_f] = from_f32<T>(0.0f);
    return;
  }
  const LevelCorners<D> lc(lp, x + b * x_stride_b, interp);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    const float w = lc.weight(c);
    float v[F];
    load_row<T, F>(table + int64_t(lc.row(c, hc)) * F, v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[f]));
  }
#pragma unroll
  for (int f = 0; f < F; ++f) o[f * out_stride_f] = from_f32<T>(acc[f]);
}

template <typename T>
struct FwdLaunch {
  const float* x;
  const void* table;
  const int32_t* level_params;
  void* out;
  int64_t batch;
  int n_levels;
  int64_t x_stride_b, out_stride_b, out_stride_f;
  HashConsts hc;
  int interp;
  cudaStream_t stream;

  template <int D, int F>
  cudaError_t run() const {
    const dim3 grid(unsigned((batch + kGridThreads - 1) / kGridThreads), unsigned(n_levels));
    grid_encode_fwd_kernel<T, D, F><<<grid, kGridThreads, 0, stream>>>(
        x, static_cast<const T*>(table), level_params, static_cast<T*>(out), batch,
        x_stride_b, out_stride_b, out_stride_f, hc, interp);
    return cudaSuccess;
  }
};

}  // namespace

cudaError_t grid_encode_fwd_launch(
    const float* x, int64_t x_stride_b, const void* table, bool table_bf16,
    const int32_t* level_params, void* out, int64_t batch, int n_dims,
    int n_levels, int n_features, int64_t out_stride_b, int64_t out_stride_f,
    const uint32_t hash_factors[4], bool coherent_add, int interp,
    cudaStream_t stream) {
  if (batch <= 0 || n_levels <= 0 || n_levels > 65535 || interp < 0 || interp > 2 ||
      x_stride_b < n_dims)
    return cudaErrorInvalidValue;
  HashConsts hc;
  for (int d = 0; d < 4; ++d) hc.factors[d] = hash_factors[d];
  hc.coherent_add = coherent_add ? 1 : 0;
  if (table_bf16)
    return dispatch_df(n_dims, n_features,
                       FwdLaunch<__nv_bfloat16>{x, table, level_params, out, batch, n_levels,
                                                x_stride_b, out_stride_b, out_stride_f, hc,
                                                interp, stream});
  return dispatch_df(n_dims, n_features,
                     FwdLaunch<float>{x, table, level_params, out, batch, n_levels,
                                      x_stride_b, out_stride_b, out_stride_f, hc, interp,
                                      stream});
}

}  // namespace tcnn_tpu_torch

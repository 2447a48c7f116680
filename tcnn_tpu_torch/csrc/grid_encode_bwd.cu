// Kernel GB: multiresolution grid encoding, backward (the table gradient).
//
// Replaces the TPU's grid_matmul.py::_scatter_kernel (:204) and
// grid_matmul.py::_scatter_kernel_xor (:602), the one-hot matmul scatters
// of levels of at most 2^16 rows, and scatter.py::_weighted_kernel (:392)
// and scatter.py::_pair_kernel (:576), the serial scatters that the JAX
// package routes larger levels to (grid_ops.py:705-727, :1030-1061):
// _pair_kernel for dense and CoherentAdd levels, which adds both dim-0
// corners of a pair at once, _weighted_kernel for the others.  All four
// compute
//   dtable[idx_c(b, l), f] += w_c(b, l) * dcols[l*F+f, b]
// for every sample b, live level l and corner c, accumulated in fp32 and
// cast once to the table's dtype (grid_ops.py:1099-1102 of the JAX
// package).  On the TPU a scatter had to be a one-hot matmul per level;
// here it is the CUDA original's kernel_grid_backward (grid.h:214-320):
// one thread per (sample, level) recomputes the corner rows and weights
// exactly as kernel G does (grid_common.cuh: the same __fmul_rn/__fadd_rn
// rounding, fastmod and (uint32)(int)floorf), so the gradient lands on the
// rows the forward read, and adds w*dy into an fp32 buffer with atomics
// (one float2 atomic per corner for F = 2, float4 for F = 4).  Each
// product w*dy is exact fp32; the TPU's bf16 rounding of every product
// (_scatter_kernel at one value pass, grid_matmul.py:238-240) is not
// copied.  The sum order of the atomics varies from run to run, so the
// result is not bit-reproducible; a row that nothing touches stays an
// exact zero, which Adam's lazy step counters rely on.
//
// dcols is read through strides, as float32 or bfloat16: SoA (L*F, B), the
// layout kernel MB writes its input gradient in for a grid alone, or the
// transpose of a column slice of MB's AoS (B, 40) input gradient behind a
// Composite encoding.  x is read through a row stride, so a column slice
// of a wider input needs no copy.
//
// The pair kernel's level wrap (grid_ops.py:1041-1060: an even corner on a
// level's last row puts its odd corner on the level's first row) needs no
// fix-up here: each corner's row is computed on its own, and the additive
// hash taken mod the level size already lands there.  Indices: a corner's
// row is a uint32 (a level holds at most 2^31 rows, grid_ops.py), its
// element offset row * F is formed in 64 bits, the shared-memory test
// size * F in 64 bits, and a level is dense only where its spec says so
// (a 2^19-row 4-D level is hashed: its dense stride would exceed it).
//
// Bound on the H100: at the config_hash shape (B = 2^18, 16 levels, F = 2,
// bf16 table) the function reads x (2.1 MB) and dcols (16.8 MB) and writes
// the 1.4 MB bf16 gradient: 20.3 MB, 6.1 us at 3.35 TB/s (the 2.8 MB fp32
// buffer it zeroes and reads back is its own, 5.7 MB more).  Its float2
// atomics land in L2; on the coarse dense levels (level 0 has 256 rows
// taking 2^20 updates) they contend for the same addresses, so levels of
// at most kSharedFloats values are first summed per CTA in shared memory.
// At the config_btf shape (4-D, B = 2^18, 16 levels of up to 2^19 rows,
// 15.47 M values) the 2^26 float2 atomics scatter at random into a 62 MB
// fp32 buffer, more than the 50 MB L2, and no level takes the
// shared-memory path (PERF.md has its time, about 57x its bound).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

template <int F>
__device__ __forceinline__ void add_row(float* p, float w, const float (&dy)[F]) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(__fmul_rn(w, dy[0]), __fmul_rn(w, dy[1])));
  } else if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(__fmul_rn(w, dy[0]), __fmul_rn(w, dy[1]), __fmul_rn(w, dy[2]),
                          __fmul_rn(w, dy[3])));
  } else
#endif
  {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(p + f, __fmul_rn(w, dy[f]));
  }
}

template <typename TG, int F>
__device__ __forceinline__ void load_dy(const TG* dcols, int64_t b, int level,
                                        int64_t dc_stride_b, int64_t dc_stride_f,
                                        float (&dy)[F]) {
  const TG* d = dcols + b * dc_stride_b + int64_t(level) * F * dc_stride_f;
#pragma unroll
  for (int f = 0; f < F; ++f) dy[f] = to_f32(d[f * dc_stride_f]);
}

// A level of at most kSharedFloats gradient values (size * F) is summed per
// CTA in shared memory over a chunk of kSharedChunk samples, then added to
// the fp32 buffer once per nonzero value: the coarse dense levels' rows
// take thousands of updates each, and direct atomics on them contend.
constexpr int kSharedFloats = 4096;   // 16 KB
constexpr int kSharedChunk = 4096;

template <typename TG, int D, int F>
__global__ void __launch_bounds__(kGridThreads)
grid_encode_bwd_kernel(const float* __restrict__ x, const TG* __restrict__ dcols,
                       const int32_t* __restrict__ level_params, float* __restrict__ grad,
                       int64_t batch, int64_t x_stride_b, int64_t dc_stride_b,
                       int64_t dc_stride_f, HashConsts hc, int interp) {
  __shared__ float acc[kSharedFloats];
  const int level = blockIdx.y;
  const int32_t* lp = level_params + level * kLevelFields;
  if (lp[4] == 0) return;  // at or above max_level: zero gradient
  float dy[F];

  const uint32_t size = uint32_t(lp[1]), offset = uint32_t(lp[2]);
  if (uint64_t(size) * F <= kSharedFloats) {
    const int64_t b0 = int64_t(blockIdx.x) * kSharedChunk;
    if (b0 >= batch) return;  // the level's chunks are covered by fewer CTAs
    const int n = int(size) * F;
    for (int i = threadIdx.x; i < n; i += kGridThreads) acc[i] = 0.0f;
    __syncthreads();
    const int64_t b1 = b0 + kSharedChunk < batch ? b0 + kSharedChunk : batch;
    for (int64_t b = b0 + threadIdx.x; b < b1; b += kGridThreads) {
      load_dy(dcols, b, level, dc_stride_b, dc_stride_f, dy);
      const LevelCorners<D> lc(lp, x + b * x_stride_b, interp);
#pragma unroll
      for (int c = 0; c < (1 << D); ++c) {
        const float w = lc.weight(c);
        if (w == 0.0f) continue;
        float* p = acc + (lc.row(c, hc) - offset) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(p + f, __fmul_rn(w, dy[f]));
      }
    }
    __syncthreads();
    float* g = grad + int64_t(offset) * F;
    for (int i = threadIdx.x; i < n; i += kGridThreads)
      if (acc[i] != 0.0f) atomicAdd(g + i, acc[i]);
    return;
  }

  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (b >= batch) return;
  load_dy(dcols, b, level, dc_stride_b, dc_stride_f, dy);
  const LevelCorners<D> lc(lp, x + b * x_stride_b, interp);
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    const float w = lc.weight(c);
    if (w != 0.0f) add_row<F>(grad + int64_t(lc.row(c, hc)) * F, w, dy);
  }
}

template <typename TG>
struct BwdLaunch {
  const float* x;
  const void* dcols;
  const int32_t* level_params;
  float* grad;
  int64_t batch;
  int n_levels;
  int64_t x_stride_b, dc_stride_b, dc_stride_f;
  HashConsts hc;
  int interp;
  cudaStream_t stream;

  template <int D, int F>
  cudaError_t run() const {
    const dim3 grid(unsigned((batch + kGridThreads - 1) / kGridThreads), unsigned(n_levels));
    grid_encode_bwd_kernel<TG, D, F><<<grid, kGridThreads, 0, stream>>>(
        x, static_cast<const TG*>(dcols), level_params, grad, batch, x_stride_b,
        dc_stride_b, dc_stride_f, hc, interp);
    return cudaGetLastError();
  }
};

}  // namespace

cudaError_t grid_encode_bwd_launch(
    const float* x, int64_t x_stride_b, const void* dcols, bool dcols_bf16,
    const int32_t* level_params, float* grad, void* out, bool out_bf16, int64_t n_params,
    int64_t batch, int n_dims, int n_levels, int n_features, int64_t dc_stride_b,
    int64_t dc_stride_f, const uint32_t hash_factors[4], bool coherent_add,
    int interp, cudaStream_t stream) {
  if (batch <= 0 || n_params <= 0 || n_levels <= 0 || n_levels > 65535 || interp < 0 ||
      interp > 2 || x_stride_b < n_dims || (!out_bf16 && out != grad))
    return cudaErrorInvalidValue;
  HashConsts hc;
  for (int d = 0; d < 4; ++d) hc.factors[d] = hash_factors[d];
  hc.coherent_add = coherent_add ? 1 : 0;

  cudaError_t err = cudaMemsetAsync(grad, 0, size_t(n_params) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  err = dcols_bf16
      ? dispatch_df(n_dims, n_features,
                    BwdLaunch<__nv_bfloat16>{x, dcols, level_params, grad, batch, n_levels,
                                             x_stride_b, dc_stride_b, dc_stride_f, hc, interp,
                                             stream})
      : dispatch_df(n_dims, n_features,
                    BwdLaunch<float>{x, dcols, level_params, grad, batch, n_levels,
                                     x_stride_b, dc_stride_b, dc_stride_f, hc, interp,
                                     stream});
  if (err != cudaSuccess || !out_bf16) return err;
  cast_to_bf16_kernel<<<unsigned((n_params + kGridThreads - 1) / kGridThreads), kGridThreads,
                        0, stream>>>(grad, static_cast<__nv_bfloat16*>(out), n_params);
  return cudaGetLastError();
}

}  // namespace tcnn_tpu_torch

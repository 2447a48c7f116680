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
// the TPU's two-term bf16 split of f32 tables is not copied.
//
// Bound on the H100: at the config_hash shape (B = 2^18, 16 levels, F = 2,
// bf16 table of 1.4 MB) the function moves about 19.4 MB to and from
// device memory (2 MB of x, 1.4 MB of table, 16 MB of output), about
// 6 us at 3.35 TB/s.  Its 16.8 M random 4-byte row reads hit a table that
// stays in the 50 MB L2, so the kernel is bound by L2 sector traffic and
// by the integer work of the hash and the modulo, not by DRAM.
//
// Hazards handled here:
//  * fused multiply-add: pos = x*scale + 0.5 must round twice, like the
//    JAX package's separate multiply and add, or a sample near a cell
//    border changes cell.  __fmul_rn/__fadd_rn are never contracted.
//  * uint32 arithmetic wraps natively; negative coordinates go through
//    (uint32_t)(int)floorf, as in grid_ops.py:508-510.
//  * out-of-range rows: idx % size + offset stays inside the table only if
//    the table has the spec's size; the Python wrapper checks that, since
//    this kernel, unlike jnp.take, does not clamp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kLevelFields = 12;  // ops/grid_ops.py::level_params

struct HashConsts {
  uint32_t factors[4];
  int coherent_add;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// h % size without a division (Lemire, Kaser & Kurz, 2019): exact for
// every 32-bit h and size, with magic = floor((2^64 - 1) / size) + 1.
// Two 64-bit multiplies replace the ~20-instruction 32-bit division that
// four corners x every level would otherwise pay.
__device__ __forceinline__ uint32_t fastmod(uint32_t h, uint64_t magic, uint32_t size) {
  return uint32_t(__umul64hi(magic * h, uint64_t(size)));
}

__device__ __forceinline__ float interp_weight(float f, int interp) {
  if (interp == 1) return f;                                     // Linear
  if (interp == 2)                                               // Smoothstep
    return __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
  return f > 0.5f ? 1.0f : 0.0f;                                 // Nearest
}

template <typename T, int D, int F>
__global__ void __launch_bounds__(kThreads)
grid_encode_fwd_kernel(const float* __restrict__ x, const T* __restrict__ table,
                       const int32_t* __restrict__ level_params,
                       T* __restrict__ out, int64_t batch, int64_t out_stride_b,
                       int64_t out_stride_f, HashConsts hc, int interp) {
  const int level = blockIdx.y;
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= batch) return;
  const int32_t* lp = level_params + level * kLevelFields;
  T* o = out + b * out_stride_b + int64_t(level) * F * out_stride_f;

  if (lp[4] == 0) {  // at or above max_level: zeros
#pragma unroll
    for (int f = 0; f < F; ++f) o[f * out_stride_f] = from_f32<T>(0.0f);
    return;
  }
  const float scale = __int_as_float(lp[0]);
  const uint32_t size = uint32_t(lp[1]);
  const uint32_t offset = uint32_t(lp[2]);
  const bool use_hash = lp[3] != 0;
  const int stride_mask = lp[5];
  const uint64_t magic = (uint64_t(uint32_t(lp[11])) << 32) | uint32_t(lp[10]);

  uint32_t cell[D];
  float w1[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[b * D + d], scale), 0.5f);
    const float cf = floorf(pos);
    cell[d] = uint32_t(int(cf));
    w1[d] = interp_weight(__fsub_rn(pos, cf), interp);
  }

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    float w = (c & 1) ? w1[0] : __fsub_rn(1.0f, w1[0]);
#pragma unroll
    for (int d = 1; d < D; ++d)
      w = __fmul_rn(w, ((c >> d) & 1) ? w1[d] : __fsub_rn(1.0f, w1[d]));

    uint32_t h = 0;
    if (use_hash) {
      if (hc.coherent_add) {
#pragma unroll
        for (int d = 1; d < D; ++d) h ^= (cell[d] + ((c >> d) & 1)) * hc.factors[d];
        h += cell[0] + (c & 1);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) h ^= (cell[d] + ((c >> d) & 1)) * hc.factors[d];
      }
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if ((stride_mask >> d) & 1)
          h += (cell[d] + ((c >> d) & 1)) * uint32_t(lp[6 + d]);
    }
    const uint32_t row = fastmod(h, magic, size) + offset;

    float v[F];
    load_row<T, F>(table + int64_t(row) * F, v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[f]));
  }
#pragma unroll
  for (int f = 0; f < F; ++f) o[f * out_stride_f] = from_f32<T>(acc[f]);
}

template <typename T, int D, int F>
cudaError_t launch(const float* x, const void* table, const int32_t* level_params,
                   void* out, int64_t batch, int n_levels, int64_t out_stride_b,
                   int64_t out_stride_f, const HashConsts& hc, int interp,
                   cudaStream_t stream) {
  const dim3 grid(unsigned((batch + kThreads - 1) / kThreads), unsigned(n_levels));
  grid_encode_fwd_kernel<T, D, F><<<grid, kThreads, 0, stream>>>(
      x, static_cast<const T*>(table), level_params, static_cast<T*>(out), batch,
      out_stride_b, out_stride_f, hc, interp);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_f(int n_features, const float* x, const void* table,
                     const int32_t* lp, void* out, int64_t batch, int n_levels,
                     int64_t sb, int64_t sf, const HashConsts& hc, int interp,
                     cudaStream_t s) {
  switch (n_features) {
    case 1: return launch<T, D, 1>(x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 2: return launch<T, D, 2>(x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 3: return launch<T, D, 3>(x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 4: return launch<T, D, 4>(x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 5: return launch<T, D, 5>(x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 6: return launch<T, D, 6>(x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 7: return launch<T, D, 7>(x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 8: return launch<T, D, 8>(x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int n_dims, int n_features, const float* x, const void* table,
                     const int32_t* lp, void* out, int64_t batch, int n_levels,
                     int64_t sb, int64_t sf, const HashConsts& hc, int interp,
                     cudaStream_t s) {
  switch (n_dims) {
    case 1: return launch_f<T, 1>(n_features, x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 2: return launch_f<T, 2>(n_features, x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 3: return launch_f<T, 3>(n_features, x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    case 4: return launch_f<T, 4>(n_features, x, table, lp, out, batch, n_levels, sb, sf, hc, interp, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t grid_encode_fwd_launch(
    const float* x, const void* table, bool table_bf16,
    const int32_t* level_params, void* out, int64_t batch, int n_dims,
    int n_levels, int n_features, int64_t out_stride_b, int64_t out_stride_f,
    const uint32_t hash_factors[4], bool coherent_add, int interp,
    cudaStream_t stream) {
  if (batch <= 0 || n_levels <= 0 || n_levels > 65535 || interp < 0 || interp > 2)
    return cudaErrorInvalidValue;
  HashConsts hc;
  for (int d = 0; d < 4; ++d) hc.factors[d] = hash_factors[d];
  hc.coherent_add = coherent_add ? 1 : 0;
  if (table_bf16)
    return launch_d<__nv_bfloat16>(n_dims, n_features, x, table, level_params, out,
                                   batch, n_levels, out_stride_b, out_stride_f, hc,
                                   interp, stream);
  return launch_d<float>(n_dims, n_features, x, table, level_params, out, batch,
                         n_levels, out_stride_b, out_stride_f, hc, interp, stream);
}

}  // namespace tcnn_tpu_torch

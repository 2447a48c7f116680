// Index and weight arithmetic shared by the grid kernels G
// (grid_encode.cu, forward) and GB (grid_encode_bwd.cu, backward), so
// that the backward scatters to exactly the rows, with exactly the
// weights, that the forward gathered from.
//
// Hazards handled here:
//  * fused multiply-add: pos = x*scale + 0.5 must round twice, like the
//    JAX package's separate multiply and add, or a sample near a cell
//    border changes cell.  __fmul_rn/__fadd_rn are never contracted.
//  * uint32 arithmetic wraps natively; negative coordinates go through
//    (uint32_t)(int)floorf, as in grid_ops.py:508-510.
//  * out-of-range rows: idx % size + offset stays inside the table only if
//    the table has the spec's size; the Python wrappers check that, since
//    these kernels, unlike jnp.take, do not clamp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tcnn_tpu_torch {
namespace {

constexpr int kGridThreads = 256;
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

// One sample's cell and per-dim weights on one level, and from them the
// table row and interpolation weight of each of its 2^D corners.
template <int D>
struct LevelCorners {
  const int32_t* lp;  // the level's kLevelFields constants
  uint32_t size, offset;
  bool use_hash;
  int stride_mask;
  uint64_t magic;
  uint32_t cell[D];
  float w1[D];

  __device__ __forceinline__ LevelCorners(const int32_t* level_params, const float* xb,
                                          int interp)
      : lp(level_params) {
    const float scale = __int_as_float(lp[0]);
    size = uint32_t(lp[1]);
    offset = uint32_t(lp[2]);
    use_hash = lp[3] != 0;
    stride_mask = lp[5];
    magic = (uint64_t(uint32_t(lp[11])) << 32) | uint32_t(lp[10]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float pos = __fadd_rn(__fmul_rn(xb[d], scale), 0.5f);
      const float cf = floorf(pos);
      cell[d] = uint32_t(int(cf));
      w1[d] = interp_weight(__fsub_rn(pos, cf), interp);
    }
  }

  __device__ __forceinline__ float weight(int c) const {
    float w = (c & 1) ? w1[0] : __fsub_rn(1.0f, w1[0]);
#pragma unroll
    for (int d = 1; d < D; ++d)
      w = __fmul_rn(w, ((c >> d) & 1) ? w1[d] : __fsub_rn(1.0f, w1[d]));
    return w;
  }

  __device__ __forceinline__ uint32_t row(int c, const HashConsts& hc) const {
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
    return fastmod(h, magic, size) + offset;
  }
};

// Template dispatch over the runtime (D, F) of a launch: calls
// Launch::template run<D, F>() for D in 1..4 and F in 1..8.
template <typename Launch, int D>
cudaError_t dispatch_f(int n_features, const Launch& l) {
  switch (n_features) {
    case 1: return l.template run<D, 1>();
    case 2: return l.template run<D, 2>();
    case 3: return l.template run<D, 3>();
    case 4: return l.template run<D, 4>();
    case 5: return l.template run<D, 5>();
    case 6: return l.template run<D, 6>();
    case 7: return l.template run<D, 7>();
    case 8: return l.template run<D, 8>();
    default: return cudaErrorInvalidValue;
  }
}

template <typename Launch>
cudaError_t dispatch_df(int n_dims, int n_features, const Launch& l) {
  switch (n_dims) {
    case 1: return dispatch_f<Launch, 1>(n_features, l);
    case 2: return dispatch_f<Launch, 2>(n_features, l);
    case 3: return dispatch_f<Launch, 3>(n_features, l);
    case 4: return dispatch_f<Launch, 4>(n_features, l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tcnn_tpu_torch

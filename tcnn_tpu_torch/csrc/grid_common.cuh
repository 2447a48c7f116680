// Index and weight arithmetic shared by the grid kernels G
// (grid_encode.cu, forward), GB (grid_encode_bwd.cu, backward), GI
// (grid_encode_bwd_input.cu, the input gradient) and GG
// (grid_encode_bwd_bwd.cu, second order), so that every backward reads and
// scatters exactly the rows, with exactly the weights, that the forward
// gathered from.
//
// Hazards handled here:
//  * fused multiply-add: pos = x*scale + 0.5 must round twice, like the
//    JAX package's separate multiply and add, or a sample near a cell
//    border changes cell.  __fmul_rn/__fadd_rn are never contracted.  The
//    same holds for the per-sample level cutoff (level_threshold).
//  * uint32 arithmetic wraps natively; negative coordinates go through
//    (uint32_t)(int)floorf, as in grid_ops.py:508-510.
//  * out-of-range rows: idx % size + offset stays inside the table only if
//    the table has the spec's size; the Python wrappers check that, since
//    these kernels, unlike jnp.take, do not clamp.
//  * weight derivatives: floor has zero derivative, so d fract / dx is the
//    level's f32 scale; the per-dim derivatives are the closed forms of
//    Linear (1, 0) and Smoothstep (6f(1-f), 6-12f), times scale and scale^2,
//    where the JAX package differentiates f*f*(3-2f) by autodiff: the two
//    agree to fp32 rounding, not bit for bit.  Nearest has zero derivative.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// The per-sample level cutoff of the coarse-to-fine mask (grid.h:69-92;
// tcnn_tpu/ops/grid_ops.py:1221-1224): a sample with level fraction frac
// keeps level l iff float(l) < frac * n_levels + 1e-3.  Rounded after the
// product and after the sum, as JAX computes it: __fmul_rn/__fadd_rn keep
// nvcc from contracting the two into one fused multiply-add, which would
// move a threshold that lies on a level boundary (frac = k / n_levels).
__device__ __forceinline__ float level_threshold(float frac, int n_levels) {
  return __fadd_rn(__fmul_rn(frac, float(n_levels)), 1e-3f);
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

// First and second derivative of interp_weight in f.
__device__ __forceinline__ void interp_derivatives(float f, int interp, float& d1, float& d2) {
  if (interp == 1) {                                             // Linear
    d1 = 1.0f;
    d2 = 0.0f;
  } else if (interp == 2) {                                      // Smoothstep
    d1 = 6.0f * f * (1.0f - f);
    d2 = 6.0f - 12.0f * f;
  } else {                                                       // Nearest
    d1 = 0.0f;
    d2 = 0.0f;
  }
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

// Row `row` of a float32 or bfloat16 table whose dtype is known only at run
// time (kernel GG: one instance serves both).
template <int F>
__device__ __forceinline__ void load_row_any(const void* table, bool bf16, uint32_t row,
                                             float (&v)[F]) {
  if (bf16)
    load_row<__nv_bfloat16, F>(static_cast<const __nv_bfloat16*>(table) + int64_t(row) * F, v);
  else
    load_row<float, F>(static_cast<const float*>(table) + int64_t(row) * F, v);
}

// Element i of a float32 or bfloat16 array whose dtype is known only at
// run time.
__device__ __forceinline__ float load_any(const void* p, bool bf16, int64_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Corner c's interpolation weight from the per-dim weights w1: the
// product over d of w1[d] or 1 - w1[d], in the order d = 0 .. D-1.
template <int D>
__device__ __forceinline__ float corner_weight(const float (&w1)[D], int c) {
  float w = (c & 1) ? w1[0] : __fsub_rn(1.0f, w1[0]);
#pragma unroll
  for (int d = 1; d < D; ++d)
    w = __fmul_rn(w, ((c >> d) & 1) ? w1[d] : __fsub_rn(1.0f, w1[d]));
  return w;
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
  // d w1 / dx and d2 w1 / dx2 per dim (kernels GI and GG; G and GB leave
  // them unused and the compiler drops them).
  float dw1[D], d2w1[D];

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
      const float f = __fsub_rn(pos, cf);
      w1[d] = interp_weight(f, interp);
      interp_derivatives(f, interp, dw1[d], d2w1[d]);
      dw1[d] *= scale;
      d2w1[d] *= scale * scale;
    }
  }

  __device__ __forceinline__ float weight(int c) const { return corner_weight<D>(w1, c); }

  // Corner c's factor of dim d, and its first and second derivative in x_d.
  __device__ __forceinline__ float factor(int c, int d) const {
    return ((c >> d) & 1) ? w1[d] : 1.0f - w1[d];
  }
  __device__ __forceinline__ float dfactor(int c, int d) const {
    return ((c >> d) & 1) ? dw1[d] : -dw1[d];
  }
  __device__ __forceinline__ float d2factor(int c, int d) const {
    return ((c >> d) & 1) ? d2w1[d] : -d2w1[d];
  }

  // g[d] = d w_c / dx_d: the product rule over the dims.
  __device__ __forceinline__ void weight_grad(int c, float (&g)[D]) const {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float p = dfactor(c, d);
#pragma unroll
      for (int e = 0; e < D; ++e)
        if (e != d) p *= factor(c, e);
      g[d] = p;
    }
  }

  // out[e] = sum_d d2 w_c / dx_d dx_e * v[d]: the Hessian of corner c's
  // weight times v.  The mixed terms d != e are nonzero for Linear too.
  __device__ __forceinline__ void weight_hess_vec(int c, const float (&v)[D],
                                                  float (&out)[D]) const {
#pragma unroll
    for (int e = 0; e < D; ++e) {
      float s = d2factor(c, e) * v[e];
#pragma unroll
      for (int f = 0; f < D; ++f)
        if (f != e) s *= factor(c, f);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d == e) continue;
        float p = dfactor(c, d) * dfactor(c, e) * v[d];
#pragma unroll
        for (int f = 0; f < D; ++f)
          if (f != d && f != e) p *= factor(c, f);
        s += p;
      }
      out[e] = s;
    }
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

  // Every corner's row at once, equal to row(c) for each c: dim d adds
  // two terms, one per bit of the corner, and corner c combines the
  // terms of its bits (xor for the hashes' products, + for CoherentAdd's
  // dim 0 and the dense strides), so 2^D corners cost 2D multiplies in
  // place of D·2^D.  pow2: the level's size is a power of two, where
  // h % size is a mask.
  __device__ __forceinline__ void rows(const HashConsts& hc, bool pow2,
                                       uint32_t (&r)[1 << D]) const {
    uint32_t term[D][2];
    const bool add0 = !use_hash || hc.coherent_add;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      uint32_t f;
      if (use_hash)
        f = (d == 0 && hc.coherent_add) ? 1u : hc.factors[d];
      else
        f = ((stride_mask >> d) & 1) ? uint32_t(lp[6 + d]) : 0u;
      term[d][0] = cell[d] * f;
      term[d][1] = (cell[d] + 1) * f;
    }
    // hi[j]: the combined terms of dims 1 .. D-1 for the corners 2j, 2j + 1.
    uint32_t hi[1 << (D - 1)];
    hi[0] = 0;
#pragma unroll
    for (int d = 1; d < D; ++d)
#pragma unroll
      for (int j = 0; j < (1 << (d - 1)); ++j) {
        const uint32_t h = hi[j];
        hi[j] = use_hash ? h ^ term[d][0] : h + term[d][0];
        hi[j | (1 << (d - 1))] = use_hash ? h ^ term[d][1] : h + term[d][1];
      }
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      const uint32_t h = add0 ? hi[c >> 1] + term[0][c & 1] : hi[c >> 1] ^ term[0][c & 1];
      r[c] = (pow2 ? h & (size - 1) : fastmod(h, magic, size)) + offset;
    }
  }
};

// dst = bf16(src), the one cast of an fp32 gradient buffer to a bf16 table.
__global__ void __launch_bounds__(kGridThreads)
cast_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                    int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

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

// Index and weight arithmetic shared by the grid kernels G
// (grid_encode.cu, forward), GB (grid_encode_bwd.cu, backward), GI
// (grid_encode_bwd_input.cu, the input gradient), GG
// (grid_encode_bwd_bwd.cu, second order) and GT (grid_encode_third.cu,
// third order), so that every backward reads and scatters exactly the
// rows, with exactly the weights, that the forward gathered from.
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
//  * shard mode (ops/grid_ops.py::sharded_tables): the table is one rank's
//    block-cyclic shard, rows [sid*size/n, (sid+1)*size/n) of every level.
//    A corner's row is computed exactly as unsharded, (h mod size) + the
//    level's row base, which level_params sets to offset/n - sid*size/n
//    (mod 2^32), so that the rank's rows land at [offset/n, offset/n +
//    size/n) of its shard; shard_owns tests that range, unsigned, and a
//    corner outside it (another rank's) is not read or written.  Unsharded
//    the row base is the offset and every row passes.  The JAX package pins
//    the even corner of a pair that straddles a block boundary
//    (grid_ops.py:404-420) for its paired TPU kernels; these kernels take
//    each corner on its own, so nothing is pinned.
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
constexpr int kLevelFields = 17;  // ops/grid_ops.py::level_params
constexpr int kMaxDims = 7;       // the seven hash primes (common_device.h:646-664)

// The hash of a hashed level: the XOR of coordinate x prime products
// (Prime, CoherentPrime, ReversedPrime), CoherentAdd's dim 0 added after
// the XOR, or Rng, the pcg32 skip-ahead (rng != 0, pcg32_hash below).  A
// run-time argument of every grid kernel, not a template parameter.  The
// 1- to 4-D instances (LevelCorners) take the prime hashes; an Rng grid
// runs each kernel's one run-time-D instance (WideCorners), which hashes
// each corner in full: pcg32 is not XOR-linear, so the per-dim terms of
// LevelCorners::rows do not apply, and the instances of the prime hashes
// carry no code of it (their build and their bits stay as they were).
struct HashConsts {
  uint32_t factors[kMaxDims];
  int coherent_add;
  int rng;
};

// HashType.Rng (common_device.h:678-691, pcg32.h; the port's plain version
// and host model are ops/pcg32_hash.py): pcg32 seeded with 1337 on stream
// 1, advanced by `step` through the LCG jump-ahead, one output.  The
// jump-ahead's 64 (multiplier, increment) pairs depend on the stream
// alone: pair j is applied where bit j of step is set
// (ops/pcg32_hash.py::advance_constants, checked against these constants
// by tests/test_torch_rng_grid.py).
__constant__ uint64_t kPcgMult[64] = {
    0x5851f42d4c957f2dull, 0x685f98a2018fade9ull, 0xfb4d3ae39272be11ull,
    0xb59dda5f38413d21ull, 0x8d5e2ddc895abe41ull, 0x96481983e5188c81ull,
    0x4425ebbf6f4d5901ull, 0x8980d00b878bb201ull, 0x02078e0dd6db6401ull,
    0x659acb4fecc6c801ull, 0xaa1421b9d5cd9001ull, 0x88f21a239c9b2001ull,
    0x469c6146fd364001ull, 0x1dd8088d0a6c8001ull, 0x7fa1b91654d90001ull,
    0x52ae921da9b20001ull, 0x902da3ff53640001ull, 0xb4bd470ea6c80001ull,
    0x04028a5d4d900001ull, 0xba2505ba9b200001ull, 0x7cc9cf7536400001ull,
    0x1b92aeea6c800001ull, 0xbf219dd4d9000001ull, 0x9e343ba9b2000001ull,
    0xbc2c775364000001ull, 0x7768eea6c8000001ull, 0xeb11dd4d90000001ull,
    0xc723ba9b20000001ull, 0x5247753640000001ull, 0xb48eea6c80000001ull,
    0xa91dd4d900000001ull, 0x523ba9b200000001ull, 0xa477536400000001ull,
    0x48eea6c800000001ull, 0x91dd4d9000000001ull, 0x23ba9b2000000001ull,
    0x4775364000000001ull, 0x8eea6c8000000001ull, 0x1dd4d90000000001ull,
    0x3ba9b20000000001ull, 0x7753640000000001ull, 0xeea6c80000000001ull,
    0xdd4d900000000001ull, 0xba9b200000000001ull, 0x7536400000000001ull,
    0xea6c800000000001ull, 0xd4d9000000000001ull, 0xa9b2000000000001ull,
    0x5364000000000001ull, 0xa6c8000000000001ull, 0x4d90000000000001ull,
    0x9b20000000000001ull, 0x3640000000000001ull, 0x6c80000000000001ull,
    0xd900000000000001ull, 0xb200000000000001ull, 0x6400000000000001ull,
    0xc800000000000001ull, 0x9000000000000001ull, 0x2000000000000001ull,
    0x4000000000000001ull, 0x8000000000000001ull, 0x0000000000000001ull,
    0x0000000000000001ull,
};
__constant__ uint64_t kPcgPlus[64] = {
    0x0000000000000003ull, 0x08f5dc87e5c07d8aull, 0x6321e2d2c0df0224ull,
    0xcfa27e6a8f4cde88ull, 0xf889c5f699c3f610ull, 0xa5f6430626c55020ull,
    0x21c2a9dfbb043040ull, 0x64a0ecb22e0ea080ull, 0xc5e75b7f2d364100ull,
    0xabf2b96726d08200ull, 0xfbbc643dbf310400ull, 0x61514a9b44a20800ull,
    0x1cc260c5a2441000ull, 0x75700847a8882000ull, 0x4dcdef80e1104000ull,
    0x3f597ac802208000ull, 0xadda64a904410000ull, 0x19da85b608820000ull,
    0x388bfcfc11040000ull, 0xe673c03822080000ull, 0xb256997044100000ull,
    0x7a6996e088200000ull, 0x4bc4bdc110400000ull, 0xf34fbb8220800000ull,
    0x55b8770441000000ull, 0x67d4ee0882000000ull, 0xc139dc1104000000ull,
    0x48b3b82208000000ull, 0xaa67704410000000ull, 0xb8cee08820000000ull,
    0x019dc11040000000ull, 0x433b822080000000ull, 0x8677044100000000ull,
    0x0cee088200000000ull, 0x19dc110400000000ull, 0x33b8220800000000ull,
    0x6770441000000000ull, 0xcee0882000000000ull, 0x9dc1104000000000ull,
    0x3b82208000000000ull, 0x7704410000000000ull, 0xee08820000000000ull,
    0xdc11040000000000ull, 0xb822080000000000ull, 0x7044100000000000ull,
    0xe088200000000000ull, 0xc110400000000000ull, 0x8220800000000000ull,
    0x0441000000000000ull, 0x0882000000000000ull, 0x1104000000000000ull,
    0x2208000000000000ull, 0x4410000000000000ull, 0x8820000000000000ull,
    0x1040000000000000ull, 0x2080000000000000ull, 0x4100000000000000ull,
    0x8200000000000000ull, 0x0400000000000000ull, 0x0800000000000000ull,
    0x1000000000000000ull, 0x2000000000000000ull, 0x4000000000000000ull,
    0x8000000000000000ull,
};
constexpr uint64_t kPcgState0 = 0x4cfa1d1cde85af8full;

// The launchers' hash arguments: seven factors and the kind, 0 for the
// prime products, 1 CoherentAdd, 2 Rng (ops/cuda/grid_encode.py::_hash_args).
inline HashConsts make_hash_consts(const uint32_t hash_factors[kMaxDims], int hash_kind) {
  HashConsts hc;
  for (int d = 0; d < kMaxDims; ++d) hc.factors[d] = hash_factors[d];
  hc.coherent_add = hash_kind == 1 ? 1 : 0;
  hc.rng = hash_kind == 2 ? 1 : 0;
  return hc;
}

// Kept out of line: the hash's 64-bit loop stays out of the instances'
// hot code, which other hashes run.
__device__ __noinline__ uint32_t pcg32_hash(uint64_t step) {
  uint64_t mult = 1, plus = 0;
  for (int j = 0; j < 64 && (step >> j) != 0; ++j)
    if ((step >> j) & 1) {
      mult *= kPcgMult[j];
      plus = plus * kPcgMult[j] + kPcgPlus[j];
    }
  const uint64_t state = mult * kPcgState0 + plus;
  const uint32_t xorshifted = uint32_t(((state >> 18) ^ state) >> 27);
  const uint32_t rot = uint32_t(state >> 59);
  return (xorshifted >> rot) | (xorshifted << ((32u - rot) & 31u));
}

// Rng's 64-bit step of a corner: coordinate d XORed in at bit d * (64 / D).
__device__ __forceinline__ uint64_t rng_step(const uint32_t (&cell)[kMaxDims], int n_dims, int c) {
  const int nbits = 64 / n_dims;
  uint64_t step = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d)
    if (d < n_dims) step ^= uint64_t(cell[d] + ((c >> d) & 1)) << (d * nbits);
  return step;
}

// Whether the table (a shard, in shard mode) holds `row` of the level
// whose constants are lp: rows [lp[15], lp[15] + lp[16]) (level_params).
__device__ __forceinline__ bool shard_owns(const int32_t* lp, uint32_t row) {
  return row - uint32_t(lp[15]) < uint32_t(lp[16]);
}

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

// Features [i, i + nf) of a table whose dtype is known only at run time, as
// fp32, zeros past nf (nf <= 8): the run-time-D instances' loads of a group,
// i = row·F + g0 with g0 a multiple of 8, four features a load (16 bytes
// in fp32, 8 in bf16, aligned) where F is a multiple of 4, else one each.
__device__ __forceinline__ void load_group(const void* table, bool bf16, int64_t i, int nf,
                                           int F, float (&v)[8]) {
  if (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < 8; q += 4) {
      if (q >= nf) {
        v[q] = v[q + 1] = v[q + 2] = v[q + 3] = 0.0f;
      } else if (bf16) {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(table) + i + q));
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int u = 0; u < 4; ++u) v[q + u] = __bfloat162float(e[u]);
      } else {
        const float4 raw = __ldg(reinterpret_cast<const float4*>(
            static_cast<const float*>(table) + i + q));
        v[q] = raw.x;
        v[q + 1] = raw.y;
        v[q + 2] = raw.z;
        v[q + 3] = raw.w;
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = k < nf ? load_any(table, bf16, i + k) : 0.0f;
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
    magic = (uint64_t(uint32_t(lp[14])) << 32) | uint32_t(lp[13]);
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

  // w'_c = sum_d d w_c / dx_d * v[d], the derivative of corner c's weight
  // along v: forward mode over the product of the per-dim factors, O(D).
  __device__ __forceinline__ float dir_grad(int c, const float (&v)[D]) const {
    float p = 1.0f, dp = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dp = dp * factor(c, d) + p * dfactor(c, d) * v[d];
      p *= factor(c, d);
    }
    return dp;
  }

  // dir_grad, and out[e] = sum_d d2 w_c / dx_d dx_e * v[d] (the Hessian of
  // corner c's weight times v; the mixed terms are nonzero for Linear too),
  // the gradient of w'_c: prefix products p, dp of the factors and their
  // derivative along v, then suffix products s, t from the last dim down,
  //   out[e] = (dp_e * f'_e + p_e * f''_e * v_e) * s_e + p_e * f'_e * t_e,
  // O(D) per corner.
  __device__ __forceinline__ float dir_grad_hess(int c, const float (&v)[D],
                                                 float (&out)[D]) const {
    float p[D + 1], dp[D + 1];
    p[0] = 1.0f;
    dp[0] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dp[d + 1] = dp[d] * factor(c, d) + p[d] * dfactor(c, d) * v[d];
      p[d + 1] = p[d] * factor(c, d);
    }
    float s = 1.0f, t = 0.0f;
#pragma unroll
    for (int e = D - 1; e >= 0; --e) {
      out[e] = (dp[e] * dfactor(c, e) + p[e] * d2factor(c, e) * v[e]) * s +
               p[e] * dfactor(c, e) * t;
      t = dfactor(c, e) * v[e] * s + factor(c, e) * t;
      s *= factor(c, e);
    }
    return dp[D];
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

// LevelCorners with n_dims a run-time bound up to 7: the one instance of
// each grid kernel (its *_wide kernel) that takes 5 to 7 dims, Rng grids
// of any dims, and (GB) stochastic interpolation.  Up to 128 corners: a
// thread walks them in a loop, each corner's row in full (row: the prime
// hashes' D multiplies, or Rng's pcg32), each weight and derivative as the
// product over the dims in the order d = 0 .. D-1, as corner_weight and
// LevelCorners compute them.  The per-dim arrays are indexed by unrolled
// loops only, so they stay in registers.
struct WideCorners {
  const int32_t* lp;
  int nd;
  uint32_t size, offset;
  bool use_hash;
  int stride_mask;
  uint64_t magic;
  uint32_t cell[kMaxDims];
  float w1[kMaxDims], dw1[kMaxDims], d2w1[kMaxDims];

  __device__ __forceinline__ WideCorners(const int32_t* level_params, const float* xb,
                                         int n_dims, int interp)
      : lp(level_params), nd(n_dims) {
    const float scale = __int_as_float(lp[0]);
    size = uint32_t(lp[1]);
    offset = uint32_t(lp[2]);
    use_hash = lp[3] != 0;
    stride_mask = lp[5];
    magic = (uint64_t(uint32_t(lp[14])) << 32) | uint32_t(lp[13]);
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      cell[d] = 0;
      w1[d] = dw1[d] = d2w1[d] = 0.0f;
      if (d >= nd) continue;
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

  __device__ __forceinline__ float factor(int c, int d) const {
    return ((c >> d) & 1) ? w1[d] : 1.0f - w1[d];
  }
  __device__ __forceinline__ float dfactor(int c, int d) const {
    return ((c >> d) & 1) ? dw1[d] : -dw1[d];
  }
  __device__ __forceinline__ float d2factor(int c, int d) const {
    return ((c >> d) & 1) ? d2w1[d] : -d2w1[d];
  }

  __device__ __forceinline__ float weight(int c) const {
    float w = (c & 1) ? w1[0] : __fsub_rn(1.0f, w1[0]);
#pragma unroll
    for (int d = 1; d < kMaxDims; ++d)
      if (d < nd) w = __fmul_rn(w, ((c >> d) & 1) ? w1[d] : __fsub_rn(1.0f, w1[d]));
    return w;
  }

  // The corner that takes a sample's whole table gradient under stochastic
  // interpolation (grid.h:284-299): cell + 1 on dim d iff u < w1[d].
  __device__ __forceinline__ int stochastic_corner(float u) const {
    int c = 0;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d)
      if (d < nd) c |= (u < w1[d] ? 1 : 0) << d;
    return c;
  }

  // g[d] = d w_c / dx_d (d < nd).
  __device__ __forceinline__ void weight_grad(int c, float (&g)[kMaxDims]) const {
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      float p = dfactor(c, d);
#pragma unroll
      for (int e = 0; e < kMaxDims; ++e)
        if (e != d && e < nd) p *= factor(c, e);
      g[d] = d < nd ? p : 0.0f;
    }
  }

  // dir_grad and dir_grad_hess of LevelCorners over the nd dims (out[e]
  // = 0 for e >= nd), O(nd) per corner.
  __device__ __forceinline__ float dir_grad(int c, const float (&v)[kMaxDims]) const {
    float p = 1.0f, dp = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d >= nd) continue;
      dp = dp * factor(c, d) + p * dfactor(c, d) * v[d];
      p *= factor(c, d);
    }
    return dp;
  }

  __device__ __forceinline__ float dir_grad_hess(int c, const float (&v)[kMaxDims],
                                                 float (&out)[kMaxDims]) const {
    float p[kMaxDims + 1], dp[kMaxDims + 1];
    p[0] = 1.0f;
    dp[0] = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      const bool in = d < nd;
      dp[d + 1] = in ? dp[d] * factor(c, d) + p[d] * dfactor(c, d) * v[d] : dp[d];
      p[d + 1] = in ? p[d] * factor(c, d) : p[d];
    }
    float s = 1.0f, t = 0.0f;
#pragma unroll
    for (int e = kMaxDims - 1; e >= 0; --e) {
      if (e >= nd) {
        out[e] = 0.0f;
        continue;
      }
      out[e] = (dp[e] * dfactor(c, e) + p[e] * d2factor(c, e) * v[e]) * s +
               p[e] * dfactor(c, e) * t;
      t = dfactor(c, e) * v[e] * s + factor(c, e) * t;
      s *= factor(c, e);
    }
    return dp[kMaxDims];   // dp[d] for d > nd repeats dp[nd]
  }

  __device__ __forceinline__ uint32_t row(int c, const HashConsts& hc) const {
    uint32_t h = 0;
    if (use_hash && hc.rng) {
      h = pcg32_hash(rng_step(cell, nd, c));
    } else if (use_hash) {
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) {
        if (d >= nd) continue;
        const uint32_t p = cell[d] + ((c >> d) & 1);
        if (d == 0 && hc.coherent_add) continue;
        h ^= p * hc.factors[d];
      }
      if (hc.coherent_add) h += cell[0] + (c & 1);
    } else {
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d)
        if (d < nd && ((stride_mask >> d) & 1))
          h += (cell[d] + ((c >> d) & 1)) * uint32_t(lp[6 + d]);
    }
    return fastmod(h, magic, size) + offset;
  }
};

// Features per group of the run-time-D instances: a (sample, level) of F
// features runs its groups [g0, g0 + 8) one after another (where F > 8
// each group recomputes the corners' rows and weights, which the loop over
// up to 128 corners cannot keep in registers), so that a thread's sums over
// the features stay in one thread and in one order.
constexpr int kFeatureGroup = 8;

// Whether a launch takes its kernel's run-time-D instance: 5 to 7 dims, an
// Rng grid (each corner's hash in full), or more than 8 features a level
// (the 1- to 4-D instances template F over 1 to 8).
inline bool wide_instance(int n_dims, int hash_kind, int n_features) {
  return n_dims > 4 || hash_kind == 2 || n_features > kFeatureGroup;
}

// dst = bf16(src), the one cast of an fp32 gradient buffer to a bf16 table.
__global__ void __launch_bounds__(kGridThreads)
cast_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                    int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

// d_x[i] = the live levels' partials at i summed in level order (i over
// the B * D values): the fixed order that keeps d_x deterministic (kernels
// GG and GT).
__global__ void __launch_bounds__(kGridThreads)
sum_levels_kernel(const float* __restrict__ part, const int32_t* __restrict__ level_params,
                  int n_levels, int64_t n, float* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int l = 0; l < n_levels; ++l)
    if (level_params[l * kLevelFields + 4]) s += part[int64_t(l) * n + i];
  out[i] = s;
}

// Template dispatch over the runtime (D, F) of a launch: calls
// Launch::template run<D, F>() for D in 1..4 and F in 1..8 (wide_instance
// launches take each kernel's one *_wide instance, before this dispatch).
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

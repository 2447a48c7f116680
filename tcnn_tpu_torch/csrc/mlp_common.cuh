// Helpers shared by the fused-MLP kernels M (fused_mlp.cu, forward) and
// MB (fused_mlp_bwd.cu, backward): activations and their derivatives,
// bf16 mma.sync fragments, and the staging of weights and input tiles in
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tcnn_tpu_torch {
namespace {

constexpr int kRows = 128;       // bf16 kernels: batch rows per CTA
constexpr int kWarps = kRows / 16;
constexpr int kSkew = 8;         // bf16 padding per shared row (bank spread)
constexpr int kMaxSmem = 232448;
constexpr int kMaxLayers = 32;   // n_hidden + 1, a kernel-parameter array

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// The Activation enum's order (common.py): None, ReLU, LeakyReLU,
// Exponential, Sine, Sigmoid, Squareplus, Softplus, Tanh.
//
// activate() and activate_derivative() inline only None and ReLU and call
// out of line for the rest: the whole switch, inlined at every one of the
// unrolled call sites, made kernels M and MB about twice as slow on
// config_hash (PERF.md, tools/kernel_ablation.py).
__device__ __noinline__ float activate_other(float z, int act) {
  constexpr float kAct = 10.0f;
  switch (act) {
    case 2: return fmaxf(z, 0.0f) + 0.01f * fminf(z, 0.0f);
    case 3: return expf(z);
    case 4: return sinf(z);
    case 5: return 1.0f / (1.0f + expf(-z));
    case 6: {
      const float xk = z * kAct;
      return 0.5f * (xk + sqrtf(xk * xk + 4.0f)) / kAct;
    }
    case 7: {
      const float xk = z * kAct;
      const float sp = xk > 0.0f ? xk + log1pf(expf(-xk)) : log1pf(expf(xk));
      return sp / kAct;
    }
    case 8: return tanhf(z);
    default: return z;
  }
}

__device__ __forceinline__ float activate(float z, int act) {
  if (act == 1) return fmaxf(z, 0.0f);
  if (act == 0) return z;
  return activate_other(z, act);
}

// d act / dz at the pre-activation z, as the JAX package's
// activation_derivative (tcnn_tpu/ops/activations.py:47-74).
__device__ __noinline__ float activate_derivative_other(float z, int act) {
  constexpr float kAct = 10.0f;
  switch (act) {
    case 2: return z > 0.0f ? 1.0f : 0.01f;
    case 3: return expf(z);
    case 4: return cosf(z);
    case 5: {
      const float s = 1.0f / (1.0f + expf(-z));
      return s * (1.0f - s);
    }
    case 6: {
      const float xk = z * kAct;
      return 0.5f * (1.0f + xk / sqrtf(xk * xk + 4.0f));
    }
    case 7: return 1.0f / (1.0f + expf(-z * kAct));
    case 8: {
      const float t = tanhf(z);
      return 1.0f - t * t;
    }
    default: return 1.0f;
  }
}

__device__ __forceinline__ float activate_derivative(float z, int act) {
  if (act == 1) return z > 0.0f ? 1.0f : 0.0f;
  if (act == 0) return 1.0f;
  return activate_derivative_other(z, act);
}

// The same for a kernel instance that knows, with kFast, that every
// activation it meets is None or ReLU: no out-of-line call site is left in
// it, which kernel MB's wgrad, with an activation per operand element,
// needs to run at full speed (PERF.md, tools/kernel_ablation.py).
template <bool kFast>
__device__ __forceinline__ float act_fn(float z, int act) {
  if constexpr (kFast) return act == 1 ? fmaxf(z, 0.0f) : z;
  else return activate(z, act);
}

template <bool kFast>
__device__ __forceinline__ float act_grad(float z, int act) {
  if constexpr (kFast) return act == 1 ? (z > 0.0f ? 1.0f : 0.0f) : 1.0f;
  else return activate_derivative(z, act);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Copies `total` elements into shared memory with kBatch independent
// global loads in flight per thread, where a loop whose one load feeds
// one store would wait a memory latency per element.  src(i) loads
// element i, dst(i, v) stores it.
constexpr int kBatch = 8;
template <typename T, typename Src, typename Dst>
__device__ __forceinline__ void staged_copy(int total, Src src, Dst dst) {
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) v[u] = src(i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) dst(i, v[u]);
    }
  }
}

// Stages a row-major (k_real, n_real) bf16 weight matrix from global
// memory into shared memory TRANSPOSED, dst[n * ld + k], zero-padded to
// (K, N): a B fragment of mma.m16n8k16 is then two 32-bit loads of
// consecutive k.  Rows of W elements move as 16-byte chunks, consecutive
// lanes on consecutive k so the transposing stores do not collide in a
// bank; others (the D_out-wide output layer) go element by element.
template <int W>
__device__ __forceinline__ void stage_weights_t(const __nv_bfloat16* __restrict__ w,
                                                int k_real, int n_real, int K, int N,
                                                __nv_bfloat16* dst, int ld) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (n_real == W && N == W && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    constexpr int kChunks = W / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < K * kChunks; c += blockDim.x) {
      const int k = c % K, j = c / K;
      const uint4 v = k < k_real
          ? __ldg(reinterpret_cast<const uint4*>(w + k * W) + j)
          : make_uint4(0, 0, 0, 0);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int u = 0; u < 8; ++u) dst[(8 * j + u) * ld + k] = e[u];
    }
    return;
  }
  staged_copy<__nv_bfloat16>(
      K * N,
      [&](int i) {
        const int n = i / K, k = i % K;
        return (k < k_real && n < n_real) ? w[k * n_real + n] : zero;
      },
      [&](int i, __nv_bfloat16 v) { dst[(i / K) * ld + i % K] = v; });
}

// Stages a kRows-row bf16 input tile into shared memory as act[r * ld + k],
// zero-padded to pad16(d_in) columns; rows past the batch are zeros.
// Element (b, k) of x is x[b * stride_b + k * stride_d].  The common
// case, a full SoA tile with 16-byte aligned rows, goes in blocks of 8
// features x 8 samples: eight 16-byte loads (8 samples of one feature
// each), a transpose in registers, eight 16-byte stores (8 features of
// one sample each).  Storing single elements down a column instead puts
// all 32 lanes of a warp in one shared-memory bank.  The rest (AoS, the
// batch tail) goes element by element.
__device__ __forceinline__ void stage_input_tile(const __nv_bfloat16* __restrict__ x,
                                                 int64_t stride_b, int64_t stride_d,
                                                 int d_in, int64_t batch, int64_t row0,
                                                 bool soa_in, __nv_bfloat16* act, int ld) {
  const int tid = threadIdx.x;
  const int kin = pad16(d_in);
  const bool full_tile = row0 + kRows <= batch;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (soa_in && full_tile && kin == d_in && stride_d % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    constexpr int kSampleBlocks = kRows / 8;
    for (int task = tid; task < (d_in / 8) * kSampleBlocks; task += blockDim.x) {
      const int kk = task % (d_in / 8), j = task / (d_in / 8);
      uint4 v[8];
#pragma unroll
      for (int f = 0; f < 8; ++f)
        v[f] = __ldg(reinterpret_cast<const uint4*>(x + (8 * kk + f) * stride_d + row0 + 8 * j));
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        alignas(16) __nv_bfloat16 row[8];
#pragma unroll
        for (int f = 0; f < 8; ++f) row[f] = reinterpret_cast<const __nv_bfloat16*>(&v[f])[u];
        *reinterpret_cast<uint4*>(act + (8 * j + u) * ld + 8 * kk) =
            *reinterpret_cast<const uint4*>(row);
      }
    }
  } else {
    staged_copy<__nv_bfloat16>(
        kRows * kin,
        [&](int i) {
          const int r = soa_in ? i % kRows : i / kin;
          const int k = soa_in ? i / kRows : i % kin;
          const int64_t b = row0 + r;
          return (b < batch && k < d_in) ? x[b * stride_b + k * stride_d] : zero;
        },
        [&](int i, __nv_bfloat16 v) {
          const int r = soa_in ? i % kRows : i / kin;
          const int k = soa_in ? i / kRows : i % kin;
          act[r * ld + k] = v;
        });
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a · b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 fp32.  Lane l holds, with g = l / 4 and t = l % 4:
//   a: {A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}
//   b: {B[2t..2t+1][g], B[2t+8..2t+9][g]}
//   d: {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of n-tile j, k-step kb, from transposed weights wt.
__device__ __forceinline__ void load_b(const __nv_bfloat16* wt, int ld, int j, int kb,
                                       int g, int t, uint32_t* b0, uint32_t* b1) {
  const __nv_bfloat16* p = wt + (8 * j + g) * ld + 16 * kb + 2 * t;
  *b0 = ld32(p);
  *b1 = ld32(p + 8);
}

// Four 8 x 8 bf16 blocks of a row-major shared-memory matrix, each
// delivered TRANSPOSED: lane l receives, from block i, the elements
// (rows 2(l%4) and 2(l%4)+1, column l/4) in out[i].  Each lane passes the
// address of row l%8 of block l/8 (16-byte aligned).
__device__ __forceinline__ void ldsm_x4_trans(const __nv_bfloat16* row_addr,
                                              uint32_t (&out)[4]) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(out[0]), "=r"(out[1]), "=r"(out[2]), "=r"(out[3])
      : "r"(addr));
}

// The A fragment of the TRANSPOSE of a 16 x 16 block of a row-major
// shared matrix m (row stride ld, a multiple of 8): A[i][k] = m[k0+k][c0+i].
// Blocks: (k0, c0), (k0, c0+8), (k0+8, c0), (k0+8, c0+8).
__device__ __forceinline__ void load_a_trans(const __nv_bfloat16* m, int ld, int k0,
                                             int c0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4_trans(m + (k0 + lane % 8 + 8 * (i / 2)) * ld + c0 + 8 * (i % 2), a);
}

// The B fragments of n-tiles n0/8 and n0/8 + 1 at k-step rows [k0, k0+16)
// of a row-major shared matrix m holding B itself, B[k][n] = m[k][n]:
// b = {b0, b1 of the first n-tile, b0, b1 of the second}.
// Blocks: (k0, n0), (k0+8, n0), (k0, n0+8), (k0+8, n0+8).
__device__ __forceinline__ void load_b_pair(const __nv_bfloat16* m, int ld, int k0,
                                            int n0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4_trans(m + (k0 + lane % 8 + 8 * (i % 2)) * ld + n0 + 8 * (i / 2), b);
}

// Above 48 KB a kernel needs an explicit dynamic shared-memory budget.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace
}  // namespace tcnn_tpu_torch

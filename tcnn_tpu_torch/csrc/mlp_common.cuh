// Helpers shared by the fused-MLP kernels M (fused_mlp.cu, forward) and
// MB (fused_mlp_bwd.cu, backward), and their streamed-layer instances MW
// and MBW (fused_mlp_wide.cu): activations and their derivatives,
// bf16 mma.sync fragments and ldmatrix loads, cp.async, the staging of
// weights and input tiles in shared memory, the fp32 register-tiled
// products and weight gradient, and the occupancy of persistent kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace tcnn_tpu_torch {
namespace {

constexpr int kRows = 128;       // bf16 kernels: batch rows per CTA
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

template <typename T> __device__ __forceinline__ T zero_val();
template <> __device__ __forceinline__ float zero_val<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_val<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

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

// Stages an R-row bf16 input tile into shared memory as act[r * ld + k],
// zero-padded to pad16(d_in) columns; rows past the batch are zeros.
// Element (b, k) of x is x[b * stride_b + k * stride_d].  The common
// case, a full SoA tile with 16-byte aligned rows, goes in blocks of 8
// features x 8 samples: eight 16-byte loads (8 samples of one feature
// each), a transpose in registers, eight 16-byte stores (8 features of
// one sample each).  Storing single elements down a column instead puts
// all 32 lanes of a warp in one shared-memory bank.  The rest (AoS, the
// batch tail) goes element by element.
template <int R = kRows>
__device__ __forceinline__ void stage_input_tile(const __nv_bfloat16* __restrict__ x,
                                                 int64_t stride_b, int64_t stride_d,
                                                 int d_in, int64_t batch, int64_t row0,
                                                 bool soa_in, __nv_bfloat16* act, int ld) {
  const int tid = threadIdx.x;
  const int kin = pad16(d_in);
  const bool full_tile = row0 + R <= batch;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (soa_in && full_tile && kin == d_in && stride_d % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    constexpr int kSampleBlocks = R / 8;
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
        R * kin,
        [&](int i) {
          const int r = soa_in ? i % R : i / kin;
          const int k = soa_in ? i / R : i % kin;
          const int64_t b = row0 + r;
          return (b < batch && k < d_in) ? x[b * stride_b + k * stride_d] : zero;
        },
        [&](int i, __nv_bfloat16 v) {
          const int r = soa_in ? i % R : i / kin;
          const int k = soa_in ? i / R : i % kin;
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

// Four 8 x 8 bf16 blocks of a row-major shared-memory matrix, as they are:
// lane l receives, from block i, (row l/4, columns 2(l%4) and 2(l%4)+1).
__device__ __forceinline__ void ldsm_x4(const __nv_bfloat16* row_addr, uint32_t (&out)[4]) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(out[0]), "=r"(out[1]), "=r"(out[2]), "=r"(out[3])
      : "r"(addr));
}

// The B fragments of n-tiles n0/8 and n0/8 + 1 at k-step [k0, k0+16) of
// B = mᵀ for a row-major shared matrix m, B[k][n] = m[n][k]: the dgrad
// product dz · Wᵀ reads the weights W as they are resident.  Same output
// order as load_b_pair.  Blocks: (n0, k0), (n0, k0+8), (n0+8, k0), (n0+8, k0+8).
__device__ __forceinline__ void load_bt_pair(const __nv_bfloat16* m, int ld, int k0,
                                             int n0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4(m + (n0 + 8 * (i / 2) + lane % 8) * ld + k0 + 8 * (i % 2), b);
}

// 16-byte asynchronous copies global -> shared (cp.async, Ampere and later).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies a row-major (rows_real, cols_real) matrix of T from global memory
// into shared memory as dst[r * ld + c], zero-padded to (rows, cols):
// 16-byte chunks where the rows allow it, element by element otherwise.
template <typename T>
__device__ __forceinline__ void stage_rowmajor(const T* __restrict__ src, int rows_real,
                                               int cols_real, int rows, int cols, T* dst,
                                               int ld) {
  constexpr int kVec = 16 / sizeof(T);
  if (cols_real == cols && cols % kVec == 0 && ld % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = cols / kVec;
    for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
      const int r = c / chunks, q = c % chunks;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows_real) v = __ldg(reinterpret_cast<const uint4*>(src + r * cols) + q);
      *reinterpret_cast<uint4*>(dst + r * ld + q * kVec) = v;
    }
    return;
  }
  staged_copy<T>(
      rows * cols,
      [&](int i) {
        const int r = i / cols, c = i % cols;
        return (r < rows_real && c < cols_real) ? src[r * cols_real + c] : zero_val<T>();
      },
      [&](int i, T v) { dst[(i / cols) * ld + i % cols] = v; });
}

// ---------------------------------------------------------------------------
// fp32 building blocks of kernels M and MB.
//
// A tile is R = kRowsF32 batch rows (32 in MB's deep width-128 layouts),
// kThreadsF32 threads.  Activations live in shared memory feature-major,
// a[k * f32_ld(R) + r], so that four consecutive
// rows are one 16-byte load.  In a product, thread (rg, cg) owns rows
// 4rg..4rg+3 and a group of TC consecutive columns; kColGroups groups
// cover kColGroups·TC columns.
//
// kTf32x3, a choice made at design time: the products run on the tensor
// cores in 3xTF32 (each fp32 operand split into TF32 big and small parts,
// big·big + big·small + small·big by mma.m16n8k8 with fp32 accumulation,
// CUTLASS's "fast accurate fp32"), or, when false, by plain fp32 FMA, per
// k one float4 of activations and TC weights for 4·TC FMAs.  PERF.md has
// the two measured against each other (tools/kernel_ablation.py).
// ---------------------------------------------------------------------------

constexpr bool kTf32x3 = false;   // measured slower (PERF.md)
constexpr int kRowsF32 = 64;       // rows of a tile; MB takes 32 where 64 does not fit
constexpr int kThreadsF32 = 128;   // 4 warps (256 measured slower, PERF.md)

// The geometry of a tile of `rows` batch rows (64, or 32): rows / 4 row
// groups of 4 rows, kThreadsF32 / (rows / 4) column groups.
__host__ __device__ constexpr int f32_col_groups(int rows) { return kThreadsF32 / (rows / 4); }
// Floats per feature row of a tile: ≡ 8 (mod 32) words spreads the mma
// operand loads over the banks, ≡ 4 the FMA weight gradient's.
__host__ __device__ constexpr int f32_ld(int rows) { return rows + (kTf32x3 ? 8 : 4); }
constexpr int kColGroups = f32_col_groups(kRowsF32);
constexpr int kLdF32 = f32_ld(kRowsF32);

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
// Columns of a product come in multiples of the column groups (one per group).
__host__ __device__ constexpr int padc(int n, int rows = kRowsF32) {
  return (n + f32_col_groups(rows) - 1) / f32_col_groups(rows) * f32_col_groups(rows);
}
// Row stride of n-column fp32 weights in shared memory; for the mma loads
// ≡ 8 (mod 32) words where n is a multiple of 32.
__host__ __device__ constexpr int f32_ldw(int n, int rows = kRowsF32) {
  return padc(n, rows) + (kTf32x3 ? 8 : 0);
}

// R / 4 row groups x f32_col_groups(R) column groups.  At R = 64 warp w
// covers rg in [8(w%2), 8(w%2)+8) and cg in [4(w/2), 4(w/2)+4), at R = 32
// rg in [0, 8) and cg in [4w, 4w+4); lane l at rg 8(w%(R/32)) + l/4,
// cg 4(w/(R/32)) + l%4 for the mma fragments (3xTF32), else at rg
// 8(w%(R/32)) + l%8, cg 4(w/(R/32)) + l/8 (a quarter-warp's FMA activation
// loads cover 128 contiguous bytes, its weight loads are broadcasts).
template <int R = kRowsF32>
__device__ __forceinline__ int f32_rg() {
  return (threadIdx.x / 32 % (R / 32)) * 8 + (kTf32x3 ? threadIdx.x % 32 / 4 : threadIdx.x % 8);
}
template <int R = kRowsF32>
__device__ __forceinline__ int f32_cg() {
  return (threadIdx.x / 32 / (R / 32)) * 4 + (kTf32x3 ? threadIdx.x % 4 : threadIdx.x % 32 / 8);
}

// v = p[0..N), or zeros where !ok; p 4·N-byte aligned up to 16.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, bool ok, float (&v)[N]) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = 0.0f;
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      *reinterpret_cast<float4*>(v + 4 * q) = *reinterpret_cast<const float4*>(p + 4 * q);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(v) = *reinterpret_cast<const float2*>(p);
  } else {
    v[0] = p[0];
  }
}

// x = big + small, both TF32 (cvt.rna: round to nearest, ties away); the
// difference x - big is exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// d += a · b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32
// operands, fp32 d.  Lane l holds, with g = l / 4 and t = l % 4:
//   a: {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}   b: {B[t][g], B[t+4][g]}
//   d: {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (4 values) or B fragment (2) split into its big and small parts.
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], big[i], small[i]);
}

// d += a · b in 3xTF32 from the split fragments, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

// f32_product (below) on the tensor cores, TC even.  The mma rows g and
// g + 8 of m-tile u (u = 0, 1) are the lane's rows 4rg + 2u and
// 4rg + 2u + 1; mma columns 2t and 2t + 1 of n-tile j are its columns
// TC·cg + j and TC·cg + j + TC/2.  So per k-step of 8 a lane reads its A
// values as two float4 (rows 4rg..4rg+3 at k and k + 4) and its B values
// as two runs of TC/2 consecutive floats; k past K reads as 0.
template <int TC, bool kActA, bool kFast, int R>
__device__ __forceinline__ void f32_product_tc(const float* __restrict__ A, int act,
                                               const float* __restrict__ B, int ldb, int K,
                                               int c0, float (&acc)[4][TC]) {
  constexpr int NN = TC / 2, LD = f32_ld(R);
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* ap = A + 4 * f32_rg<R>();
  const float* bp = B + c0 + TC * (f32_cg<R>() - t + g / 2) + NN * (g % 2);  // column of mma col g
  float c[2][NN][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < NN; ++j) c[u][j][0] = c[u][j][1] = c[u][j][2] = c[u][j][3] = 0.0f;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int k[2] = {k0 + t, k0 + t + 4};
    float a[2][4], b[2][NN];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      load_vec<4>(ap + k[h] * LD, k[h] < K, a[h]);
      load_vec<NN>(bp + k[h] * ldb, k[h] < K, b[h]);
      if (kActA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[h][i] = act_fn<kFast>(a[h][i], act);
      }
    }
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      split_frag<4>({a[0][2 * u], a[0][2 * u + 1], a[1][2 * u], a[1][2 * u + 1]}, ab[u], as[u]);
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      uint32_t bb[2], bs[2];
      split_frag<2>({b[0][j], b[1][j]}, bb, bs);
      mma_3xtf32(c[0][j], ab[0], as[0], bb, bs);
      mma_3xtf32(c[1][j], ab[1], as[1], bb, bs);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[2 * u + i / 2][j + NN * (i % 2)] = c[u][j][i];
}

// acc[i][j] = Σ_{k<K} act(A[k][4rg+i]) · B[k][c0 + TC·cg + j]: in 3xTF32
// (f32_product_tc) where kTf32x3 and TC is even, else each sum in k order
// by fmaf.  A feature-major (f32_ld(R) floats per feature, R rows), the
// activation applied to each element read when kActA; B row-major, ldb
// floats per row, a multiple of 4.
template <int TC, bool kActA, bool kFast, int R = kRowsF32>
__device__ __forceinline__ void f32_product(const float* __restrict__ A, int act,
                                            const float* __restrict__ B, int ldb, int K,
                                            int c0, float (&acc)[4][TC]) {
  if constexpr (kTf32x3 && TC % 2 == 0) {
    f32_product_tc<TC, kActA, kFast, R>(A, act, B, ldb, K, c0, acc);
    return;
  }
  const int r = 4 * f32_rg<R>(), c = c0 + TC * f32_cg<R>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], b[TC];
    load_vec<4>(A + k * f32_ld(R) + r, true, av);
    if (kActA) {
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = act_fn<kFast>(av[i], act);
    }
    load_vec<TC>(B + k * ldb + c, true, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
  }
}

// f32_product over C columns (a multiple of the column groups) in chunks
// of 8, 4, 2 and 1 columns per group, for widths that are not a template
// parameter (D_in, D_out); epi(c, acc) receives each chunk's block, this
// thread's columns from c.
template <bool kActA, bool kFast, int R = kRowsF32, typename Epi>
__device__ __forceinline__ void f32_product_cols(const float* __restrict__ A, int act,
                                                 const float* __restrict__ B, int ldb, int K,
                                                 int C, Epi epi) {
  constexpr int CG = f32_col_groups(R);
  for (int c0 = 0; c0 < C;) {
    const int rem = C - c0;
    if (rem >= 8 * CG) {
      float acc[4][8];
      f32_product<8, kActA, kFast, R>(A, act, B, ldb, K, c0, acc);
      epi(c0 + 8 * f32_cg<R>(), acc);
      c0 += 8 * CG;
    } else if (rem >= 4 * CG) {
      float acc[4][4];
      f32_product<4, kActA, kFast, R>(A, act, B, ldb, K, c0, acc);
      epi(c0 + 4 * f32_cg<R>(), acc);
      c0 += 4 * CG;
    } else if (rem >= 2 * CG) {
      float acc[4][2];
      f32_product<2, kActA, kFast, R>(A, act, B, ldb, K, c0, acc);
      epi(c0 + 2 * f32_cg<R>(), acc);
      c0 += 2 * CG;
    } else {
      float acc[4][1];
      f32_product<1, kActA, kFast, R>(A, act, B, ldb, K, c0, acc);
      epi(c0 + f32_cg<R>(), acc);
      c0 += CG;
    }
  }
}

// Adds c into a CTA's partial dW (shared or device memory), or stores it
// on the CTA's first tile.
__device__ __forceinline__ void accumulate(float* p, float c, bool first) {
  *p = first ? c : *p + c;
}

// f32_wgrad (below) on the tensor cores in 3xTF32.  Warps take units of
// a 16-row m-tile of dW by NG 8-column n-tiles, each contracting over the
// tile's rows in a fixed order: every dW element is summed by one lane.
// The mma rows g and g + 8 of an m-tile are its rows 2g and 2g + 1, mma
// column q of an n-tile is its column 2(q%4) + q/4, and in k-step s of a
// 16-row chunk the mma k indices t and t + 4 are rows 4t + 2s and
// 4t + 2s + 1: a lane reads the A and B values of both k-steps as one
// float4 per dW row or column, and a quarter-warp's float4 loads fall in
// distinct banks (f32_ld(R) ≡ 8 mod 32).  Rows m ≥ M and n ≥ N read as 0.
template <bool kActA, bool kFast, int NG, int R>
__device__ __forceinline__ void f32_wgrad_tc(const float* __restrict__ A, int act,
                                             const float* __restrict__ D, int M, int N,
                                             float* dw, bool first) {
  constexpr int LD = f32_ld(R);
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int n_mt = (M + 15) / 16, n_units = n_mt * ((N + 8 * NG - 1) / (8 * NG));
  const auto col = [](int q) { return 2 * (q % 4) + q / 4; };
  for (int unit = threadIdx.x / 32; unit < n_units; unit += kThreadsF32 / 32) {
    const int m = 16 * (unit % n_mt) + 2 * g, n0 = 8 * NG * (unit / n_mt);
    const float* ap[2] = {A + m * LD + 4 * t, A + (m + 1) * LD + 4 * t};
    float c[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
#pragma unroll 2
    for (int r0 = 0; r0 < R; r0 += 16) {
      float a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        load_vec<4>(ap[h] + r0, m + h < M, a[h]);
        if (kActA) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[h][i] = act_fn<kFast>(a[h][i], act);
        }
      }
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
        split_frag<4>({a[0][2 * s], a[1][2 * s], a[0][2 * s + 1], a[1][2 * s + 1]}, ab[s],
                      as[s]);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int n = n0 + 8 * j + col(g);
        float d[4];
        load_vec<4>(D + n * LD + r0 + 4 * t, n < N, d);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t bb[2], bs[2];
          split_frag<2>({d[2 * s], d[2 * s + 1]}, bb, bs);
          mma_3xtf32(c[j], ab[s], as[s], bb, bs);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mi = m + i / 2, n = n0 + 8 * j + col(2 * t + i % 2);
        if (mi < M && n < N) accumulate(dw + mi * N + n, c[j][i], first);
      }
  }
}

// The weight gradient of one layer over a tile, dw[m * N + n] (+)=
// Σ_r act(A[m][r]) · D[n][r] for m < M, n < N, with A and D feature-major
// and readable (zero past the real data) up to pad8(M), pad8(N) rows: in
// 3xTF32 (f32_wgrad_tc) where kTf32x3, else by FMA, as follows.
// Each thread owns a T x T block of dW, rows m = mi + (pad8(M)/T)·i and
// columns n = ni + (pad8(N)/T)·j (strided, so that neighbouring lanes read
// neighbouring feature rows), from 2T float4 loads per 4 batch rows for
// 4T² FMAs.  A small layer has fewer blocks than threads: then S lanes
// share a block, each summing an interleaved share of the rows, and a
// fixed xor-shuffle tree adds their sums, so the result does not depend on
// scheduling.  Every dW element has one owner: no atomics.
template <int R, bool kActA, bool kFast, int T = 4>   // 8 x 8 measured slower (PERF.md)
__device__ __forceinline__ void f32_wgrad(const float* __restrict__ A, int act,
                                          const float* __restrict__ D, int M, int N,
                                          float* dw, bool first) {
  if constexpr (kTf32x3) {
    if (N <= 8)
      f32_wgrad_tc<kActA, kFast, 1, R>(A, act, D, M, N, dw, first);
    else
      f32_wgrad_tc<kActA, kFast, 4, R>(A, act, D, M, N, dw, first);
    return;
  }
  constexpr int LD = f32_ld(R);
  const int mq = (M + 7) / 8 * 8 / T, nq = (N + 7) / 8 * 8 / T, slots = mq * nq;
  int S = 1;
  while (S < R / 4 && slots * S * 2 <= kThreadsF32) S *= 2;
  const int s = threadIdx.x % S, per = kThreadsF32 / S;
  for (int base = 0; base < slots; base += per) {
    const int slot = base + threadIdx.x / S;
    const bool valid = slot < slots;
    const int mi = valid ? slot % mq : 0, ni = valid ? slot / mq : 0;
    float acc[T][T];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) acc[i][j] = 0.0f;
    for (int c = s; c < R / 4; c += S) {
      float av[T][4], dv[T][4];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(A + (mi + mq * i) * LD + 4 * c);
        av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
        if (kActA) {
#pragma unroll
          for (int u = 0; u < 4; ++u) av[i][u] = act_fn<kFast>(av[i][u], act);
        }
        const float4 d = *reinterpret_cast<const float4*>(D + (ni + nq * i) * LD + 4 * c);
        dv[i][0] = d.x; dv[i][1] = d.y; dv[i][2] = d.z; dv[i][3] = d.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int j = 0; j < T; ++j) acc[i][j] = fmaf(av[i][u], dv[j][u], acc[i][j]);
    }
    for (int o = S / 2; o > 0; o /= 2)
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
    if (valid && s == 0) {
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const int m = mi + mq * i, n = ni + nq * j;
          if (m < M && n < N) accumulate(dw + m * N + n, acc[i][j], first);
        }
    }
  }
}

// Stages an R-row fp32 input tile feature-major, xt[k * f32_ld(R) + r]
// (rows past the batch zero).  Element (b, k) of x is x[b * stride_b +
// k * stride_d].  A full SoA tile with 16-byte aligned feature rows goes by
// cp.async and completes at the caller's cp_async_wait_all; the rest (AoS,
// the batch tail) goes element by element with plain stores.
template <int R = kRowsF32>
__device__ __forceinline__ void stage_f32_tile(const float* __restrict__ x, int64_t stride_b,
                                               int64_t stride_d, int d_in, int64_t batch,
                                               int64_t row0, float* xt) {
  constexpr int LD = f32_ld(R);
  if (stride_b == 1 && stride_d % 4 == 0 && row0 + R <= batch &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    constexpr int kChunks = R / 4;
    for (int c = threadIdx.x; c < d_in * kChunks; c += blockDim.x) {
      const int k = c / kChunks, q = c % kChunks;
      cp_async16(xt + k * LD + 4 * q, x + k * stride_d + row0 + 4 * q);
    }
    cp_async_commit();
    return;
  }
  staged_copy<float>(
      R * d_in,
      [&](int i) {
        const int r = stride_b == 1 ? i % R : i / d_in;
        const int k = stride_b == 1 ? i / R : i % d_in;
        const int64_t b = row0 + r;
        return b < batch ? x[b * stride_b + k * stride_d] : 0.0f;
      },
      [&](int i, float v) {
        const int r = stride_b == 1 ? i % R : i / d_in;
        const int k = stride_b == 1 ? i / R : i % d_in;
        xt[k * LD + r] = v;
      });
}

// Walks this CTA's tiles blockIdx.x, blockIdx.x + gridDim.x, ... of a
// persistent kernel.  stage(tile, buf) copies a tile's input into one of
// n_buf buffers; with two, the next tile's copy is issued as soon as the
// current one has landed, so that it arrives while body(tile, in, first)
// computes (first: the CTA's first tile).  body starts after a
// __syncthreads: the previous tile is done with every buffer.
template <typename T, typename Stage, typename Body>
__device__ __forceinline__ void walk_tiles(int64_t n_tiles, int n_buf, T* const (&bufs)[2],
                                           Stage stage, Body body) {
  int64_t tile = blockIdx.x;
  int cur = 0;
  if (n_buf == 2 && tile < n_tiles) stage(tile, bufs[0]);
  for (bool first = true; tile < n_tiles; tile += gridDim.x, first = false) {
    if (n_buf == 1) {
      __syncthreads();  // the previous tile is done with the input buffer
      stage(tile, bufs[0]);
    }
    cp_async_wait_all();
    __syncthreads();  // this tile's input has landed; the previous tile is done
    const T* in = bufs[cur];
    if (n_buf == 2) {
      if (tile + gridDim.x < n_tiles) stage(tile + gridDim.x, bufs[cur ^ 1]);
      cur ^= 1;
    }
    body(tile, in, first);
  }
}

// dw[i] = Σ_c partials[c][i], summed in c's order: deterministic (kernel
// MB's persistent CTAs each write their partial dW, fused_mlp_bwd.cu; MBW's
// batch ranges theirs, fused_mlp_wide.cu).
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ partials, int n_parts, int64_t total,
                    float* __restrict__ dw) {
  const int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  float sum = 0.0f;
  for (int c = 0; c < n_parts; ++c) sum += partials[c * total + i];
  dw[i] = sum;
}

// Above 48 KB a kernel needs an explicit dynamic shared-memory budget.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The launch geometry of a persistent kernel of `threads` threads and
// `smem` dynamic bytes over n_tiles tiles: as many CTAs as the occupancy
// calculator puts on the card, at most one per tile (each CTA then owns
// one at least).  The card's count is asked once per kernel, block size,
// shared-memory size and device; the kernel's shared-memory budget is set
// on every call, since another size of the same kernel may have set it
// lower since.
template <typename Kernel>
cudaError_t persistent_ctas(Kernel kernel, int threads, int smem, int64_t n_tiles, int* ctas) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> on_card;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), threads, smem, dev);
  const std::lock_guard<std::mutex> lock(mu);
  auto it = on_card.find(key);
  if (it == on_card.end()) {
    int per_sm = 0, n_sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    it = on_card.emplace(key, per_sm * n_sms).first;
  }
  *ctas = int(n_tiles < it->second ? n_tiles : it->second);
  return cudaSuccess;
}

}  // namespace
}  // namespace tcnn_tpu_torch

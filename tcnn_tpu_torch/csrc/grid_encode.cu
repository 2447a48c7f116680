// Kernel G: multiresolution grid encoding, forward.
//
// Replaces the TPU's grid_matmul.py::_gather_kernel (:861) and
// grid_matmul.py::_gather_kernel_xor (:734), together with the XLA ops
// that built their inputs (grid_ops.py::_build_indices_weights).  Both
// TPU kernels compute cols[l*F+f, b] = sum_c w_c(b) * table[idx_c(b), f];
// on the TPU that gather had to be a one-hot matmul on the MXU, routed
// per level by size.  Hopper gathers directly, so one kernel covers every
// level: no per-level routing, no packing.
//
// What bounds it on the H100.  At config_btf (B = 2^18, 4-D, 16 levels,
// F = 2, bf16 table of 31 MB) the function moves 52 MB to and from device
// memory, 15.5 us at 3.35 TB/s; but it reads 2^18 x 16 x 16 = 67.1 M
// random table rows, each a request for a 32-byte sector of the L1 or the
// L2.  At config_hash (2-D, a 1.4 MB table) the bytes bound is 6 us
// against 16.8 M requests.  PERF.md has what was measured of each.
//
// Design:
//  * every row first, then every load, then the sums: a thread computes
//    its 2^D corner rows and weights and issues all 2^D row loads before
//    its first multiply, so that they are in flight together;
//  * rows from per-dim terms: 2D multiplies combine into the 2^D corner
//    rows, and a level of a power-of-two size masks in place of the
//    64-bit modulo (LevelCorners::rows; the rows are row()'s bits);
//  * work per thread: kSamples samples of its level, fewer where their
//    loads in flight would hold more than kLoadRegs registers;
//  * AoS output (config_btf's Composite) in whole sectors: a thread takes
//    as many levels as fill a 32-byte sector of its samples' rows, and two
//    lanes swap halves so that a warp's 16-byte stores fill whole sectors
//    and no sector is written in pieces.
// The TPU kernels _gather_kernel_xor and _gather_kernel_paired load the
// dim-0 corner pairs together; here each corner is one load (pair loads
// cut the sector requests, not the time: PERF.md).
// blockIdx.y is the level (group), so a warp shares a level's constants;
// SoA output is written as 32 consecutive samples of a row.  Each
// sample's F features are summed in fp32 over the corners in order
// 0 .. 2^D-1 with __fmul_rn/__fadd_rn and written in the table's dtype.
// Table values are read exactly; the TPU's two-term bf16 split of f32
// tables is not copied.  x is read through a row stride, so a column slice
// of a wider input (the grid's part of a Composite encoding) is read in
// place.
//
// The index and weight arithmetic, and the hazards it handles, are in
// grid_common.cuh, shared with the backward kernel GB.
//
// Rng grids (pcg32, not XOR-linear: each corner's hash in full), 5 to 7
// dims and more than 8 features a level run one instance with D, F and the
// table's dtype at run time (grid_encode_fwd_wide_kernel, WideCorners in
// grid_common.cuh; F > 8 in its kGroups copy, a group of 8 features per
// blockIdx.z); the instances above carry no code of them.
//
// Shard mode (a sharded table: the shard's rows are in level_params,
// grid_common.cuh) runs the run-time-D instance, with `sharded` a run-time
// argument: a corner whose row the shard does not hold issues no load and
// adds nothing, and the partial features are written in fp32, whatever the
// table's dtype, so that the sum over the shards (a reduce-scatter) is
// rounded once, as JAX sums its fp32 partials (grid_ops.py:441).  Its sums
// are explicitly rounded, so the test cannot move the bits of the Rng grids
// that instance serves unsharded; the 1- to 4-D instances carry no code of
// it (a test in their corner loops read 53 % slower at config_btf, PERF.md).
//
// The stochastic gather (u, the uniforms of stochastic interpolation) runs
// the run-time-D instance too: each (sample, level) reads the one corner
// that kernel GB scatters its gradient to, so its output is the derivative
// of a loss on GB's table gradient in GB's cotangent.
//
// Coarse-to-fine (kMask, a separate instance: without a mask the code is
// the unmasked design's, bit for bit and in time; one instance testing
// the mask at run time read 5 % slower at the SDF shape, PERF.md): with
// per-sample level fractions frac (the CUDA original's max_level_gpu,
// grid.h:69-92; the JAX package's grid_ops.py:1215-1228), sample b keeps
// level l iff float(l) < frac[b]*n_levels + 1e-3, the threshold rounded
// after the product and after the sum (level_threshold), as JAX computes
// it.  A masked (sample, level) issues no table load and is written as 0,
// in either layout: its accumulator stays 0, so AoS sector stores carry
// zeros in its place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

// Design choices, fixed at design time; the ablations of
// tools/kernel_ablation.py change them in patched copies.
constexpr int kSamples = 2;           // samples per thread, at most
constexpr int kLoadRegs = 48;         // registers a thread's loads in flight may hold
constexpr bool kAosSectors = true;    // AoS output: a thread takes a sector's worth of levels

// Bytes of a table row.
template <typename T, int F>
__host__ __device__ constexpr int row_bytes() { return F * int(sizeof(T)); }

// Samples per thread: as many as kSamples whose loads fit kLoadRegs.
template <typename T, int F, int D>
__host__ __device__ constexpr int samples_per_thread() {
  constexpr int words = (row_bytes<T, F>() + 3) / 4;
  constexpr int n = kLoadRegs / ((1 << D) * words);
  return n < 1 ? 1 : (n < kSamples ? n : kSamples);
}

// The raw bits of one table row as one load fetches them (a vector of 2,
// 4, 8 or 16 bytes, two of 16 for 32-byte rows, else F elements).
template <typename T, int F>
struct RawRow {
  static constexpr int kBytes = row_bytes<T, F>();
  using V = std::conditional_t<
      kBytes == 2, unsigned short,
      std::conditional_t<kBytes == 4, unsigned int,
                         std::conditional_t<kBytes == 8, uint2,
                                            std::conditional_t<kBytes == 16, uint4, void>>>>;
  using Store = std::conditional_t<std::is_void_v<V>, std::conditional_t<kBytes == 32, uint4[2], T[F]>, V>;
  Store bits;

  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (kBytes == 32) {
      bits[0] = __ldg(reinterpret_cast<const uint4*>(p));
      bits[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    } else if constexpr (!std::is_void_v<V>) {
      bits = __ldg(reinterpret_cast<const V*>(p));
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) bits[f] = p[f];
    }
  }
  __device__ __forceinline__ void get(float (&v)[F]) const {
    const T* e = reinterpret_cast<const T*>(&bits);
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = to_f32(e[f]);
  }
};

// One level for S samples: every row of every corner first, then every
// load, then the fp32 sums over corners 0 .. 2^D-1 in order (the plain
// version's order).  With kMask, a sample not `live` on the level loads
// nothing and keeps acc.
template <typename T, int D, int F, int S, bool kMask>
__device__ __forceinline__ void encode_level(const int32_t* lp, const float (&xv)[S][D],
                                             const bool (&live)[S],
                                             const T* __restrict__ table, const HashConsts& hc,
                                             int interp, float (&acc)[S][F]) {
  constexpr int C = 1 << D;
  const bool pow2 = (uint32_t(lp[1]) & (uint32_t(lp[1]) - 1)) == 0;
  float w1[S][D];
  uint32_t rows[S][C];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const LevelCorners<D> lc(lp, xv[s], interp);
#pragma unroll
    for (int d = 0; d < D; ++d) w1[s][d] = lc.w1[d];
    lc.rows(hc, pow2, rows[s]);
  }
  RawRow<T, F> raw[S][C];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (!kMask || live[s]) raw[s][c].load(table + int64_t(rows[s][c]) * F);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (kMask && !live[s]) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v[F];
      raw[s][c].get(v);
      const float w = corner_weight<D>(w1[s], c);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[s][f] = __fadd_rn(acc[s][f], __fmul_rn(w, v[f]));
    }
  }
}

// Levels per thread where the output is AoS: as many as fill a 32-byte
// sector of a sample's row (8 at bf16, F = 2), so that whole sectors are
// written.
template <typename T, int F>
__host__ __device__ constexpr int aos_levels() {
  constexpr int rb = row_bytes<T, F>();
  return (kAosSectors && rb < 32 && 32 % rb == 0) ? 32 / rb : 1;
}

// The 32-bit words of N values of T, in memory order.
template <typename T, int N>
__device__ __forceinline__ uint32_t packed_word(const T (&v)[N], int k) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v[k]);
  } else {
    return uint32_t(__bfloat16_as_ushort(v[2 * k])) |
           uint32_t(__bfloat16_as_ushort(v[2 * k + 1])) << 16;
  }
}

// Thread (blockIdx.x, threadIdx.x) takes samples b0 + s·kGridThreads,
// s < S, on the G levels [blockIdx.y·G, +G), reading x once for them: a
// warp shares each level's constants.  With G = 1 (SoA output) it writes
// 32 consecutive samples of an SoA row; with G levels of AoS output
// (``sectors``: rows 32-byte aligned, every group full) the two lanes of a
// pair of samples swap halves so that each 16-byte store of a warp fills
// whole sectors.  With kMask, level_frac holds the samples' level
// fractions.
template <typename T, int D, int F, int G, bool kMask>
__global__ void __launch_bounds__(kGridThreads)
grid_encode_fwd_kernel(const float* __restrict__ x, const float* __restrict__ level_frac,
                       const T* __restrict__ table,
                       const int32_t* __restrict__ level_params, int n_levels,
                       T* __restrict__ out, int64_t batch, int64_t x_stride_b,
                       int64_t out_stride_b, int64_t out_stride_f, HashConsts hc,
                       int interp, bool sectors) {
  constexpr int S = samples_per_thread<T, F, D>();
  const int64_t b0 = int64_t(blockIdx.x) * (kGridThreads * S) + threadIdx.x;
  float xv[S][D];
  float thr[S];   // kMask: the levels below thr[s] are sample s's
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int64_t b = b0 + int64_t(s) * kGridThreads;
#pragma unroll
    for (int d = 0; d < D; ++d) xv[s][d] = b < batch ? x[b * x_stride_b + d] : 0.0f;
    if constexpr (kMask)
      thr[s] = b < batch ? level_threshold(level_frac[b], n_levels) : 0.0f;
  }
  T res[S][G * F];
#pragma unroll
  for (int li = 0; li < G; ++li) {
    const int level = blockIdx.y * G + li;
    float acc[S][F];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[s][f] = 0.0f;
    // Below max_level; above it (and past the last level) zeros.
    if (level < n_levels && level_params[level * kLevelFields + 4] != 0) {
      bool live[S];
#pragma unroll
      for (int s = 0; s < S; ++s) live[s] = !kMask || float(level) < thr[s];
      encode_level<T, D, F, S, kMask>(level_params + level * kLevelFields, xv, live, table, hc,
                                      interp, acc);
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int f = 0; f < F; ++f) res[s][li * F + f] = from_f32<T>(acc[s][f]);
  }
  if constexpr (G > 1) {
    if (sectors) {
      const bool odd = threadIdx.x & 1;   // b0's parity: the partner is sample b ^ 1
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int64_t b = b0 + int64_t(s) * kGridThreads;
        const uint4 lo = make_uint4(packed_word(res[s], 0), packed_word(res[s], 1),
                                    packed_word(res[s], 2), packed_word(res[s], 3));
        const uint4 hi = make_uint4(packed_word(res[s], 4), packed_word(res[s], 5),
                                    packed_word(res[s], 6), packed_word(res[s], 7));
        const uint4 give = odd ? lo : hi;
        const uint4 got = make_uint4(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                     __shfl_xor_sync(0xffffffffu, give.y, 1),
                                     __shfl_xor_sync(0xffffffffu, give.z, 1),
                                     __shfl_xor_sync(0xffffffffu, give.w, 1));
        // The even sample's row takes (even lo, even hi), the odd one's
        // (odd lo, odd hi): the even lane stores the low halves, the odd
        // lane the high ones.
        const int64_t even = b & ~int64_t(1), col = int64_t(blockIdx.y) * G * F;
        uint4* const e = reinterpret_cast<uint4*>(out + even * out_stride_b + col) + odd;
        uint4* const o = reinterpret_cast<uint4*>(out + (even + 1) * out_stride_b + col) + odd;
        if (even < batch) *e = odd ? got : lo;
        if (even + 1 < batch) *o = odd ? hi : got;
      }
      return;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int64_t b = b0 + int64_t(s) * kGridThreads;
    if (b >= batch) continue;
#pragma unroll
    for (int li = 0; li < G; ++li) {
      const int level = blockIdx.y * G + li;
      if (level >= n_levels) break;
      T* o = out + b * out_stride_b + int64_t(level) * F * out_stride_f;
#pragma unroll
      for (int f = 0; f < F; ++f) o[f * out_stride_f] = res[s][li * F + f];
    }
  }
}

template <typename T>
struct FwdLaunch {
  const float* x;
  const float* level_frac;   // null: no per-sample mask
  const void* table;
  const int32_t* level_params;
  void* out;
  int64_t batch;
  int n_levels;
  int64_t x_stride_b, out_stride_b, out_stride_f;
  HashConsts hc;
  int interp;
  cudaStream_t stream;

  template <int D, int F, int G>
  cudaError_t launch(bool sectors) const {
    constexpr int64_t per_cta = int64_t(kGridThreads) * samples_per_thread<T, F, D>();
    const dim3 grid(unsigned((batch + per_cta - 1) / per_cta), unsigned((n_levels + G - 1) / G));
    if (level_frac)
      grid_encode_fwd_kernel<T, D, F, G, true><<<grid, kGridThreads, 0, stream>>>(
          x, level_frac, static_cast<const T*>(table), level_params, n_levels,
          static_cast<T*>(out), batch, x_stride_b, out_stride_b, out_stride_f, hc, interp,
          sectors);
    else
      grid_encode_fwd_kernel<T, D, F, G, false><<<grid, kGridThreads, 0, stream>>>(
          x, nullptr, static_cast<const T*>(table), level_params, n_levels,
          static_cast<T*>(out), batch, x_stride_b, out_stride_b, out_stride_f, hc, interp,
          sectors);
    return cudaSuccess;
  }

  template <int D, int F>
  cudaError_t run() const {
    constexpr int G = aos_levels<T, F>();
    if (G > 1 && out_stride_f == 1) {
      const bool sectors = (out_stride_b * int64_t(sizeof(T))) % 32 == 0 &&
                           (reinterpret_cast<uintptr_t>(out) & 31) == 0 && n_levels % G == 0;
      return launch<D, F, G>(sectors);
    }
    return launch<D, F, 1>(false);
  }
};

// Rng grids, 5 to 7 dims and F > 8 (WideCorners): thread (blockIdx.x,
// threadIdx.x) takes one sample on level blockIdx.y, its 2^D corners in a
// loop, each row in full and loaded as it is used; F, the table's dtype and
// D at run time, one instance per kGroups.  The sum over the corners in
// order 0 .. 2^D-1 in fp32, as the D <= 4 instances; in shard mode over the
// corners the shard holds.  With kGroups (F > 8) blockIdx.z is the group of
// features [8z, 8z + 8), each group's sums those of a run of 8 features of
// a row of F: a feature's sum is the same whatever group holds it (GB and GI
// run every F in one instance; one for both here ran G's F <= 8 shapes in
// shard mode 12 % slower on an H100, chip_smoke.py across two runs).  With
// the uniforms u (n_levels, batch) of stochastic interpolation, the
// stochastic gather: each (sample, level) reads its one corner
// (WideCorners::stochastic_corner, GB's pick) at weight 1.
template <bool kGroups>
__global__ void __launch_bounds__(kGridThreads)
grid_encode_fwd_wide_kernel(const float* __restrict__ x, const float* __restrict__ level_frac,
                            const void* __restrict__ table, bool bf16,
                            const int32_t* __restrict__ level_params, int n_levels,
                            void* __restrict__ out, int64_t batch, int n_dims, int n_features,
                            int64_t x_stride_b, int64_t out_stride_b, int64_t out_stride_f,
                            HashConsts hc, int interp, bool sharded,
                            const float* __restrict__ u) {
  const int64_t b = int64_t(blockIdx.x) * kGridThreads + threadIdx.x;
  const int level = blockIdx.y;
  if (b >= batch) return;
  // this launch's features of the row: [g0, g0 + nf)
  const int g0 = kGroups ? int(blockIdx.z) * kFeatureGroup : 0;
  const int nf = kGroups ? min(kFeatureGroup, n_features - g0) : n_features;
  const int32_t* lp = level_params + level * kLevelFields;
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const bool live = lp[4] != 0 &&
      (!level_frac || float(level) < level_threshold(level_frac[b], n_levels));
  if (live) {
    const WideCorners lc(lp, x + b * x_stride_b, n_dims, interp);
    const int pick = u ? lc.stochastic_corner(u[int64_t(level) * batch + b]) : -1;
    for (int c = 0; c < (1 << n_dims); ++c) {
      if (u && c != pick) continue;
      const uint32_t r = lc.row(c, hc);
      if (sharded && !shard_owns(lp, r)) continue;
      const float w = u ? 1.0f : lc.weight(c);
      const int64_t row = int64_t(r) * n_features + g0;
      if constexpr (kGroups) {   // the group's features in loads of four
        float v[8];
        load_group(table, bf16, row, nf, n_features, v);
#pragma unroll
        for (int f = 0; f < 8; ++f)
          if (f < nf) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[f]));
      } else {
#pragma unroll
        for (int f = 0; f < 8; ++f)
          if (f < nf)
            acc[f] = __fadd_rn(acc[f], __fmul_rn(w, load_any(table, bf16, row + f)));
      }
    }
  }
  const int64_t o = b * out_stride_b + (int64_t(level) * n_features + g0) * out_stride_f;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    if (f >= nf) break;
    if (bf16 && !sharded)
      static_cast<__nv_bfloat16*>(out)[o + f * out_stride_f] = __float2bfloat16_rn(acc[f]);
    else
      static_cast<float*>(out)[o + f * out_stride_f] = acc[f];
  }
}

}  // namespace

cudaError_t grid_encode_fwd_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const int32_t* level_params, void* out, int64_t batch, int n_dims,
    int n_levels, int n_features, int64_t out_stride_b, int64_t out_stride_f,
    const uint32_t hash_factors[7], int hash_kind, int interp, bool sharded, const float* u,
    cudaStream_t stream) {
  if (batch <= 0 || n_levels <= 0 || n_levels > 65535 || interp < 0 || interp > 2 ||
      x_stride_b < n_dims || n_dims < 1 || n_dims > kMaxDims || n_features < 1 ||
      (u && sharded))
    return cudaErrorInvalidValue;
  const HashConsts hc = make_hash_consts(hash_factors, hash_kind);
  if (sharded || u || wide_instance(n_dims, hash_kind, n_features)) {
    const auto kernel = n_features > kFeatureGroup ? grid_encode_fwd_wide_kernel<true>
                                                   : grid_encode_fwd_wide_kernel<false>;
    const dim3 grid(unsigned((batch + kGridThreads - 1) / kGridThreads), unsigned(n_levels),
                    unsigned((n_features + kFeatureGroup - 1) / kFeatureGroup));
    kernel<<<grid, kGridThreads, 0, stream>>>(
        x, level_frac, table, table_bf16, level_params, n_levels, out, batch, n_dims,
        n_features, x_stride_b, out_stride_b, out_stride_f, hc, interp, sharded, u);
    return cudaGetLastError();
  }
  if (table_bf16)
    return dispatch_df(n_dims, n_features,
                       FwdLaunch<__nv_bfloat16>{x, level_frac, table, level_params, out, batch,
                                                n_levels, x_stride_b, out_stride_b,
                                                out_stride_f, hc, interp, stream});
  return dispatch_df(n_dims, n_features,
                     FwdLaunch<float>{x, level_frac, table, level_params, out, batch, n_levels,
                                      x_stride_b, out_stride_b, out_stride_f, hc, interp,
                                      stream});
}

}  // namespace tcnn_tpu_torch

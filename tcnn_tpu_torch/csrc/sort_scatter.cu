// Kernels SK and SS: the grid's first-order table gradient by sort and
// segment sum, deterministic by construction.  The counterpart of
// tcnn_tpu/ops/sort_scatter.py::sort_segment_scatter and of the
// TCNN_TPU_SCATTER=sortseg branch of _grid_interpolate_vjp_bwd
// (tcnn_tpu/ops/grid_ops.py:962-977), which the JAX package also takes on
// every GPU backend: "deterministic there too, unlike XLA's atomic GPU
// scatter-add".  Kernel GB (grid_encode_bwd.cu) computes the same sums
// with fp32 atomics, whose order, and so whose last bits, change from run
// to run.
//
// Neither kernel replaces a TPU kernel: JAX forms the route in XLA ops
// (argsort, cumsum, one scatter), outside any pallas_call.  The route is
//   SK: every update (live level l, corner c, sample b), in JAX's (l, c, b)
//       order (idx3.reshape(-1), grid_ops.py:974-977), as an int32 row key
//       and F fp32 values w_c * dy;
//   torch.sort(keys, stable=True): each row's updates stay in that order
//       (the counterpart of jnp.argsort, an XLA op outside any kernel);
//   SS: each row's run of updates summed in an order fixed by the sorted
//       positions, each touched row written once, no atomics.
//
// SK: bound by the bytes it writes, M = L*C*B keys and M*F values (at
// config_btf, 2^18 samples, 16 levels, 16 corners, F = 2: 805 MB, 0.24 ms
// at 3.35 TB/s).  A thread per sample reads its x once and walks the
// levels in order, so a level's position among the live levels is a
// running count; neighbouring threads are neighbouring samples, whose
// updates are neighbours in (l, c, b) order, so every store is coalesced,
// and a corner's F values go out as one vector store where 4F bytes allow.
// The corners' rows and weights are kernel GB's (grid_common.cuh, the same
// f32 level geometry, __fmul_rn/__fadd_rn rounding, uint32 wrap, fastmod
// and hash kinds): the 1- to 4-D instances (LevelCorners<D>, every row
// from 2D terms) for D <= 4, F <= 8 and the prime hashes; the run-time-D
// instance (WideCorners) for 5-7 dims, Rng, F > 8 and, as in GB,
// stochastic interpolation's one-hot corner from the uniforms u.  Either
// way its keys and values equal the plain version's
// (build_indices_weights(scatter=True) and the products) bit for bit.  An
// update that adds nothing, a (sample, level) the per-sample mask drops or
// (shard mode) a corner another rank's shard holds, gets the key n_rows,
// past the last row: it sorts to the end and SS skips it.  Its value is
// 0 * dy, as the plain version forms it.
//
// SS: given the sorted keys and the sort's permutation `order`, the value
// of sorted position i is vals[order[i]].  Bound: the keys, the
// permutation and the values read once (16 bytes an update at F = 2) and
// the table written.  The values are gathered through the permutation,
// one random 4F-byte read per update, which costs a 32-byte sector; the
// sorted positions of one level only gather from that level's slice of
// vals (8.4 MB at config_hash, 33.5 MB at config_btf), so a walk of the
// positions in order keeps the gather in the 50 MB L2.  Pass 1, a CTA per
// tile of kSsTile consecutive sorted positions, the tiles in block order:
//   * each thread holds kSsItems consecutive positions, their keys and
//     permutation entries loaded as 16-byte vectors (a warp reads 1 KB of
//     keys and 2 KB of the permutation, coalesced), and issues all its
//     gathers, a vector over F where 4F bytes allow, before any add;
//   * a segmented sum over the tile: each thread adds its own items in
//     order, a segmented scan on the run heads across the warp by
//     shuffles, then across the warps through shared memory, so the sum
//     of each run is fixed by the positions and the tile size alone;
//   * a run that starts and ends in the tile is written to its row, in the
//     table's dtype (one rounding from its fp32 sum, as
//     _finish_interp_bwd casts, grid_ops.py:1102), by the thread that
//     holds its end; a run of an invalid key (n_rows, or below 0) is
//     skipped and its values are never gathered;
//   * the tile's first run, where it goes on from the tile before, writes
//     its partial to head[t]; its last, where it goes on past the tile,
//     to tail[t].
// Pass 2, a thread per tile whose last run starts in it and goes on past
// its end: that run's tail, then the heads of the tiles it covers, in tile
// order, and the row.  A coarse row's run of thousands of updates
// (config_hash level 0: about 2^20 updates on fewer than 300 rows) costs
// pass 2 one add per tile.  No key is searched for on the host, so the
// route stays capturable in a CUDA graph.  The table is zeroed first (a
// row no update reached stays an exact 0); no fp32 copy of a bf16 table
// and no cast pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"

namespace tcnn_tpu_torch {
namespace {

constexpr int kSkThreads = 256;
constexpr int kSsThreads = 256;
constexpr int kSsItems = 8;                      // sorted positions a thread of SS holds
constexpr int kSsTile = kSsThreads * kSsItems;   // sorted positions a CTA of SS holds
constexpr int kSsWarps = kSsThreads / 32;

// A vector of kBytes bytes, for the loads and stores of a row of values.
template <int kBytes> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned int; };
template <> struct Vec<2> { using T = unsigned short; };

// The widest vector that divides a row of kRow bytes: a row starting at a
// multiple of kRow bytes from an aligned base is then aligned to it.
template <int kRow>
__host__ __device__ constexpr int vec_bytes() {
  return kRow % 16 == 0 ? 16 : kRow % 8 == 0 ? 8 : kRow % 4 == 0 ? 4 : 2;
}

// The N fp32 values at p, in vectors.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[N]) {
  constexpr int kBytes = vec_bytes<4 * N>(), kPer = kBytes / 4;
  using V = typename Vec<kBytes>::T;
#pragma unroll
  for (int j = 0; j < N / kPer; ++j) {
    const V raw = __ldg(reinterpret_cast<const V*>(p) + j);
    const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int u = 0; u < kPer; ++u) v[j * kPer + u] = e[u];
  }
}

// v, N values, to p as T (each rounded once), in vectors.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[N]) {
  constexpr int kBytes = vec_bytes<int(sizeof(T)) * N>(), kPer = kBytes / int(sizeof(T));
  using V = typename Vec<kBytes>::T;
#pragma unroll
  for (int j = 0; j < N / kPer; ++j) {
    V raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int u = 0; u < kPer; ++u) e[u] = from_f32<T>(v[j * kPer + u]);
    reinterpret_cast<V*>(p)[j] = raw;
  }
}

struct SkParams {
  const float* x;
  int64_t x_stride_b;
  const float* level_frac;   // null: no per-sample mask
  int n_levels;
  const void* dcols;
  bool dcols_bf16;
  int64_t dc_stride_b, dc_stride_f;
  const int32_t* level_params;
  HashConsts hc;
  int interp;
  bool sharded;
  const float* u;            // stochastic interpolation's uniforms, or null
  int n_dims, n_features;
  int64_t batch;
  int32_t sentinel;          // the key of an update that adds nothing: n_rows
  int32_t* keys;
  float* vals;
};

// The 1- to 4-D instances: a thread per sample b over the live levels in
// order, every corner's row from LevelCorners<D>::rows, a corner's F
// values in one vector store where 4F bytes allow.
template <int D, int F>
__global__ void __launch_bounds__(kSkThreads) sort_keys_kernel(SkParams a) {
  constexpr int C = 1 << D;
  const int64_t b = int64_t(blockIdx.x) * kSkThreads + threadIdx.x;
  if (b >= a.batch) return;
  float xv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xv[d] = __ldg(a.x + b * a.x_stride_b + d);
  const float thr = a.level_frac ? level_threshold(__ldg(a.level_frac + b), a.n_levels) : 0.0f;
  int p = 0;   // the level's position among the live levels
  for (int level = 0; level < a.n_levels; ++level) {
    const int32_t* lp = a.level_params + level * kLevelFields;
    if (!lp[4]) continue;   // a dead level has no updates
    const bool keep = !a.level_frac || float(level) < thr;
    float dy[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      dy[f] = load_any(a.dcols, a.dcols_bf16,
                       b * a.dc_stride_b + (int64_t(level) * F + f) * a.dc_stride_f);
    const LevelCorners<D> lc(lp, xv, a.interp);
    uint32_t r[C];
    lc.rows(a.hc, (uint32_t(lp[1]) & (uint32_t(lp[1]) - 1)) == 0, r);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool on = keep && (!a.sharded || shard_owns(lp, r[c]));
      const float w = on ? lc.weight(c) : 0.0f;
      const int64_t m = (int64_t(p) * C + c) * a.batch + b;
      a.keys[m] = on ? int32_t(r[c]) : a.sentinel;
      float v[F];
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = __fmul_rn(w, dy[f]);
      store_vec<float, F>(a.vals + m * F, v);
    }
    ++p;
  }
}

// The run-time-D instance (5-7 dims, Rng, F > 8, stochastic
// interpolation): a thread per sample b over the live levels in order, a
// level's features in groups of at most 8, each group over every corner
// again (one group where F <= 8); the keys are written with the first
// group.
__global__ void __launch_bounds__(kSkThreads) sort_keys_wide_kernel(SkParams a) {
  const int64_t b = int64_t(blockIdx.x) * kSkThreads + threadIdx.x;
  if (b >= a.batch) return;
  const float thr = a.level_frac ? level_threshold(a.level_frac[b], a.n_levels) : 0.0f;
  const int C = 1 << a.n_dims, F = a.n_features;
  int p = 0;   // the level's position among the live levels
  for (int level = 0; level < a.n_levels; ++level) {
    const int32_t* lp = a.level_params + level * kLevelFields;
    if (!lp[4]) continue;
    const bool keep = !a.level_frac || float(level) < thr;
    const WideCorners lc(lp, a.x + b * a.x_stride_b, a.n_dims, a.interp);
    const int pick = a.u ? lc.stochastic_corner(a.u[int64_t(level) * a.batch + b]) : -1;
    for (int g0 = 0; g0 < F; g0 += kFeatureGroup) {
      const int nf = min(kFeatureGroup, F - g0);
      float dy[kFeatureGroup];
#pragma unroll
      for (int f = 0; f < kFeatureGroup; ++f)
        dy[f] = f < nf ? load_any(a.dcols, a.dcols_bf16,
                                  b * a.dc_stride_b + (int64_t(level) * F + g0 + f) * a.dc_stride_f)
                       : 0.0f;
      for (int c = 0; c < C; ++c) {
        const uint32_t r = lc.row(c, a.hc);
        const bool on = keep && (!a.sharded || shard_owns(lp, r));
        float w = pick < 0 ? lc.weight(c) : (c == pick ? 1.0f : 0.0f);
        if (!on) w = 0.0f;
        const int64_t m = (int64_t(p) * C + c) * a.batch + b;
        if (g0 == 0) a.keys[m] = on ? int32_t(r) : a.sentinel;
        float* v = a.vals + m * F + g0;
#pragma unroll
        for (int f = 0; f < kFeatureGroup; ++f)
          if (f < nf) v[f] = __fmul_rn(w, dy[f]);
      }
    }
    ++p;
  }
}

struct SkLaunch {
  SkParams a;
  cudaStream_t stream;
  template <int D, int F>
  cudaError_t run() const {
    const unsigned blocks = unsigned((a.batch + kSkThreads - 1) / kSkThreads);
    sort_keys_kernel<D, F><<<blocks, kSkThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
};

struct SsParams {
  const int32_t* keys;   // sorted
  const int64_t* order;  // sorted position -> update
  const float* vals;     // (m, n_features), update-major
  int64_t m, n_rows, n_tiles;
  int n_features;
  float* head;           // (n_tiles, n_features)
  float* tail;           // (n_tiles, n_features)
  void* out;             // (n_rows, n_features), zeroed: bf16 (out_bf16) or fp32
  bool out_bf16;
};

__device__ __forceinline__ bool valid_row(int32_t key, int64_t n_rows) {
  return key >= 0 && int64_t(key) < n_rows;
}

// Features [g0, g0 + nf) of `dst` row `row` (row width n_features): one
// vector store where the group is the whole row (kGroups false, G = F).
template <typename T, int G, bool kGroups>
__device__ __forceinline__ void store_group(T* dst, int64_t row, int n_features, int g0, int nf,
                                            const float (&v)[G]) {
  T* p = dst + row * n_features + g0;
  if constexpr (!kGroups) {
    store_vec<T, G>(p, v);
  } else {
#pragma unroll
    for (int f = 0; f < G; ++f)
      if (f < nf) p[f] = from_f32<T>(v[f]);
  }
}

// Pass 1: a CTA per tile of kSsTile sorted positions, kSsItems a thread.
// G features a group: G = F (kGroups false, F <= 8), or groups of 8 over a
// run-time F (kGroups true, F > 8).
template <int G, bool kGroups>
__global__ void __launch_bounds__(kSsThreads) segment_sum_tiles_kernel(SsParams a) {
  __shared__ int warp_start[kSsWarps];
  __shared__ float warp_sum[kSsWarps][G];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x, i0 = tile * kSsTile, i1 = min(i0 + kSsTile, a.m);
  const int r0 = threadIdx.x * kSsItems;   // the thread's first position in the tile
  const int64_t p0 = i0 + r0;
  int32_t key[kSsItems];
  int64_t src[kSsItems];
  if (p0 + kSsItems <= a.m) {   // 16-byte vectors: 2 of keys, 4 of the permutation
#pragma unroll
    for (int j = 0; j < kSsItems / 4; ++j) {
      const int4 k4 = __ldg(reinterpret_cast<const int4*>(a.keys + p0) + j);
      key[4 * j] = k4.x;
      key[4 * j + 1] = k4.y;
      key[4 * j + 2] = k4.z;
      key[4 * j + 3] = k4.w;
    }
#pragma unroll
    for (int j = 0; j < kSsItems / 2; ++j) {
      const longlong2 o = __ldg(reinterpret_cast<const longlong2*>(a.order + p0) + j);
      src[2 * j] = o.x;
      src[2 * j + 1] = o.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSsItems; ++k) {
      key[k] = p0 + k < a.m ? __ldg(a.keys + p0 + k) : 0;
      src[k] = p0 + k < a.m ? __ldg(a.order + p0 + k) : 0;
    }
  }
  // the keys either side of the thread's positions
  int32_t prev = __shfl_up_sync(0xffffffffu, key[kSsItems - 1], 1);
  int32_t next = __shfl_down_sync(0xffffffffu, key[0], 1);
  if (lane == 0) prev = p0 > 0 && p0 - 1 < a.m ? __ldg(a.keys + p0 - 1) : 0;
  if (lane == 31) next = p0 + kSsItems < a.m ? __ldg(a.keys + p0 + kSsItems) : 0;
  // head: a run starts at the position (the tile's first position starts
  // one for the sum); end: a run ends there or the tile does; past: the run
  // ending the tile goes on past it; live: a valid key, its value gathered
  bool head[kSsItems], end[kSsItems], past[kSsItems], live[kSsItems];
#pragma unroll
  for (int k = 0; k < kSsItems; ++k) {
    const int64_t p = p0 + k;
    const int32_t before = k ? key[k - 1] : prev, after = k + 1 < kSsItems ? key[k + 1] : next;
    head[k] = r0 + k == 0 || p >= a.m || key[k] != before;
    end[k] = p < a.m && (p + 1 == i1 || key[k] != after);
    past[k] = p + 1 == i1 && i1 < a.m && key[k] == after;
    live[k] = p < a.m && valid_row(key[k], a.n_rows);
  }
  // the tile's first run goes on from the tile before
  const bool from_before = tile > 0 && __ldg(a.keys + i0 - 1) == __ldg(a.keys + i0);

  const int F = kGroups ? a.n_features : G;
  for (int g0 = 0; g0 < F; g0 += G) {
    const int nf = kGroups ? min(G, F - g0) : G;
    float v[kSsItems][G];
#pragma unroll
    for (int k = 0; k < kSsItems; ++k) {   // every gather before any add
      if (!live[k]) {
#pragma unroll
        for (int f = 0; f < G; ++f) v[k][f] = 0.0f;
      } else if constexpr (kGroups) {
        load_group(a.vals, false, src[k] * F + g0, nf, F, v[k]);
      } else {
        load_vec<G>(a.vals + src[k] * G, v[k]);
      }
    }
    // 1. the thread's own items in order: the sum of its last run and the
    //    tile position where that run starts (-1: before the thread)
    int start = -1;
    float sum[G];
#pragma unroll
    for (int k = 0; k < kSsItems; ++k) {
      if (head[k]) start = r0 + k;
#pragma unroll
      for (int f = 0; f < G; ++f) sum[f] = head[k] || k == 0 ? v[k][f] : sum[f] + v[k][f];
    }
    // 2. a segmented inclusive scan across the warp: (start, sum) of the
    //    open run at the end of lanes 0 .. lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int s_up = __shfl_up_sync(0xffffffffu, start, d);
      float x_up[G];
#pragma unroll
      for (int f = 0; f < G; ++f) x_up[f] = __shfl_up_sync(0xffffffffu, sum[f], d);
      if (lane >= d && start < 0) {
        start = s_up;
#pragma unroll
        for (int f = 0; f < G; ++f) sum[f] = x_up[f] + sum[f];
      }
    }
    // 3. across the warps: each warp's open run, folded in warp order
    if (lane == 31) {
      warp_start[warp] = start;
#pragma unroll
      for (int f = 0; f < G; ++f) warp_sum[warp][f] = sum[f];
    }
    __syncthreads();
    int carry_start = -1;
    float carry[G];
#pragma unroll
    for (int f = 0; f < G; ++f) carry[f] = 0.0f;
    for (int w = 0; w < warp; ++w) {   // warp 0 starts the tile's first run
      const bool starts = warp_start[w] >= 0;
      if (starts) carry_start = warp_start[w];
#pragma unroll
      for (int f = 0; f < G; ++f) carry[f] = starts ? warp_sum[w][f] : carry[f] + warp_sum[w][f];
    }
    __syncthreads();   // warp_* are read; the next group may write them
    // the open run before the thread: the warps before, then lanes 0 .. lane-1
    int ex_start = __shfl_up_sync(0xffffffffu, start, 1);
    float ex[G];
#pragma unroll
    for (int f = 0; f < G; ++f) ex[f] = __shfl_up_sync(0xffffffffu, sum[f], 1);
    if (lane == 0 || ex_start < 0) {
#pragma unroll
      for (int f = 0; f < G; ++f) ex[f] = lane == 0 ? carry[f] : carry[f] + ex[f];
      ex_start = carry_start;
    }
    // each run that ends in the thread: its total, to its row or to scratch
    int run_start = ex_start;
    float run[G];
#pragma unroll
    for (int k = 0; k < kSsItems; ++k) {
      if (head[k]) run_start = r0 + k;
#pragma unroll
      for (int f = 0; f < G; ++f) run[f] = head[k] || k == 0 ? v[k][f] : run[f] + v[k][f];
      if (!end[k] || !live[k]) continue;
      float total[G];
#pragma unroll
      for (int f = 0; f < G; ++f) total[f] = run_start < r0 ? ex[f] + run[f] : run[f];
      if (run_start == 0 && from_before) {
        store_group<float, G, kGroups>(a.head, tile, F, g0, nf, total);
      } else if (past[k]) {
        store_group<float, G, kGroups>(a.tail, tile, F, g0, nf, total);
      } else if (a.out_bf16) {
        store_group<__nv_bfloat16, G, kGroups>(static_cast<__nv_bfloat16*>(a.out), key[k], F,
                                               g0, nf, total);
      } else {
        store_group<float, G, kGroups>(static_cast<float*>(a.out), key[k], F, g0, nf, total);
      }
    }
  }
}

// Pass 2: a thread per tile whose last run starts in it and goes on past
// its end: that run's tail, then the heads of the tiles it covers, in
// order, per feature.
__global__ void __launch_bounds__(kSsThreads) segment_sum_runs_kernel(SsParams a) {
  const int64_t s = int64_t(blockIdx.x) * kSsThreads + threadIdx.x;
  if (s >= a.n_tiles - 1) return;   // the last tile's runs all end in it
  const int64_t i0 = s * kSsTile, i1 = i0 + kSsTile;
  const int32_t key = a.keys[i1 - 1];
  if (a.keys[i1] != key || (s > 0 && a.keys[i0 - 1] == key) || !valid_row(key, a.n_rows))
    return;   // no run goes on, the run is an earlier tile's, or it is skipped
  const int F = a.n_features;
  for (int f = 0; f < F; ++f) {
    float acc = a.tail[s * F + f];
    for (int64_t k = s + 1; k < a.n_tiles; ++k) {
      acc += a.head[k * F + f];
      const int64_t end = min((k + 1) * kSsTile, a.m);
      if (end == a.m || a.keys[end] != key) break;   // the run ends in tile k
    }
    const int64_t i = int64_t(key) * F + f;
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(acc);
    else
      static_cast<float*>(a.out)[i] = acc;
  }
}

template <int G, bool kGroups>
cudaError_t launch_tiles(const SsParams& a, cudaStream_t stream) {
  segment_sum_tiles_kernel<G, kGroups><<<unsigned(a.n_tiles), kSsThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

cudaError_t sort_keys_launch(const float* x, int64_t x_stride_b, const float* level_frac,
                             const void* dcols, bool dcols_bf16, int64_t dc_stride_b,
                             int64_t dc_stride_f, const int32_t* level_params, int n_levels,
                             int64_t batch, int n_dims, int n_features,
                             const uint32_t hash_factors[7], int hash_kind, int interp,
                             bool sharded, const float* u, int32_t sentinel, int32_t* keys,
                             float* vals, cudaStream_t stream) {
  if (batch < 0 || n_levels <= 0 || n_dims < 1 || n_dims > kMaxDims || n_features < 1 ||
      interp < 0 || interp > 2 || x_stride_b < n_dims || sentinel < 0 ||
      (sharded && u != nullptr) || !aligned16(vals))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const SkParams a{x, x_stride_b, level_frac, n_levels, dcols, dcols_bf16, dc_stride_b,
                   dc_stride_f, level_params, make_hash_consts(hash_factors, hash_kind),
                   interp, sharded, u, n_dims, n_features, batch, sentinel, keys, vals};
  if (!wide_instance(n_dims, hash_kind, n_features) && u == nullptr)
    return dispatch_df(n_dims, n_features, SkLaunch{a, stream});
  sort_keys_wide_kernel<<<unsigned((batch + kSkThreads - 1) / kSkThreads), kSkThreads, 0,
                          stream>>>(a);
  return cudaGetLastError();
}

cudaError_t segment_sum_launch(const int32_t* keys, const int64_t* order, const float* vals,
                               int64_t m, int n_features, int64_t n_rows, float* scratch,
                               void* out, bool out_bf16, cudaStream_t stream) {
  if (m < 0 || n_features < 1 || n_rows < 1 || n_rows > INT_MAX || !aligned16(keys) ||
      !aligned16(order) || !aligned16(vals) || !aligned16(scratch) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      out, 0, size_t(n_rows * n_features) * (out_bf16 ? sizeof(__nv_bfloat16) : sizeof(float)),
      stream);
  if (err != cudaSuccess || m == 0) return err;
  const int64_t n_tiles = (m + kSsTile - 1) / kSsTile;
  const SsParams a{keys, order, vals, m, n_rows, n_tiles, n_features,
                   scratch, scratch + n_tiles * n_features, out, out_bf16};
  switch (n_features) {
    case 1: err = launch_tiles<1, false>(a, stream); break;
    case 2: err = launch_tiles<2, false>(a, stream); break;
    case 3: err = launch_tiles<3, false>(a, stream); break;
    case 4: err = launch_tiles<4, false>(a, stream); break;
    case 5: err = launch_tiles<5, false>(a, stream); break;
    case 6: err = launch_tiles<6, false>(a, stream); break;
    case 7: err = launch_tiles<7, false>(a, stream); break;
    case 8: err = launch_tiles<8, false>(a, stream); break;
    default: err = launch_tiles<kFeatureGroup, true>(a, stream);
  }
  if (err != cudaSuccess || n_tiles == 1) return err;
  segment_sum_runs_kernel<<<unsigned((n_tiles - 1 + kSsThreads - 1) / kSsThreads), kSsThreads,
                            0, stream>>>(a);
  return cudaGetLastError();
}

// The scratch of segment_sum_launch: head and tail, n_tiles * n_features
// floats each.
int64_t segment_sum_scratch_floats(int64_t m, int n_features) {
  return 2 * ((m + kSsTile - 1) / kSsTile) * n_features;
}

}  // namespace tcnn_tpu_torch

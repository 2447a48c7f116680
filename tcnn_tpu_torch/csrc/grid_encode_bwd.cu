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
// here, as in the CUDA original's kernel_grid_backward (grid.h:214-320),
// a thread per (sample, level) recomputes the corner rows and weights
// exactly as kernel G does (grid_common.cuh: the same __fmul_rn/__fadd_rn
// rounding, fastmod and (uint32)(int)floorf), so the gradient lands on the
// rows the forward read, and adds w*dy into an fp32 sum with atomics, in
// shared memory first wherever the level fits (below).  Each product w*dy
// is exact fp32; the TPU's bf16 rounding of every product
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
// element offset row * F is formed in 64 bits, and a level is dense only
// where its spec says so (a 2^19-row 4-D level is hashed: its dense
// stride would exceed it).
//
// Bound on the H100: at the config_hash shape (B = 2^18, 16 levels, F = 2,
// bf16 table) the function reads x (2.1 MB) and dcols (16.8 MB) and writes
// the 1.4 MB bf16 gradient: 20.3 MB, 6.1 us at 3.35 TB/s (the 2.8 MB fp32
// buffer it zeroes and reads back is its own, 5.7 MB more).  The design
// before this one ran one thread per (sample, level) and one float2
// atomic per corner wherever a level held more than 4096 values, 13.9 M
// of them per launch at config_hash, at 36x that bound; the coarse dense
// levels' rows took thousands of updates each, which serialise in L2.
//
// The wrapper's plan (ops/cuda/grid_encode.py::gb_plan) cuts each live
// level into work items (level, rows [row_lo, row_lo + n_rows), samples
// [b0, b1)), all run by one launch, the longest first.  A window item's
// CTA holds its rows in dynamic shared memory (up to the 227 KB an sm_90
// CTA may take), adds w*dy of every corner of its samples that lands
// there with shared atomics, and flushes the window with one global
// atomic per touched group of values (scatter_common.cuh, shared with
// kernels RS and GG, which runs on this plan); its chunk of samples is sized so that a row takes several
// updates per CTA.  A direct item adds each corner with one global atomic,
// two dim-0 neighbours on rows r, r + 1 (r even, F = 2: CoherentAdd pairs
// and dense levels) with one float4.  Only the levels whose rows take
// many updates over the batch are windowed (GB_MIN_HITS): measured on an
// H100, windows for every level that fits were slower than direct atomics
// on the fine levels, whose rows take 32 updates each at config_hash
// (PERF.md, tools/kernel_ablation.py); in one launch the SMs sum the
// coarse levels' windows while the L2 takes the fine levels' atomics.  A
// level of more than one CTA's window (32,768 rows x 2 fp32 is 256 KB)
// may be cut into two parts, either two CTAs that each take every sample
// and skip the other's rows, or (kClusterParts) a 2-CTA cluster that
// shares the samples and adds into the other CTA's window through
// distributed shared memory, measured 2.2x slower.  Each thread issues
// the loads of kUnroll samples before it uses them.  config_btf's levels
// (65,536 rows and more, about 8 updates per row) are all direct.
//
// Stochastic interpolation (grid.h:284-299; the JAX package's ws_bwd,
// grid_ops.py:524-535), Rng grids, 5 to 7 dims and more than 8 features a
// level run one instance with D and F at run time
// (grid_encode_bwd_wide_kernel, WideCorners; features in groups of at
// most 8), on the same plan of windows and direct items
// (gb_plan sizes a window's rows by F): with the uniforms u (n_levels, B), a
// sample puts its whole output gradient, weight 1, on the one corner that
// is cell + 1 on dim d iff u[l, b] < w1_d.  The 1- to 4-D instances carry
// no code of it.
//
// Shard mode (BwdParams::sharded, run time; the shard's rows in
// level_params, grid_common.cuh): a direct item issues no atomic for a
// corner the shard does not hold (a dim-0 pair takes one 16-byte atomic
// only where the shard holds both rows); a window item needs no test, since
// the plan (gb_plan) windows rows of the shard's block only, and a corner
// outside the window is skipped as before.  The flush lands at the window's
// row in the shard: row base + row_lo, in uint32 arithmetic as the rows.
//
// Coarse-to-fine: with per-sample level fractions (null: none), a sample
// whose level is masked (grid_common.cuh: level_threshold, the forward's
// cutoff) issues no update at all, neither a direct atomic nor a window
// add, so a window sums only live samples' terms.  Its x and output
// gradient are loaded all the same, with the others of its kUnroll group.
// The plan (gb_plan) is the same with or without a mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include <cstdint>

#include "grid_common.cuh"
#include "kernels.h"
#include "scatter_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kBwdThreads = 512;
constexpr int kUnroll = 4;       // samples whose loads a thread issues at once
constexpr int kItemFields = 5;   // level, row_lo, n_rows (0: direct), b0, b1
// Two-part levels as 2-CTA clusters sharing their samples through
// distributed shared memory (true), or as two CTAs that each take every
// sample and skip the other's rows (false); the plan's GB_CLUSTER_PARTS
// (ops/cuda/grid_encode.py) says the same.
constexpr bool kClusterParts = false;

struct BwdParams {
  const float* x;
  const float* level_frac;   // null: no per-sample mask
  int n_levels;
  const void* dcols;
  const int32_t* level_params;
  const int32_t* items;   // this launch's items, kItemFields each
  float* grad;
  int64_t x_stride_b, dc_stride_b, dc_stride_f;
  HashConsts hc;
  int interp;
  bool sharded;   // the table is a shard: only the rows it holds
};

// fn(x_b, dy_b) for the samples b = from, from + stride, ... below b1, with
// the coordinates and output gradients of kUnroll samples loaded before
// any of them is used: a thread keeps kUnroll samples' loads in flight,
// where one sample at a time waits a memory latency per sample.  Only for
// the samples that keep the level.
template <typename TG, int D, int F, typename Fn>
__device__ __forceinline__ void for_samples(const BwdParams& a, int level, int64_t from,
                                            int64_t b1, int64_t stride, Fn fn) {
  const TG* dcols = static_cast<const TG*>(a.dcols) + int64_t(level) * F * a.dc_stride_f;
  for (int64_t b = from; b < b1; b += kUnroll * stride) {
    float xs[kUnroll][D], dy[kUnroll][F];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t bu = b + u * stride;
      if (bu >= b1) break;
#pragma unroll
      for (int d = 0; d < D; ++d) xs[u][d] = __ldg(a.x + bu * a.x_stride_b + d);
#pragma unroll
      for (int f = 0; f < F; ++f)
        dy[u][f] = to_f32(__ldg(dcols + bu * a.dc_stride_b + f * a.dc_stride_f));
      live[u] = !a.level_frac ||
                float(level) < level_threshold(__ldg(a.level_frac + bu), a.n_levels);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (b + u * stride < b1 && live[u]) fn(xs[u], dy[u]);
  }
}

// One work item per CTA (per 2-CTA cluster with P = 2: two consecutive
// items, the two parts of one level and chunk, rank r owning item r's rows).
template <typename TG, int D, int F, int P>
__global__ void __launch_bounds__(kBwdThreads)
grid_encode_bwd_kernel(BwdParams a) {
  extern __shared__ float win[];
  constexpr int C = 1 << D;
  int rank = 0;
  if constexpr (P > 1) rank = int(cooperative_groups::this_cluster().block_rank());
  const int32_t* it = a.items + int64_t(blockIdx.x) * kItemFields;
  const int level = it[0];
  const uint32_t row_lo = uint32_t(it[1]), n_rows = uint32_t(it[2]);
  const int64_t b0 = it[3], b1 = it[4];
  const int32_t* lp = a.level_params + level * kLevelFields;
  const uint32_t offset = uint32_t(lp[2]);

  if (n_rows == 0) {  // direct: one global atomic per corner
    for_samples<TG, D, F>(a, level, b0 + threadIdx.x, b1, kBwdThreads,
                          [&](const float (&xb)[D], const float (&dy)[F]) {
      const LevelCorners<D> lc(lp, xb, a.interp);
#pragma unroll
      for (int c = 0; c < C; c += 2) {
        const float w0 = lc.weight(c), w1 = lc.weight(c + 1);
        const uint32_t r0 = lc.row(c, a.hc), r1 = lc.row(c + 1, a.hc);
        bool o0 = true, o1 = true;
        if (a.sharded) {
          o0 = shard_owns(lp, r0);
          o1 = shard_owns(lp, r1);
        }
        if constexpr (F == 2) {
          if (o0 && o1 && r1 == r0 + 1 && (r0 & 1) == 0) {  // one 16-byte atomic for the pair
            if (w0 != 0.0f || w1 != 0.0f) {
              const float v[4] = {__fmul_rn(w0, dy[0]), __fmul_rn(w0, dy[1]),
                                  __fmul_rn(w1, dy[0]), __fmul_rn(w1, dy[1])};
              global_add<4>(a.grad + int64_t(r0) * 2, v);
            }
            continue;
          }
        }
        if (w0 != 0.0f && o0) add_row<F>(a.grad + int64_t(r0) * F, w0, dy);
        if (w1 != 0.0f && o1) add_row<F>(a.grad + int64_t(r1) * F, w1, dy);
      }
    });
    return;
  }

  // Window: this CTA's rows [row_lo, row_lo + n_rows) of the level; with a
  // cluster, the item's rows run from rank 0's row_lo over both windows.
  uint32_t lo = row_lo, span = n_rows, own = n_rows;
  if constexpr (P > 1) {
    const int32_t* first = it - rank * kItemFields;
    lo = uint32_t(first[1]);
    own = uint32_t(first[2]);   // rows per rank but the last
    span = own * (P - 1) + uint32_t(first[(P - 1) * kItemFields + 2]);
  }
  window_zero(win, int(n_rows) * F);
  if constexpr (P > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
  for_samples<TG, D, F>(a, level, b0 + rank * kBwdThreads + threadIdx.x, b1, P * kBwdThreads,
                        [&](const float (&xb)[D], const float (&dy)[F]) {
    const LevelCorners<D> lc(lp, xb, a.interp);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float w = lc.weight(c);
      if (w == 0.0f) continue;
      const uint32_t r = lc.row(c, a.hc) - offset - lo;   // wraps above span below lo
      if (r >= span) continue;
      float* p;
      if constexpr (P > 1) {
        const uint32_t owner = r / own;
        p = cooperative_groups::this_cluster().map_shared_rank(win, int(owner)) +
            (r - owner * own) * F;
      } else {
        p = win + r * F;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) window_add(p + f, __fmul_rn(w, dy[f]));
    }
  });
  if constexpr (P > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
  window_flush<scatter_vec(F)>(win, int(n_rows) * F,
                               a.grad + int64_t(uint32_t(offset + row_lo)) * F);
}

template <typename TG, int D, int F, int P>
cudaError_t launch_items(const BwdParams& a, int n_items, int smem, cudaStream_t stream) {
  const auto kernel = grid_encode_bwd_kernel<TG, D, F, P>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if constexpr (P == 1) {
    kernel<<<n_items, kBwdThreads, smem, stream>>>(a);
  } else {
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(unsigned(n_items));
    cfg.blockDim = dim3(kBwdThreads);
    cfg.dynamicSmemBytes = size_t(smem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// The run-time-D instance, the plan's items as the instances above take
// them (one CTA per item, no clusters): a thread per sample of the item; a
// window item sums its rows in shared memory and flushes them with one
// global atomic per value, a direct item adds one global atomic per corner
// and feature; with the uniforms u (stochastic interpolation, null: none)
// one corner at weight 1.  A sample's features in groups of at most 8, one
// after another (one group where F <= 8), each group over every corner
// again, a float4 atomic per four features where F is a multiple of 4.
__global__ void __launch_bounds__(kBwdThreads)
grid_encode_bwd_wide_kernel(BwdParams a, int n_dims, int n_features, bool dcols_bf16,
                            const float* __restrict__ u, int64_t batch) {
  extern __shared__ float win[];
  const int32_t* it = a.items + int64_t(blockIdx.x) * kItemFields;
  const int level = it[0];
  const uint32_t row_lo = uint32_t(it[1]), n_rows = uint32_t(it[2]);
  const int64_t b1 = it[4];
  const int32_t* lp = a.level_params + level * kLevelFields;
  const uint32_t offset = uint32_t(lp[2]);
  if (n_rows) {
    window_zero(win, int(n_rows) * n_features);
    __syncthreads();
  }
  for (int64_t b = it[3] + threadIdx.x; b < b1; b += kBwdThreads) {
    if (a.level_frac && !(float(level) < level_threshold(a.level_frac[b], a.n_levels)))
      continue;
    // features [g0, g0 + nf) of the row
    for (int g0 = 0; g0 < n_features; g0 += kFeatureGroup) {
      const int nf = min(kFeatureGroup, n_features - g0);
      float dy[8];
#pragma unroll
      for (int f = 0; f < 8; ++f)
        dy[f] = f < nf ? load_any(a.dcols, dcols_bf16,
                                  b * a.dc_stride_b +
                                      (int64_t(level) * n_features + g0 + f) * a.dc_stride_f)
                       : 0.0f;
      const WideCorners lc(lp, a.x + b * a.x_stride_b, n_dims, a.interp);
      const int pick = u ? lc.stochastic_corner(u[int64_t(level) * batch + b]) : -1;
      for (int c = 0; c < (1 << n_dims); ++c) {
        const float w = pick < 0 ? lc.weight(c) : (c == pick ? 1.0f : 0.0f);
        if (w == 0.0f) continue;
        const uint32_t r = lc.row(c, a.hc);
        if (a.sharded && !shard_owns(lp, r)) continue;
        float* p;
        if (n_rows) {
          const uint32_t wr = r - offset - row_lo;   // wraps above n_rows below row_lo
          if (wr >= n_rows) continue;
          p = win + wr * n_features + g0;
        } else {
          p = a.grad + int64_t(r) * n_features + g0;
          if (n_features % 4 == 0) {   // a float4 per four features
#pragma unroll
            for (int f = 0; f < 8; f += 4)
              if (f < nf)
                global_add<4>(p + f, {__fmul_rn(w, dy[f]), __fmul_rn(w, dy[f + 1]),
                                      __fmul_rn(w, dy[f + 2]), __fmul_rn(w, dy[f + 3])});
            continue;
          }
        }
#pragma unroll
        for (int f = 0; f < 8; ++f)
          if (f < nf) atomicAdd(p + f, __fmul_rn(w, dy[f]));
      }
    }
  }
  if (n_rows) {
    __syncthreads();
    float* dst = a.grad + int64_t(uint32_t(offset + row_lo)) * n_features;
    if (n_features % 4 == 0)   // float4 atomics where F allows
      window_flush<4>(win, int(n_rows) * n_features, dst);
    else
      window_flush<1>(win, int(n_rows) * n_features, dst);
  }
}

template <typename TG>
struct BwdLaunch {
  BwdParams a;
  const int32_t* groups;   // host: (first item, items, window bytes, parts) per launch
  int n_groups;
  cudaStream_t stream;

  template <int D, int F>
  cudaError_t run() const {
    for (int i = 0; i < n_groups; ++i) {
      const int32_t* g = groups + 4 * i;
      BwdParams p = a;
      p.items = a.items + int64_t(g[0]) * kItemFields;
      cudaError_t err;
      if constexpr (kClusterParts) {
        err = g[3] == 2 ? launch_items<TG, D, F, 2>(p, g[1], g[2], stream)
                        : launch_items<TG, D, F, 1>(p, g[1], g[2], stream);
      } else {   // the plan's GB_CLUSTER_PARTS and kClusterParts must agree
        err = g[3] == 2 ? cudaErrorInvalidValue : launch_items<TG, D, F, 1>(p, g[1], g[2], stream);
      }
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
};

}  // namespace

cudaError_t grid_encode_bwd_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* dcols,
    bool dcols_bf16, const int32_t* level_params, int n_levels, const int32_t* items,
    const int32_t* groups, int n_groups,
    float* grad, void* out, bool out_bf16, int64_t n_params, int n_dims, int n_features,
    int64_t dc_stride_b, int64_t dc_stride_f, const uint32_t hash_factors[7],
    int hash_kind, int interp, const float* u, int64_t batch, bool sharded,
    cudaStream_t stream) {
  if (n_params <= 0 || n_groups < 0 || n_levels <= 0 || interp < 0 || interp > 2 ||
      x_stride_b < n_dims || (!out_bf16 && out != grad) || n_dims < 1 || n_dims > kMaxDims ||
      n_features < 1)
    return cudaErrorInvalidValue;
  for (int i = 0; i < n_groups; ++i)
    if (groups[4 * i + 1] <= 0 || groups[4 * i + 2] < 0 || groups[4 * i + 2] > kWindowMaxBytes ||
        (groups[4 * i + 3] != 1 && groups[4 * i + 3] != 2) || groups[4 * i + 1] % groups[4 * i + 3])
      return cudaErrorInvalidValue;
  const BwdParams a{x, level_frac, n_levels, dcols, level_params, items, grad,
                    x_stride_b, dc_stride_b, dc_stride_f,
                    make_hash_consts(hash_factors, hash_kind), interp, sharded};

  cudaError_t err = cudaMemsetAsync(grad, 0, size_t(n_params) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if (wide_instance(n_dims, hash_kind, n_features) || u != nullptr) {
    for (int i = 0; i < n_groups && err == cudaSuccess; ++i) {
      const int32_t* g = groups + 4 * i;
      if (g[3] != 1) return cudaErrorInvalidValue;   // no clusters
      BwdParams p = a;
      p.items = a.items + int64_t(g[0]) * kItemFields;
      if (g[2] > 48 * 1024) {
        err = cudaFuncSetAttribute(grid_encode_bwd_wide_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, g[2]);
        if (err != cudaSuccess) return err;
      }
      grid_encode_bwd_wide_kernel<<<g[1], kBwdThreads, g[2], stream>>>(p, n_dims, n_features,
                                                                      dcols_bf16, u, batch);
      err = cudaGetLastError();
    }
  } else {
    err = dcols_bf16 ? dispatch_df(n_dims, n_features,
                                   BwdLaunch<__nv_bfloat16>{a, groups, n_groups, stream})
                     : dispatch_df(n_dims, n_features, BwdLaunch<float>{a, groups, n_groups, stream});
  }
  if (err != cudaSuccess || !out_bf16) return err;
  cast_to_bf16_kernel<<<unsigned((n_params + kGridThreads - 1) / kGridThreads), kGridThreads,
                        0, stream>>>(grad, static_cast<__nv_bfloat16*>(out), n_params);
  return cudaGetLastError();
}

}  // namespace tcnn_tpu_torch

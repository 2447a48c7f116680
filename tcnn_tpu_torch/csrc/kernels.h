// Launchers of the port's hand-written Hopper kernels.
//
// Plain C++ interface (raw pointers, a stream, cudaError_t), so that the
// kernel sources never include PyTorch's headers: only bindings.cpp does,
// which keeps the one slow translation unit small.  Each launcher
// validates what the kernel cannot take, launches on `stream` and returns
// the error of that validation or of the launch configuration; the
// binding then checks the launch itself.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <functional>

namespace tcnn_tpu_torch {

// Kernel G: grid-encode forward (csrc/grid_encode.cu).
//   x            (batch, n_dims) float32: coordinate d of sample b at
//                x[b*x_stride_b + d], x_stride_b >= n_dims (a column slice of a
//                wider input is read in place)
//   level_frac   (batch) float32 per-sample level fractions, or null: sample b
//                keeps level l iff l < level_frac[b] * n_levels + 1e-3
//                (grid_common.cuh: level_threshold); masked levels are 0
//   table        flat (n_entries * n_features), float32 or bfloat16
//   level_params (n_levels, 17) int32, see ops/grid_ops.py::level_params
//   out          element (b, l*F+f) at out[b*out_stride_b + (l*F+f)*out_stride_f],
//                in the table's dtype
//   n_dims       1 to 7 (5 to 7: the kernel's one run-time-D instance)
//   n_features   1 or more (more than 8: the run-time-D instance, in groups of
//                8 features; every grid kernel takes F so)
//   hash_factors seven uint32 LCG factors (zero past n_dims); hash_kind: 0 the
//                factors' XOR, 1 CoherentAdd (dim 0 added), 2 Rng (pcg32)
//   interp       0 nearest, 1 linear, 2 smoothstep
//   sharded      the table is one rank's block-cyclic shard (level_params
//                holds its rows): corners outside it contribute nothing, and
//                out holds float32 partial features
//   u            (n_levels, batch) float32 uniforms of stochastic
//                interpolation, or null: with them, sample b reads on level l
//                its one corner (cell + 1 on dim d iff u[l, b] < w1_d) at
//                weight 1, the corner kernel GB scatters to (not with sharded)
cudaError_t grid_encode_fwd_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const int32_t* level_params, void* out, int64_t batch, int n_dims,
    int n_levels, int n_features, int64_t out_stride_b, int64_t out_stride_f,
    const uint32_t hash_factors[7], int hash_kind, int interp, bool sharded, const float* u,
    cudaStream_t stream);

// Kernel M: fused-MLP forward (csrc/fused_mlp.cu).
//   x       element (b, d) at x[b*x_stride_b + d*x_stride_d], in the compute
//           dtype (bfloat16 or float32), d < d_in
//   weights n_layers (2..32) contiguous row-major matrices in the compute
//           dtype: (d_in, width), (width, width) x (n_layers - 2), (width, d_out)
//   y       element (b, j) at y[b*y_stride_b + j*y_stride_d], float32 or bfloat16
//   act, out_act: the Activation enum's order (0 None ... 8 Tanh)
cudaError_t fused_mlp_fwd_launch(
    const void* x, int64_t x_stride_b, int64_t x_stride_d, int d_in,
    const void* const* weights, int n_layers, int width, int d_out, void* y,
    int64_t y_stride_b, int64_t y_stride_d, bool y_bf16, int64_t batch,
    bool compute_bf16, int act, int out_act, bool soa_in, bool soa_out,
    cudaStream_t stream);

// Kernel GB: grid-encode backward, the table gradient (csrc/grid_encode_bwd.cu).
//   x, x_stride_b, level_frac as for grid_encode_fwd_launch: a masked
//                (sample, level) adds nothing
//   n_levels     the rows of level_params
//   dcols        element (l*F+f, b) at dcols[b*dc_stride_b + (l*F+f)*dc_stride_f],
//                float32 or bfloat16
//   items        (n_items, 5) int32 on the device, the work of
//                ops/cuda/grid_encode.py::gb_plan: per item (level, row_lo,
//                n_rows, b0, b1), a window of rows [row_lo, row_lo + n_rows)
//                of the level (n_rows = 0: direct atomics) over samples [b0, b1)
//   groups       host, 4 int32 per launch: (first item, items, window bytes,
//                parts: 2 where consecutive item pairs are one level's two halves)
//   grad         (n_params) float32 scratch: zeroed, then accumulated into
//   out          (n_params) gradient in the table's dtype: bfloat16 (a cast of
//                grad) or, for float32 tables, grad itself
//   u            (n_levels, batch) float32 uniforms of stochastic interpolation
//                (ops/grid_ops.py::stochastic_uniforms), or null: with them,
//                sample b's whole gradient on level l goes to one corner, cell
//                + 1 on dim d iff u[l, b] < w1_d
//   other arguments as for grid_encode_fwd_launch (n_dims 5 to 7: direct
//   items only; sharded: the items' windows lie in the shard's block)
cudaError_t grid_encode_bwd_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* dcols,
    bool dcols_bf16, const int32_t* level_params, int n_levels, const int32_t* items,
    const int32_t* groups, int n_groups,
    float* grad, void* out, bool out_bf16, int64_t n_params, int n_dims, int n_features,
    int64_t dc_stride_b, int64_t dc_stride_f, const uint32_t hash_factors[7],
    int hash_kind, int interp, const float* u, int64_t batch, bool sharded,
    cudaStream_t stream);

// Kernel MB: fused-MLP backward (csrc/fused_mlp_bwd.cu).
//   x, weights, d_in, width, d_out, act, out_act: as for fused_mlp_fwd_launch
//   g        element (b, j) at g[b*g_stride_b + j*g_stride_d], float32
//   dx       element (b, d) at dx[b*dx_stride_b + d*dx_stride_d], bfloat16 or float32
//   scratch  scratch(n) returns n floats of device memory for the CTAs'
//            partial dW, n = the launch's CTA count x total_dw, total_dw = sum
//            of the layers' fan_in * fan_out; in use until the work enqueued
//            on `stream` has run (a stream-ordered allocator's memory)
//   dw       (total_dw) float32: the layers' gradients, row-major, concatenated
cudaError_t fused_mlp_bwd_launch(
    const void* x, int64_t x_stride_b, int64_t x_stride_d, int d_in,
    const void* const* weights, int n_layers, int width, int d_out,
    const float* g, int64_t g_stride_b, int64_t g_stride_d, void* dx,
    int64_t dx_stride_b, int64_t dx_stride_d, bool dx_bf16,
    const std::function<float*(int64_t)>& scratch, float* dw, int64_t batch,
    bool compute_bf16, int act, int out_act, bool soa_in, cudaStream_t stream);

// Kernel GI: grid-encode input gradient (csrc/grid_encode_bwd_input.cu).
//   x, x_stride_b, level_frac, level_params, hash_factors, hash_kind, interp:
//                as for grid_encode_fwd_launch
//   table        flat (n_entries * n_features), float32 or bfloat16 (table_bf16)
//   dcols        as for grid_encode_bwd_launch, float32 or bfloat16 (dcols_bf16)
//   dx           (batch, n_dims) float32, contiguous: written, not accumulated
cudaError_t grid_encode_bwd_input_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const void* dcols, bool dcols_bf16, const int32_t* level_params,
    float* dx, int64_t batch, int n_dims, int n_levels, int n_features, int64_t dc_stride_b,
    int64_t dc_stride_f, const uint32_t hash_factors[7], int hash_kind, int interp,
    bool sharded, cudaStream_t stream);

// Kernel GG: grid-encode second order (csrc/grid_encode_bwd_bwd.cu).
//   x, level_frac, table, dcols and the rest: as for grid_encode_bwd_input_launch;
//                a masked (sample, level) adds nothing and writes 0 to d_dcols
//   ddx          (batch, n_dims) float32, contiguous: the cotangent of GI's dx
//   items, groups  as for grid_encode_bwd_launch (gb_plan's items; parts 1)
//   d_dcols      (n_levels * n_features, batch) float32 SoA, or null: written
//                for the live levels only (the caller zeroes the others)
//   dx_part      (n_levels, batch, n_dims) float32 scratch, the levels'
//                partials of d_x; given with d_x or not at all
//   d_x          (batch, n_dims) float32, or null: the live levels' partials
//                summed in level order
//   grad, out    the table gradient as for grid_encode_bwd_launch (n_params
//                the table's, or the shard's, values), or both null
cudaError_t grid_encode_bwd_bwd_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const void* dcols, bool dcols_bf16, const float* ddx,
    const int32_t* level_params, int n_levels, const int32_t* items, const int32_t* groups,
    int n_groups, float* d_dcols, float* dx_part, float* d_x, float* grad, void* out,
    bool out_bf16, int64_t n_params, int64_t batch, int n_dims, int n_features,
    int64_t dc_stride_b, int64_t dc_stride_f, const uint32_t hash_factors[7], int hash_kind,
    int interp, bool sharded, cudaStream_t stream);

// Kernel GT: grid-encode third order (csrc/grid_encode_third.cu), the
// blocks of GG's backward that no other kernel computes, given ct_dx, the
// cotangent of GG's d_x.
//   x, level_frac, table, dcols and the rest: as for grid_encode_bwd_bwd_launch;
//                a masked (sample, level) adds nothing and writes 0 to
//                d_dcols and its d_x partial
//   ddx, ct_dx   (batch, n_dims) float32, contiguous: v and beta, u_c = beta^T
//                (d2 w_c / dx2) v per corner
//   items, groups  as for grid_encode_bwd_bwd_launch (gb_plan's items, GG's
//                chunks; parts 1)
//   d_dcols      (n_levels * n_features, batch) float32 SoA, or null:
//                sum_c u_c table[row_c], written for the live levels only
//                (the caller zeroes the others)
//   dx_part, d_x as for grid_encode_bwd_bwd_launch: sum over levels and
//                corners of (d3 w_c / dx3)[beta, v, .] <table[row_c], dcols>
//   grad, out    table gradient u_c * dcols added onto row_c, as for
//                grid_encode_bwd_bwd_launch, or both null
cudaError_t grid_encode_third_launch(
    const float* x, int64_t x_stride_b, const float* level_frac, const void* table,
    bool table_bf16, const void* dcols, bool dcols_bf16, const float* ddx, const float* ct_dx,
    const int32_t* level_params, int n_levels, const int32_t* items, const int32_t* groups,
    int n_groups, float* d_dcols, float* dx_part, float* d_x, float* grad, void* out,
    bool out_bf16, int64_t n_params, int64_t batch, int n_dims, int n_features,
    int64_t dc_stride_b, int64_t dc_stride_f, const uint32_t hash_factors[7], int hash_kind,
    int interp, bool sharded, cudaStream_t stream);

// Kernel RS: row scatter-add (csrc/row_scatter.cu).
//   idx          (m) int32 rows; rows outside [0, n_rows) are skipped
//   g            element (i, k) at g[i*g_stride_i + k*g_stride_k], float32
//   acc          (n_rows * n_features) float32 scratch: zeroed, then accumulated
//   out          the result: bfloat16 (a cast of acc) or acc itself
cudaError_t row_scatter_launch(const int32_t* idx, const float* g, int64_t g_stride_i,
                               int64_t g_stride_k, int64_t m, int n_features, float* acc,
                               void* out, bool out_bf16, int64_t n_rows, cudaStream_t stream);

// Kernel SK: the grid's table-gradient updates as sort keys and values
// (csrc/sort_scatter.cu), the first step of the sort-and-segment-sum route.
//   x, x_stride_b, level_frac, level_params, n_levels, hash_factors,
//   hash_kind, interp, sharded: as for grid_encode_bwd_launch (dead levels
//                have no updates)
//   dcols        as for grid_encode_bwd_launch, float32 or bfloat16 (dcols_bf16)
//   u            as for grid_encode_bwd_launch (not with sharded)
//   keys         (M) int32, M = live levels x 2^n_dims x batch in (live level,
//                corner, sample) order: the corner's table (or shard) row, or
//                `sentinel` (n_rows) where the update adds nothing (a masked
//                (sample, level), another rank's corner)
//   vals         (M, n_features) float32: w * dy, the scatter weight (zero
//                where the key is the sentinel) times the output gradient
cudaError_t sort_keys_launch(const float* x, int64_t x_stride_b, const float* level_frac,
                             const void* dcols, bool dcols_bf16, int64_t dc_stride_b,
                             int64_t dc_stride_f, const int32_t* level_params, int n_levels,
                             int64_t batch, int n_dims, int n_features,
                             const uint32_t hash_factors[7], int hash_kind, int interp,
                             bool sharded, const float* u, int32_t sentinel, int32_t* keys,
                             float* vals, cudaStream_t stream);

// Kernel SS: segment sums of sorted updates (csrc/sort_scatter.cu), no atomics.
//   keys         (m) int32, sorted; keys outside [0, n_rows) are skipped
//   order        (m) int64: sorted position i holds update order[i]
//   vals         (m, n_features) float32, update-major
//   scratch      segment_sum_scratch_floats(m, n_features) float32
//   out          (n_rows * n_features), bfloat16 (out_bf16) or float32: zeroed,
//                then each row the fp32 sum of its run, rounded once
// keys, order, vals, scratch and out 16-byte aligned.
cudaError_t segment_sum_launch(const int32_t* keys, const int64_t* order, const float* vals,
                               int64_t m, int n_features, int64_t n_rows, float* scratch,
                               void* out, bool out_bf16, cudaStream_t stream);
int64_t segment_sum_scratch_floats(int64_t m, int n_features);

// Kernel SR: Shampoo's preconditioner roots (csrc/shampoo_root.cu), a
// cluster of CTAs per matrix, at most kShampooRootMaxMatrices a launch.
//   step         the optimizer's int32 step counter, read by the kernel: on a
//                step that is no refresh step every CTA returns at once
//   mats, roots  count (n, n) float32 row-major matrices L and their roots,
//                1 <= n <= kShampooRootMaxN; root = (sym(L)·(1 − identity) +
//                identity·I)^(−1/4), written over the old root
//   scratch      the sum of shampoo_root_scratch_floats(n) over the matrices,
//                16-byte aligned
//   stats        (count, 2) int32: each refreshed matrix's sweeps and the
//                rotations it applied (untouched on other steps)
//   max_sweeps   the cap on Jacobi sweeps, 1 to kShampooRootMaxSweeps
constexpr int kShampooRootMaxMatrices = 64;
constexpr int kShampooRootMaxN = 4096;
constexpr int kShampooRootMaxSweeps = 30;
struct ShampooRootBatch {   // the kernel's table, passed by value
  const float* mats[kShampooRootMaxMatrices];
  float* roots[kShampooRootMaxMatrices];
  float* scratch[kShampooRootMaxMatrices];
  int n[kShampooRootMaxMatrices];
};
cudaError_t shampoo_root_launch(const int32_t* step, const float* const* mats,
                                float* const* roots, const int* sizes, int count, double identity,
                                float* scratch, int32_t* stats, int max_sweeps,
                                cudaStream_t stream);
int64_t shampoo_root_scratch_floats(int n);

// The shared memory of one kernel-MB CTA for a shape and the activations
// (more than 232,448 bytes: the shape does not fit).
int fused_mlp_bwd_smem_bytes(int d_in, int d_out, int width, int n_layers, bool compute_bf16,
                             int act, int out_act);

// The same for kernel M (soa_in: the input's layout, which the bf16
// kernel's input slices follow).
int fused_mlp_fwd_smem_bytes(int d_in, int d_out, int width, int n_layers, bool compute_bf16,
                             bool soa_in);

// Kernels M and MB for one layer streamed through shared memory in stages
// of its input features, at any fan-in k and fan-out n (kernels MW and MBW,
// csrc/fused_mlp_wide.cu): the layers whose weights and input tile do not
// fit M's and MB's layouts.
//   x       element (b, i) at x[b*x_stride_b + i*x_stride_d], compute dtype,
//           i < k, one of the two strides 1
//   w       (k, n) row-major, compute dtype, n >= 1
//   forward: y = act(x w), element (b, j) at y[b*y_stride_b + j*y_stride_d],
//            float32 or bfloat16
//   backward: g (b, j) at g[b*g_stride_b + j*g_stride_d] float32, the output
//            gradient; dz = g * act'(x w) rounded to the compute dtype;
//            dw = x^T dz (k, n) float32, dx = dz w^T in x's layout, float32 or
//            bfloat16 (scratch sizes dz and the batch ranges' partial dw)
cudaError_t fused_mlp_wide_fwd_launch(const void* x, int64_t x_stride_b, int64_t x_stride_d,
                                      int k, const void* w, int n, void* y, int64_t y_stride_b,
                                      int64_t y_stride_d, bool y_bf16, int64_t batch,
                                      bool compute_bf16, int act, cudaStream_t stream);
cudaError_t fused_mlp_wide_bwd_launch(const void* x, int64_t x_stride_b, int64_t x_stride_d,
                                      int k, const void* w, int n, const float* g,
                                      int64_t g_stride_b, int64_t g_stride_d, void* dx,
                                      int64_t dx_stride_b, int64_t dx_stride_d, bool dx_bf16,
                                      const std::function<float*(int64_t)>& scratch, float* dw,
                                      int64_t batch, bool compute_bf16, int act,
                                      cudaStream_t stream);

}  // namespace tcnn_tpu_torch

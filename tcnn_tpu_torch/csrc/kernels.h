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

namespace tcnn_tpu_torch {

// Kernel G: grid-encode forward (csrc/grid_encode.cu).
//   x            (batch, n_dims) float32: coordinate d of sample b at
//                x[b*x_stride_b + d], x_stride_b >= n_dims (a column slice of a
//                wider input is read in place)
//   table        flat (n_entries * n_features), float32 or bfloat16
//   level_params (n_levels, 12) int32, see ops/grid_ops.py::level_params
//   out          element (b, l*F+f) at out[b*out_stride_b + (l*F+f)*out_stride_f],
//                in the table's dtype
//   hash_factors four uint32 LCG factors; coherent_add selects the
//                additive dim-0 hash; interp: 0 nearest, 1 linear, 2 smoothstep
cudaError_t grid_encode_fwd_launch(
    const float* x, int64_t x_stride_b, const void* table, bool table_bf16,
    const int32_t* level_params, void* out, int64_t batch, int n_dims,
    int n_levels, int n_features, int64_t out_stride_b, int64_t out_stride_f,
    const uint32_t hash_factors[4], bool coherent_add, int interp,
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
//   x, x_stride_b as for grid_encode_fwd_launch
//   dcols        element (l*F+f, b) at dcols[b*dc_stride_b + (l*F+f)*dc_stride_f],
//                float32 or bfloat16
//   grad         (n_params) float32 scratch: zeroed, then accumulated into
//   out          (n_params) gradient in the table's dtype: bfloat16 (a cast of
//                grad) or, for float32 tables, grad itself
//   other arguments as for grid_encode_fwd_launch
cudaError_t grid_encode_bwd_launch(
    const float* x, int64_t x_stride_b, const void* dcols, bool dcols_bf16,
    const int32_t* level_params, float* grad, void* out, bool out_bf16, int64_t n_params,
    int64_t batch, int n_dims, int n_levels, int n_features, int64_t dc_stride_b,
    int64_t dc_stride_f, const uint32_t hash_factors[4], bool coherent_add,
    int interp, cudaStream_t stream);

// Kernel MB: fused-MLP backward (csrc/fused_mlp_bwd.cu).
//   x, weights, d_in, width, d_out, act, out_act: as for fused_mlp_fwd_launch
//   g        element (b, j) at g[b*g_stride_b + j*g_stride_d], float32
//   dx       element (b, d) at dx[b*dx_stride_b + d*dx_stride_d], bfloat16 or float32
//   partials (n_ctas, total_dw) float32 scratch, total_dw = sum of the layers'
//            fan_in * fan_out; n_ctas persistent CTAs, 1 <= n_ctas <= the number
//            of batch tiles (128 rows for bf16 compute, 64 for float32)
//   dw       (total_dw) float32: the layers' gradients, row-major, concatenated
cudaError_t fused_mlp_bwd_launch(
    const void* x, int64_t x_stride_b, int64_t x_stride_d, int d_in,
    const void* const* weights, int n_layers, int width, int d_out,
    const float* g, int64_t g_stride_b, int64_t g_stride_d, void* dx,
    int64_t dx_stride_b, int64_t dx_stride_d, bool dx_bf16, float* partials,
    int n_ctas, float* dw, int64_t batch, bool compute_bf16, int act, int out_act,
    bool soa_in, cudaStream_t stream);

// Shared memory one CTA of kernel MB needs (at most 232,448 bytes on sm_90).
int fused_mlp_bwd_smem_bytes(int d_in, int d_out, int width, int n_layers,
                             bool compute_bf16);

}  // namespace tcnn_tpu_torch

// Kernel M: fused MLP forward, all layers in one kernel.
//
// Replaces the TPU's fused_mlp.py::_fwd_kernel (:100): one batch tile
// runs through every layer with the weights resident on chip and no
// activation ever written to device memory.
//
// bf16 compute (the BF16_POLICY path): one CTA per 128-row batch tile,
// 8 warps, warp w owning rows [16w, 16w+16).  The tile's input is staged
// in shared memory as bf16, zero-padded to a multiple of 16 columns (the
// batch tail is masked: rows past the batch are zeros and never stored).
// Each layer's weights are staged transposed in shared memory, then every
// warp runs mma.sync m16n8k16 bf16 products with fp32 accumulation over
// its rows.  The activations never leave registers: the accumulators of
// one layer are, element for element, the A fragments of the next, so the
// activation is applied in fp32 and the result rounded to bf16 in place,
// as _fwd_kernel does (fused_mlp.py:104-110).  The output layer writes
// D_out columns to device memory in AoS or SoA order, in the output dtype.
//
// fp32 compute (DEFAULT_POLICY): plain fp32 FMA loops, no TF32.  One CTA
// per 64-row tile, 128 threads; thread t owns row t % 64 and every other
// 16-column chunk of the layer's outputs; activations ping-pong between
// two shared-memory buffers.
//
// Bound on the H100: at the config_hash shape (B = 2^18, 32 -> 64 -> 64
// -> 3) the function reads 16 MB of bf16 input and writes 3 MB of fp32
// output: about 5.7 us at 3.35 TB/s, against 3.3 GFLOP, 3.4 us at the
// 989 TFLOP/s bf16 peak.  So it is bound by device memory.  The design
// reads each input once, keeps every activation on chip and stores only
// the D_out real columns.  Each CTA stages its input tile and, layer by
// layer, the weights (14 KB per tile at 64 x 2, from L2) in 16-byte
// chunks.  wgmma, TMA and a persistent tile loop that stages the weights
// once per SM are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"
#include "mlp_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kRowsF32 = 64;     // fp32 kernel: batch rows per CTA
constexpr int kThreadsF32 = 128;

struct MlpArgs {
  const void* x;
  int64_t x_stride_b, x_stride_d;
  int d_in;
  const void* w[kMaxLayers];  // layer l: (fan_in, fan_out) row-major
  int n_layers, d_out;
  void* y;
  int64_t y_stride_b, y_stride_d;
  int64_t batch;
  int act, out_act;
  int soa_in, soa_out;
};

// Shared memory of the bf16 kernel: the input tile (kRows x ld) and the
// current layer's transposed weights (up to max(D_out, W) rows x ld),
// ld = max(pad16(D_in), W) + kSkew.
__host__ __device__ constexpr int bf16_ld(int d_in, int width) {
  return (pad16(d_in) > width ? pad16(d_in) : width) + kSkew;
}
inline int bf16_smem_bytes(int d_in, int d_out, int width) {
  const int wrows = pad16(d_out) > width ? pad16(d_out) : width;
  return (kRows + wrows) * bf16_ld(d_in, width) * 2;
}

template <int W, typename TOut>
__global__ void __launch_bounds__(kWarps * 32)
fused_mlp_fwd_bf16_kernel(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = bf16_ld(a.d_in, W);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);  // input tile
  __nv_bfloat16* wt = act + kRows * ld;                           // wt[n * ld + k]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t row0 = int64_t(blockIdx.x) * kRows;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);

  // Input tile, zero-padded to pad16(D_in) columns.
  stage_input_tile(x, a.x_stride_b, a.x_stride_d, a.d_in, a.batch, row0, a.soa_in != 0,
                   act, ld);

  // Each warp owns 16 rows.  Between layers its activations stay in
  // registers: an m16n8 accumulator pair (n-tiles 2kb, 2kb+1) holds
  // exactly the A fragment of k-step kb of the next layer, so the
  // activation is applied in fp32 and the result rounded to bf16 in place
  // (fused_mlp.py:104-110 of the JAX package: fp32 accumulate, activation
  // in fp32, cast to the compute dtype between layers).
  constexpr int NT = W / 8;    // n-tiles of a hidden layer
  constexpr int KB = W / 16;   // k-steps of a layer fed by a hidden layer
  float acc[NT][4];
  uint32_t afrag[KB][4];
  const __nv_bfloat16* arow = act + (warp * 16 + g) * ld + 2 * t;

  for (int layer = 0; layer < a.n_layers; ++layer) {
    const bool last = layer == a.n_layers - 1;
    const int k_real = layer == 0 ? a.d_in : W;
    const int n_real = last ? a.d_out : W;
    const int K = pad16(k_real), N = last ? (n_real + 7) / 8 * 8 : W;

    __syncthreads();  // the input tile is written; the old weights are read
    stage_weights_t<W>(static_cast<const __nv_bfloat16*>(a.w[layer]), k_real, n_real, K,
                       N, wt, ld);
    __syncthreads();

    if (!last) {
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      if (layer == 0) {
        for (int kb = 0; kb < K / 16; ++kb) {
          const uint32_t af[4] = {ld32(arow + 16 * kb), ld32(arow + 8 * ld + 16 * kb),
                                  ld32(arow + 16 * kb + 8), ld32(arow + 8 * ld + 16 * kb + 8)};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t b0, b1;
            load_b(wt, ld, j, kb, g, t, &b0, &b1);
            mma_bf16(acc[j], af, b0, b1);
          }
        }
      } else {
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t b0, b1;
            load_b(wt, ld, j, kb, g, t, &b0, &b1);
            mma_bf16(acc[j], afrag[kb], b0, b1);
          }
        }
      }
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        afrag[kb][0] = pack_bf16(activate(acc[2 * kb][0], a.act), activate(acc[2 * kb][1], a.act));
        afrag[kb][1] = pack_bf16(activate(acc[2 * kb][2], a.act), activate(acc[2 * kb][3], a.act));
        afrag[kb][2] = pack_bf16(activate(acc[2 * kb + 1][0], a.act),
                                 activate(acc[2 * kb + 1][1], a.act));
        afrag[kb][3] = pack_bf16(activate(acc[2 * kb + 1][2], a.act),
                                 activate(acc[2 * kb + 1][3], a.act));
      }
    } else {
      // Output layer: one n-tile at a time; only the real columns leave.
      for (int j = 0; j < N / 8; ++j) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          uint32_t b0, b1;
          load_b(wt, ld, j, kb, g, t, &b0, &b1);
          mma_bf16(c, afrag[kb], b0, b1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t b = row0 + warp * 16 + g + 8 * (i / 2);
          const int n = 8 * j + 2 * t + i % 2;
          if (b < a.batch && n < a.d_out)
            store(static_cast<TOut*>(a.y) + b * a.y_stride_b + n * a.y_stride_d,
                  activate(c[i], a.out_act));
        }
      }
    }
  }
}

template <typename TOut>
__global__ void __launch_bounds__(kThreadsF32)
fused_mlp_fwd_f32_kernel(MlpArgs a, int width) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ka = a.d_in > width ? a.d_in : width;
  const int ldf = ka + 1;  // odd: rows of a warp fall in distinct banks
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + kRowsF32 * ldf;
  float* wbuf = buf1 + kRowsF32 * ldf;

  const int tid = threadIdx.x;
  const int r = tid % kRowsF32, part = tid / kRowsF32;
  const int n_parts = kThreadsF32 / kRowsF32;
  const int64_t row0 = int64_t(blockIdx.x) * kRowsF32;
  const float* x = static_cast<const float*>(a.x);

  staged_copy<float>(
      kRowsF32 * a.d_in,
      [&](int i) {
        const int rr = a.soa_in ? i % kRowsF32 : i / a.d_in;
        const int k = a.soa_in ? i / kRowsF32 : i % a.d_in;
        const int64_t b = row0 + rr;
        return b < a.batch ? x[b * a.x_stride_b + k * a.x_stride_d] : 0.0f;
      },
      [&](int i, float v) {
        const int rr = a.soa_in ? i % kRowsF32 : i / a.d_in;
        const int k = a.soa_in ? i / kRowsF32 : i % a.d_in;
        buf0[rr * ldf + k] = v;
      });

  float* src = buf0;
  float* dst = buf1;
  for (int layer = 0; layer < a.n_layers; ++layer) {
    const bool last = layer == a.n_layers - 1;
    const int k_real = layer == 0 ? a.d_in : width;
    const int n_real = last ? a.d_out : width;
    const float* w = static_cast<const float*>(a.w[layer]);
    const int N = pad16(n_real);

    __syncthreads();  // previous weights consumed, src rows written
    staged_copy<float>(
        k_real * N,
        [&](int i) {
          const int n = i % N;
          return n < n_real ? w[(i / N) * n_real + n] : 0.0f;
        },
        [&](int i, float v) { wbuf[i] = v; });
    __syncthreads();

    for (int n0 = part * 16; n0 < N; n0 += 16 * n_parts) {
      float acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
      for (int k = 0; k < k_real; ++k) {
        const float h = src[r * ldf + k];
        const float* wk = wbuf + k * N + n0;
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] = fmaf(h, wk[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + j;
        if (n >= n_real) continue;
        if (!last) {
          dst[r * ldf + n] = activate(acc[j], a.act);
        } else {
          const int64_t b = row0 + r;
          if (b < a.batch)
            store(static_cast<TOut*>(a.y) + b * a.y_stride_b + n * a.y_stride_d,
                  activate(acc[j], a.out_act));
        }
      }
    }
    float* t = src;
    src = dst;
    dst = t;
  }
}

template <typename Kernel>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int threads, int smem,
                             cudaStream_t stream, const MlpArgs& a) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaSuccess;
}

template <typename TOut>
cudaError_t launch_bf16(const MlpArgs& a, int width, cudaStream_t stream) {
  const dim3 grid(unsigned((a.batch + kRows - 1) / kRows));
  const int smem = bf16_smem_bytes(a.d_in, a.d_out, width);
  switch (width) {
    case 16: return launch_with_smem(fused_mlp_fwd_bf16_kernel<16, TOut>, grid, kWarps * 32, smem, stream, a);
    case 32: return launch_with_smem(fused_mlp_fwd_bf16_kernel<32, TOut>, grid, kWarps * 32, smem, stream, a);
    case 64: return launch_with_smem(fused_mlp_fwd_bf16_kernel<64, TOut>, grid, kWarps * 32, smem, stream, a);
    case 128: return launch_with_smem(fused_mlp_fwd_bf16_kernel<128, TOut>, grid, kWarps * 32, smem, stream, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TOut>
cudaError_t launch_f32(const MlpArgs& a, int width, cudaStream_t stream) {
  const dim3 grid(unsigned((a.batch + kRowsF32 - 1) / kRowsF32));
  const int ka = a.d_in > width ? a.d_in : width;
  const int nw = pad16(a.d_out) > width ? pad16(a.d_out) : width;
  const int smem = (2 * kRowsF32 * (ka + 1) + ka * nw) * 4;
  auto kernel = fused_mlp_fwd_f32_kernel<TOut>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsF32, smem, stream>>>(a, width);
  return cudaSuccess;
}

}  // namespace

cudaError_t fused_mlp_fwd_launch(
    const void* x, int64_t x_stride_b, int64_t x_stride_d, int d_in,
    const void* const* weights, int n_layers, int width, int d_out, void* y,
    int64_t y_stride_b, int64_t y_stride_d, bool y_bf16, int64_t batch,
    bool compute_bf16, int act, int out_act, bool soa_in, bool soa_out,
    cudaStream_t stream) {
  if (batch <= 0 || n_layers < 2 || n_layers > kMaxLayers || d_in < 1 || d_out < 1)
    return cudaErrorInvalidValue;
  MlpArgs a{};
  a.x = x;
  a.x_stride_b = x_stride_b;
  a.x_stride_d = x_stride_d;
  a.d_in = d_in;
  for (int l = 0; l < n_layers; ++l) a.w[l] = weights[l];
  a.n_layers = n_layers;
  a.d_out = d_out;
  a.y = y;
  a.y_stride_b = y_stride_b;
  a.y_stride_d = y_stride_d;
  a.batch = batch;
  a.act = act;
  a.out_act = out_act;
  a.soa_in = soa_in ? 1 : 0;
  a.soa_out = soa_out ? 1 : 0;
  if (compute_bf16)
    return y_bf16 ? launch_bf16<__nv_bfloat16>(a, width, stream)
                  : launch_bf16<float>(a, width, stream);
  return y_bf16 ? launch_f32<__nv_bfloat16>(a, width, stream)
                : launch_f32<float>(a, width, stream);
}

}  // namespace tcnn_tpu_torch

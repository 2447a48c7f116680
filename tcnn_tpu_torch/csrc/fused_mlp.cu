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
// fp32 compute (DEFAULT_POLICY): plain fp32 FMA, no TF32.  Persistent
// CTAs of 128 threads, as many as the occupancy calculator puts on the
// card, walk 64-row tiles; each stages every layer's weights into shared
// memory once (per layer and tile where they do not fit) and copies the
// next tile's input by cp.async while the current one computes (SoA input
// with 16-byte aligned rows).  Activations live feature-major in shared
// memory; each product is register-tiled (mlp_common.cuh: f32_product): a
// thread owns a 4-row x W/8-column block and per k loads one float4 of
// activations and W/8 weights for 4·W/8 FMAs.  3xTF32 on the tensor cores
// (mlp_common.cuh: kTf32x3) was measured and set aside; fused_mlp_bwd.cu
// says why.
//
// Bound on the H100.  At the config_hash shape (B = 2^18, 32 -> 64 -> 64
// -> 3, bf16) the function reads 16 MB of bf16 input and writes 3 MB of
// fp32 output: about 5.7 us at 3.35 TB/s, against 3.3 GFLOP, 3.4 us at the
// 989 TFLOP/s bf16 peak: bound by device memory.  The bf16 design reads
// each input once, keeps every activation on chip and stores only the
// D_out real columns; each CTA stages its input tile and, layer by layer,
// the weights (14 KB per tile at 64 x 2, from L2) in 16-byte chunks.  At
// the SDF shape (16 -> 64 x 2 -> 1, fp32) 2.7 GFLOP of fp32 FMA take
// 41 us at 67 TFLOP/s against 18 MB, 5 us: bound by the FMA units.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"
#include "mlp_common.cuh"

namespace tcnn_tpu_torch {
namespace {

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
  int y_bf16;  // the fp32 kernel's output dtype, a flag (one instance per width)
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

// Shared memory of the fp32 kernel, float offsets: the input tile (two
// buffers where they fit: the next tile arrives while this one computes),
// two ping-pong activation tiles, and the weights: all layers, resident
// for the CTA's whole walk over tiles, where they fit; else one layer at a
// time, staged per tile.
struct F32FwdLayout {
  int x0, x1, h0, h1, w;
  int n_xbuf, resident, bytes;
};

__host__ __device__ inline int f32_fan_in(int l, int d_in, int width) {
  return l == 0 ? d_in : width;
}
// Columns of layer l, and the row stride of its weights in shared memory.
__host__ __device__ inline int f32_fan_out(int l, int n_layers, int width, int d_out) {
  return l == n_layers - 1 ? d_out : width;
}
__host__ __device__ inline int f32_w_ld(int l, int n_layers, int width, int d_out) {
  return f32_ldw(f32_fan_out(l, n_layers, width, d_out));
}

inline F32FwdLayout f32_fwd_layout(int d_in, int d_out, int width, int n_layers) {
  F32FwdLayout s{};
  const int xf = pad4(d_in) * kLdF32, hf = width * kLdF32;
  int all = 0, one = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int f = f32_fan_in(l, d_in, width) * f32_w_ld(l, n_layers, width, d_out);
    all += f;
    one = f > one ? f : one;
  }
  const int base = xf + 2 * hf;
  s.resident = (base + all) * 4 <= kMaxSmem;
  const int wf = s.resident ? all : one;
  s.n_xbuf = (base + xf + wf) * 4 <= kMaxSmem ? 2 : 1;
  s.x0 = 0;
  s.x1 = s.n_xbuf == 2 ? xf : 0;
  s.h0 = s.n_xbuf * xf;
  s.h1 = s.h0 + hf;
  s.w = s.h1 + hf;
  s.bytes = (s.w + wf) * 4;
  return s;
}

// fp32 compute: persistent CTAs of kThreadsF32 threads walk the 64-row
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...  Per layer each thread
// computes a 4-row x W/8-column block by f32_product (mlp_common.cuh) and
// stores act(z) feature-major for the next layer.
template <int W>
__global__ void __launch_bounds__(kThreadsF32, 2)
fused_mlp_fwd_f32_kernel(MlpArgs a, F32FwdLayout s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* xb[2] = {sm + s.x0, sm + s.x1};
  float* hb[2] = {sm + s.h0, sm + s.h1};
  float* wsm = sm + s.w;
  const int L = a.n_layers, d_in = a.d_in;
  const int64_t n_tiles = (a.batch + kRowsF32 - 1) / kRowsF32;
  const float* x = static_cast<const float*>(a.x);
  const int rg = f32_rg();

  // Features [D_in, pad4(D_in)) of the input tiles stay zero.
  for (int i = threadIdx.x; i < (pad4(d_in) - d_in) * kLdF32; i += blockDim.x)
    xb[0][d_in * kLdF32 + i] = xb[1][d_in * kLdF32 + i] = 0.0f;
  const auto stage_w = [&](int l, float* dst) {
    const int n = f32_fan_out(l, L, W, a.d_out);
    stage_rowmajor<float>(static_cast<const float*>(a.w[l]), f32_fan_in(l, d_in, W), n,
                          f32_fan_in(l, d_in, W), padc(n), dst, f32_w_ld(l, L, W, a.d_out));
  };
  if (s.resident) {
    int off = 0;
    for (int l = 0; l < L; ++l) {
      stage_w(l, wsm + off);
      off += f32_fan_in(l, d_in, W) * f32_w_ld(l, L, W, a.d_out);
    }
  }

  const auto stage_x = [&](int64_t tile, float* dst) {
    stage_f32_tile(x, a.x_stride_b, a.x_stride_d, d_in, a.batch, tile * kRowsF32, dst);
  };
  walk_tiles(n_tiles, s.n_xbuf, xb, stage_x, [&](int64_t tile, const float* xt, bool) {
    const int64_t row0 = tile * kRowsF32;
    const float* in = xt;
    int off = 0;
    for (int l = 0; l < L; ++l) {
      const int k_real = f32_fan_in(l, d_in, W), ld = f32_w_ld(l, L, W, a.d_out);
      const float* wl = wsm + off;
      if (s.resident) {
        off += k_real * ld;
      } else {
        __syncthreads();  // the previous layer's weights are read, its outputs written
        stage_w(l, wsm);
        __syncthreads();
      }
      if (l < L - 1) {
        float acc[4][W / kColGroups];
        f32_product<W / kColGroups, false, true>(in, 0, wl, ld, k_real, 0, acc);
        float* out = hb[l % 2];
#pragma unroll
        for (int j = 0; j < W / kColGroups; ++j)
          *reinterpret_cast<float4*>(out + ((W / kColGroups) * f32_cg() + j) * kLdF32 + 4 * rg) =
              make_float4(activate(acc[0][j], a.act), activate(acc[1][j], a.act),
                          activate(acc[2][j], a.act), activate(acc[3][j], a.act));
        in = out;
        if (s.resident) __syncthreads();  // the next layer reads these activations
      } else {
        f32_product_cols<false, true>(in, 0, wl, ld, k_real, padc(a.d_out), [&](int c, auto& acc) {
          constexpr int TC = sizeof(acc[0]) / sizeof(float);
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            if (c + j >= a.d_out) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int64_t b = row0 + 4 * rg + i;
              if (b >= a.batch) continue;
              const int64_t e = b * a.y_stride_b + (c + j) * a.y_stride_d;
              const float v = activate(acc[i][j], a.out_act);
              if (a.y_bf16)
                store(static_cast<__nv_bfloat16*>(a.y) + e, v);
              else
                store(static_cast<float*>(a.y) + e, v);
            }
          }
        });
      }
    }
  });
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

cudaError_t launch_f32(const MlpArgs& a, int width, cudaStream_t stream) {
  const F32FwdLayout s = f32_fwd_layout(a.d_in, a.d_out, width, a.n_layers);
  const auto run = [&](auto kernel) {
    int ctas = 0;
    const cudaError_t err = persistent_ctas(kernel, kThreadsF32, s.bytes,
                                            (a.batch + kRowsF32 - 1) / kRowsF32, &ctas);
    if (err != cudaSuccess) return err;
    kernel<<<ctas, kThreadsF32, s.bytes, stream>>>(a, s);
    return cudaSuccess;
  };
  switch (width) {
    case 16: return run(fused_mlp_fwd_f32_kernel<16>);
    case 32: return run(fused_mlp_fwd_f32_kernel<32>);
    case 64: return run(fused_mlp_fwd_f32_kernel<64>);
    case 128: return run(fused_mlp_fwd_f32_kernel<128>);
    default: return cudaErrorInvalidValue;
  }
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
  a.y_bf16 = y_bf16 ? 1 : 0;
  if (compute_bf16)
    return y_bf16 ? launch_bf16<__nv_bfloat16>(a, width, stream)
                  : launch_bf16<float>(a, width, stream);
  return launch_f32(a, width, stream);
}

}  // namespace tcnn_tpu_torch

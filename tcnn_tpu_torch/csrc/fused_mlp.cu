// Kernel M: fused MLP forward, all layers in one kernel.
//
// Replaces the TPU's fused_mlp.py::_fwd_kernel (:100): one batch tile
// runs through every layer with the weights resident on chip and no
// activation ever written to device memory.
//
// bf16 compute (the BF16_POLICY path): persistent CTAs (persistent_ctas,
// mlp_common.cuh) of 8 warps walk 128-row tiles; warp w owns 16 rows of
// each, one m16 tile.  Each CTA stages every layer's
// weights, row-major, into shared memory once, where they fit (every
// configuration of the repo, config_oneblob's 128 -> 128 x 5 -> 3 in
// 180 KB), else one layer per tile between barriers.  Each warp holds its
// own input slice (bf16, zero-padded to a multiple of 16 features; rows
// past the batch are zeros and never stored), copied by cp.async as soon
// as its first layer has read the one before, so that it lands while the
// hidden layers compute; with resident weights nothing else is shared and
// no barrier separates tiles.  Products are mma.sync m16n8k16 bf16 with
// fp32 accumulation; A fragments of the input by ldmatrix (transposed for
// SoA input), B fragments by ldmatrix.trans of the row-major weights.  The
// activations never leave registers: the accumulators of one layer are,
// element for element, the A fragments of the next, so the activation is
// applied in fp32 and the result rounded to bf16 in place, as _fwd_kernel
// does (fused_mlp.py:104-110).  The output layer writes D_out columns to
// device memory in AoS or SoA order, in the output dtype.
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
// 989 TFLOP/s bf16 peak: bound by device memory.  At config_oneblob's
// 128 -> 128 x 5 -> 3, 43 GFLOP take 44 us at that peak against 70 MB,
// 21 us: bound by the tensor cores, which mma.sync reaches only in part
// (wgmma alone issues at the full rate).  The bf16 design reads each input
// once, keeps every activation on chip, stores only the D_out real
// columns and reads the weights from shared memory, staged once per CTA.
// At the SDF shape (16 -> 64 x 2 -> 1, fp32) 2.7 GFLOP of fp32 FMA take
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

// Threads of a bf16 CTA: a warp per 16 rows of a tile.
constexpr int kBf16FwdThreads = kRows / 16 * 32;

// Shared memory of the bf16 kernel, bytes: one input slice per warp (its
// 16 rows, row-major for AoS input, feature-major for SoA), then the
// weights: every layer, resident for the CTA's whole walk, where they fit;
// else one layer at a time, staged per tile.  Where even one layer and the
// slices do not fit, the CTA runs fewer warps.
struct Bf16FwdLayout {
  int warps;              // per CTA; a tile is warps · 16 rows
  int ldx, x_bytes;       // elements per row of a warp's slice, bytes of a slice
  int w, resident, bytes;
};

// Layer l's weights in shared memory, row-major: .x = pad16(fan_in) rows
// of .y = n + kSkew elements, n = W (pad16(D_out) for the output layer).
__host__ __device__ inline int2 bf16_w_shape(int l, int n_layers, int d_in, int d_out,
                                             int width) {
  const int k = pad16(l == 0 ? d_in : width);
  const int n = l == n_layers - 1 ? pad16(d_out) : width;
  return make_int2(k, n + kSkew);
}

inline Bf16FwdLayout bf16_fwd_layout(int d_in, int d_out, int width, int n_layers, bool soa_in) {
  Bf16FwdLayout s{};
  const int kin = pad16(d_in);
  s.ldx = soa_in ? 16 + kSkew : kin + kSkew;
  s.x_bytes = (soa_in ? kin : 16) * s.ldx * 2;
  int64_t all = 0, one = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int2 sh = bf16_w_shape(l, n_layers, d_in, d_out, width);
    const int64_t b = int64_t(sh.x) * sh.y * 2;
    all += b;
    one = b > one ? b : one;
  }
  s.warps = kBf16FwdThreads / 32;
  while (s.warps > 1 && int64_t(s.warps) * s.x_bytes + one > kMaxSmem) s.warps /= 2;
  s.w = s.warps * s.x_bytes;
  s.resident = s.w + all <= kMaxSmem;
  const int64_t bytes = s.w + (s.resident ? all : one);
  s.bytes = bytes > kMaxSmem ? kMaxSmem + 1 : int(bytes);
  return s;
}

// bf16 compute: persistent CTAs walk the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...; warp w owns rows [16·w, 16·(w+1)) of each tile and runs
// them through every layer alone: its input slice is its own, the
// resident weights are read-only, so no barrier separates tiles.  The
// warp copies its rows of the next tile into its slice by cp.async as
// soon as its first layer has read the current ones; they land while the
// hidden layers compute.  Per layer, mma.sync m16n8k16 with fp32
// accumulation; the accumulators of one layer are, element for element,
// the A fragments of the next (activation in fp32, rounded to bf16 in
// place: fused_mlp.py:104-110 of the JAX package).
template <int W, typename TOut>
__global__ void __launch_bounds__(kBf16FwdThreads)
fused_mlp_fwd_bf16_kernel(MlpArgs a, Bf16FwdLayout s) {
  constexpr int NT = W / 8;    // n-tiles of a hidden layer
  constexpr int KB = W / 16;   // k-steps of a layer fed by a hidden layer
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + warp * s.x_bytes);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + s.w);
  const int L = a.n_layers, d_in = a.d_in, kin = pad16(d_in);
  const int64_t rows_cta = int64_t(s.warps) * 16;
  const int64_t n_tiles = (a.batch + rows_cta - 1) / rows_cta;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const bool soa = a.soa_in != 0;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  const auto stage_w = [&](int l, __nv_bfloat16* dst) {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a.w[l]);
    const int k_real = l == 0 ? d_in : W, n_real = l == L - 1 ? a.d_out : W;
    const int n = l == L - 1 ? pad16(a.d_out) : W;
    stage_rowmajor<__nv_bfloat16>(src, k_real, n_real, pad16(k_real), n, dst,
                                  bf16_w_shape(l, L, d_in, a.d_out, W).y);
  };
  // This warp's rows [row0, row0 + 16) of the input into its slice: by
  // 16-byte cp.async for whole rows of 16-byte aligned data (done at the
  // next cp_async_wait_all), else element by element, zeros past the batch.
  const bool async_x =
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (soa ? a.x_stride_b == 1 && a.x_stride_d % 8 == 0
           : a.x_stride_d == 1 && a.x_stride_b % 8 == 0 && d_in % 8 == 0);
  const auto stage_x = [&](int64_t row0) {
    if (async_x && row0 + 16 <= a.batch) {
      if (soa) {
        for (int c = lane; c < d_in * 2; c += 32) {
          const int k = c / 2, q = c % 2;
          cp_async16(xs + k * s.ldx + 8 * q, x + k * a.x_stride_d + row0 + 8 * q);
        }
      } else {
        for (int c = lane; c < 16 * (d_in / 8); c += 32) {
          const int r = c / (d_in / 8), q = c % (d_in / 8);
          cp_async16(xs + r * s.ldx + 8 * q, x + (row0 + r) * a.x_stride_b + 8 * q);
        }
      }
      cp_async_commit();
      return;
    }
    const int total = 16 * kin;
    for (int base = lane; base < total; base += 32 * kBatch) {
      __nv_bfloat16 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + 32 * u, r = soa ? i % 16 : i / kin, k = soa ? i / 16 : i % kin;
        const int64_t b = row0 + r;
        v[u] = (i < total && b < a.batch && k < d_in) ? x[b * a.x_stride_b + k * a.x_stride_d]
                                                       : zero;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + 32 * u, r = soa ? i % 16 : i / kin, k = soa ? i / 16 : i % kin;
        if (i < total) xs[soa ? k * s.ldx + r : r * s.ldx + k] = v[u];
      }
    }
  };

  // The slice's padding (features [D_in, pad16(D_in))) stays zero.
  for (int i = lane; i < s.x_bytes / 16; i += 32)
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  if (s.resident) {
    int off = 0;
    for (int l = 0; l < L; ++l) {
      stage_w(l, wsm + off);
      const int2 sh = bf16_w_shape(l, L, d_in, a.d_out, W);
      off += sh.x * sh.y;
    }
  }
  int64_t tile = blockIdx.x;
  if (tile < n_tiles) stage_x(tile * rows_cta + warp * 16);
  __syncthreads();  // the resident weights are staged

  for (; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows_cta + warp * 16;
    cp_async_wait_all();
    __syncwarp();  // this warp's rows have landed
    float acc[NT][4];
    uint32_t afrag[KB][4];
    const __nv_bfloat16* wl = wsm;
    for (int layer = 0; layer < L; ++layer) {
      const int2 sh = bf16_w_shape(layer, L, d_in, a.d_out, W);
      const int ld = sh.y;
      if (!s.resident) {
        __syncthreads();  // every warp is done with the previous weights
        stage_w(layer, wsm);
        __syncthreads();
      }
      if (layer < L - 1) {
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        if (layer == 0) {
          for (int kb = 0; kb < kin / 16; ++kb) {
            uint32_t af[4];
            if (soa)
              load_a_trans(xs, s.ldx, 16 * kb, 0, af);
            else
              ldsm_x4(xs + (lane % 16) * s.ldx + 16 * kb + 8 * (lane / 16), af);
#pragma unroll
            for (int p = 0; p < W / 16; ++p) {
              uint32_t b[4];
              load_b_pair(wl, ld, 16 * kb, 16 * p, b);
              mma_bf16(acc[2 * p], af, b[0], b[1]);
              mma_bf16(acc[2 * p + 1], af, b[2], b[3]);
            }
          }
          __syncwarp();  // every lane has read the slice: the next tile may land in it
          if (tile + gridDim.x < n_tiles) stage_x((tile + gridDim.x) * rows_cta + warp * 16);
        } else {
#pragma unroll
          for (int kb = 0; kb < KB; ++kb)
#pragma unroll
            for (int p = 0; p < W / 16; ++p) {
              uint32_t b[4];
              load_b_pair(wl, ld, 16 * kb, 16 * p, b);
              mma_bf16(acc[2 * p], afrag[kb], b[0], b[1]);
              mma_bf16(acc[2 * p + 1], afrag[kb], b[2], b[3]);
            }
        }
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const float(&lo)[4] = acc[2 * kb];
          const float(&hi)[4] = acc[2 * kb + 1];
          afrag[kb][0] = pack_bf16(activate(lo[0], a.act), activate(lo[1], a.act));
          afrag[kb][1] = pack_bf16(activate(lo[2], a.act), activate(lo[3], a.act));
          afrag[kb][2] = pack_bf16(activate(hi[0], a.act), activate(hi[1], a.act));
          afrag[kb][3] = pack_bf16(activate(hi[2], a.act), activate(hi[3], a.act));
        }
      } else {
        // Output layer: 16 columns at a time; only the real ones leave.
        for (int p = 0; p < pad16(a.d_out) / 16; ++p) {
          float c[2][4] = {};
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            uint32_t b[4];
            load_b_pair(wl, ld, 16 * kb, 16 * p, b);
            mma_bf16(c[0], afrag[kb], b[0], b[1]);
            mma_bf16(c[1], afrag[kb], b[2], b[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int64_t b = row0 + g + 8 * (i / 2);
              const int n = 16 * p + 8 * h + 2 * t + i % 2;
              if (b < a.batch && n < a.d_out)
                store(static_cast<TOut*>(a.y) + b * a.y_stride_b + n * a.y_stride_d,
                      activate(c[h][i], a.out_act));
            }
        }
      }
      if (s.resident) wl += sh.x * ld;
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

template <int W, typename TOut>
cudaError_t launch_bf16_width(const MlpArgs& a, cudaStream_t stream) {
  const Bf16FwdLayout s = bf16_fwd_layout(a.d_in, a.d_out, W, a.n_layers, a.soa_in != 0);
  if (s.bytes > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = fused_mlp_fwd_bf16_kernel<W, TOut>;
  const int threads = s.warps * 32;
  const int64_t rows = int64_t(s.warps) * 16;
  int ctas = 0;
  const cudaError_t err =
      persistent_ctas(kernel, threads, s.bytes, (a.batch + rows - 1) / rows, &ctas);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, threads, s.bytes, stream>>>(a, s);
  return cudaSuccess;
}

template <typename TOut>
cudaError_t launch_bf16(const MlpArgs& a, int width, cudaStream_t stream) {
  switch (width) {
    case 16: return launch_bf16_width<16, TOut>(a, stream);
    case 32: return launch_bf16_width<32, TOut>(a, stream);
    case 64: return launch_bf16_width<64, TOut>(a, stream);
    case 128: return launch_bf16_width<128, TOut>(a, stream);
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

// Kernels M and MB for one layer streamed through shared memory: the
// instances that take a layer whose weights, with a batch tile of its
// input, do not fit in one CTA's shared memory, at any fan-in.
//
// Replaces, for those shapes, the first layer of the TPU's
// fused_mlp.py::_fwd_kernel (:100) and ::_bwd_kernel (:113), which hold
// every layer in VMEM.  Kernels M and MB (fused_mlp.cu, fused_mlp_bwd.cu)
// keep all of a tile's layers in one CTA's shared memory: layer 0's
// pad(D_in) x W weights and an input tile of D_in features.  Past about
// 207 inputs at width 128 in fp32 (M) or 464 in bf16 (MB, three layers)
// that no longer fits.  The wrappers (ops/cuda/fused_mlp.py: plan_runs) then
// run such a layer alone through these kernels, and the other layers
// through M and MB as before, in runs: the layer's output, the hidden
// activation in the compute dtype, is what one launch of M holds between
// those layers, so the chain keeps the fused chain's rounding points.
//
//  * forward (M, one layer): y = act(x W), W (K, N), N <= 128.  A CTA of
//    kThreadsF32 threads walks 64-row tiles (persistent, persistent_ctas);
//    per tile it streams x and W through shared memory in chunks of kChunk
//    input features, by cp.async into one of two buffers (the next chunk
//    lands while this one computes; AoS input, a ragged batch tile or
//    unaligned rows go element by element), converts each chunk to fp32
//    and adds its product into the fp32 sums z (f32_product, register
//    tiled: a thread owns 4 rows x N/8 columns).  Then y = act(z), written
//    in the output dtype.
//  * backward (MB, one layer): per tile z as above, dz = g · act'(z)
//    rounded to the compute dtype (MB's step at the first layer), kept in
//    shared memory; then x and W stream a second time, chunk by chunk:
//    dW[chunk] += x_chunkᵀ dz over the tile's rows (f32_wgrad: each element
//    one owner thread, a fixed order) into the CTA's partial dW in device
//    memory, and dx[:, chunk] = dz W_chunkᵀ, written in dx's dtype.
//    sum_partials_kernel adds the CTAs' partials in CTA order, so dW is the
//    same from run to run on a card, as MB's.
//
// Both compute dtypes run the same fp32 FMA products: bf16 operands are
// converted exactly to fp32 as a chunk lands, and a product of two bf16
// values is exact in fp32, so a bf16 layer's sums are fp32 sums of the
// plain version's terms (mma.sync's accumulation is fp32 as well).  The
// sums over K run in chunks: n terms summed in two orders differ by at most
// (n - 1)·2^-24·Σ|x·w|.
//
// What bounds it on the H100.  At the wide image's first layer (512 ->
// 128, bf16, B = 2^18) the backward does 3 x 34.4 GFLOP; on the fp32 FMA
// units (67 TFLOP/s) that is 1.5 ms against 0.27 GB moved, 0.08 ms:
// operations bound it, and the FMA units stand at 1/15 of the bf16 tensor
// cores' rate (the tensor cores' route is later work).  The partial dW
// takes K x N fp32 of reads and writes per tile in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"
#include "mlp_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kChunk = 32;         // input features per chunk
constexpr int kR = kRowsF32;       // rows of a tile
constexpr int kLd = f32_ld(kR);    // floats per feature row of a feature-major tile
constexpr int kMaxN = 128;         // the layer's columns, at most (TC = 16)

struct WideArgs {
  const void* x;
  int64_t x_stride_b, x_stride_d;
  int k, n;                   // the layer's fan-in and fan-out
  const void* w;              // (k, n) row-major, compute dtype
  void* y;                    // forward: (b, j) at y[b*y_stride_b + j*y_stride_d]
  int64_t y_stride_b, y_stride_d;
  int y_bf16;
  const float* g;             // backward: the output gradient, fp32
  int64_t g_stride_b, g_stride_d;
  void* dx;
  int64_t dx_stride_b, dx_stride_d;
  int dx_bf16;
  float* partials;            // (gridDim.x, k * n)
  int64_t batch;
  int act;
};

// Shared memory, bytes: two raw chunks of x (kChunk x kR, feature-major)
// and of W (kChunk x n), in the compute dtype, as cp.async lands them;
// their fp32 copies, x feature-major (kChunk x kLd) and W row-major
// (kChunk x np, the forward product) or transposed (np x kChunk, dx), in
// one buffer; and (backward) dz, feature-major (np x kLd).
struct WideLayout {
  int np;                     // n padded to the column groups' TC (8·TC)
  int xr[2], wr[2], xf, wf, dz, bytes;
};

template <typename T>
WideLayout wide_layout(int n, bool backward) {
  WideLayout s{};
  s.np = n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  const int xr = kChunk * kR * int(sizeof(T)), wr = (kChunk * n * int(sizeof(T)) + 15) / 16 * 16;
  s.xr[0] = 0;
  s.xr[1] = xr;
  s.wr[0] = 2 * xr;
  s.wr[1] = 2 * xr + wr;
  s.xf = 2 * xr + 2 * wr;
  s.wf = s.xf + kChunk * kLd * 4;
  s.dz = s.wf + kChunk * s.np * 4;
  s.bytes = s.dz + (backward ? s.np * kLd * 4 : 0);
  return s;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Issues the copies of chunk k0 of a tile into the raw buffers xr, wr: by
// 16-byte cp.async where the rows allow it (completed at the next
// cp_async_wait_all), else element by element; rows past the batch and
// features past K read as zeros (the fp32 copies take K's zeros).
template <typename T>
__device__ __forceinline__ void issue_chunk(const WideArgs& a, int64_t row0, int k0, T* xr,
                                            T* wr) {
  constexpr int kVec = 16 / int(sizeof(T));
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w) + int64_t(k0) * a.n;
  const int kc = min(kChunk, a.k - k0);
  const bool async_x = a.x_stride_b == 1 && a.x_stride_d % kVec == 0 && row0 + kR <= a.batch &&
                       (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (async_x) {
    constexpr int kPer = kR / kVec;   // 16-byte copies per feature row
    for (int c = threadIdx.x; c < kc * kPer; c += blockDim.x) {
      const int k = c / kPer, q = c % kPer;
      cp_async16(xr + k * kR + kVec * q, x + (k0 + k) * a.x_stride_d + row0 + kVec * q);
    }
  } else {
    staged_copy<T>(
        kc * kR,
        [&](int i) {
          const int r = a.x_stride_b == 1 ? i % kR : i / kc;
          const int k = a.x_stride_b == 1 ? i / kR : i % kc;
          const int64_t b = row0 + r;
          return b < a.batch ? x[b * a.x_stride_b + (k0 + k) * a.x_stride_d] : zero_val<T>();
        },
        [&](int i, T v) {
          const int r = a.x_stride_b == 1 ? i % kR : i / kc;
          const int k = a.x_stride_b == 1 ? i / kR : i % kc;
          xr[k * kR + r] = v;
        });
  }
  if ((a.n * int(sizeof(T))) % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    for (int c = threadIdx.x; c < kc * a.n / kVec; c += blockDim.x)
      cp_async16(wr + kVec * c, w + kVec * c);
  } else {
    staged_copy<T>(kc * a.n, [&](int i) { return w[i]; }, [&](int i, T v) { wr[i] = v; });
  }
  cp_async_commit();
}

// The fp32 copies of a landed chunk: x feature-major into xf, W row-major
// (np columns) into wf, or (transposed) Wᵀ as wf[n * kChunk + k]; zeros for
// features past K and columns past N.
template <typename T, bool kTransposed>
__device__ __forceinline__ void convert_chunk(const WideArgs& a, int k0, const T* xr,
                                              const T* wr, float* xf, float* wf, int np) {
  const int kc = min(kChunk, a.k - k0);
  for (int i = threadIdx.x; i < kChunk * kR; i += blockDim.x) {
    const int k = i / kR, r = i % kR;
    xf[k * kLd + r] = k < kc ? to_float(xr[i]) : 0.0f;
  }
  for (int i = threadIdx.x; i < kChunk * np; i += blockDim.x) {
    const int k = kTransposed ? i % kChunk : i / np, n = kTransposed ? i / kChunk : i % np;
    wf[i] = k < kc && n < a.n ? to_float(wr[k * a.n + n]) : 0.0f;
  }
}

// Walks K in chunks for one tile: body(k0, xf, wf) after each chunk's fp32
// copies, the next chunk's copies in flight meanwhile.
template <typename T, bool kTransposed, typename Body>
__device__ __forceinline__ void stream_k(const WideArgs& a, const WideLayout& s,
                                         unsigned char* smem, int64_t row0, Body body) {
  T* xr[2] = {reinterpret_cast<T*>(smem + s.xr[0]), reinterpret_cast<T*>(smem + s.xr[1])};
  T* wr[2] = {reinterpret_cast<T*>(smem + s.wr[0]), reinterpret_cast<T*>(smem + s.wr[1])};
  float* xf = reinterpret_cast<float*>(smem + s.xf);
  float* wf = reinterpret_cast<float*>(smem + s.wf);
  __syncthreads();   // the previous pass is done with every buffer
  issue_chunk<T>(a, row0, 0, xr[0], wr[0]);
  for (int k0 = 0, cur = 0; k0 < a.k; k0 += kChunk, cur ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // chunk k0 has landed; the last body is done with xf, wf
    if (k0 + kChunk < a.k) issue_chunk<T>(a, row0, k0 + kChunk, xr[cur ^ 1], wr[cur ^ 1]);
    convert_chunk<T, kTransposed>(a, k0, xr[cur], wr[cur], xf, wf, s.np);
    __syncthreads();
    body(k0, xf, wf);
  }
}

// z[i][j] = Σ_k x[4rg+i][k] · W[k][TC·cg+j] over the tile's rows, K in chunks.
template <typename T, int TC>
__device__ __forceinline__ void wide_z(const WideArgs& a, const WideLayout& s,
                                       unsigned char* smem, int64_t row0, float (&z)[4][TC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) z[i][j] = 0.0f;
  stream_k<T, false>(a, s, smem, row0, [&](int, const float* xf, const float* wf) {
    f32_product<TC, false, true, kR, true>(xf, 0, wf, s.np, kChunk, 0, z);
  });
}

// The forward: persistent CTAs walk the 64-row tiles.
template <typename T, int TC>
__global__ void __launch_bounds__(kThreadsF32, 2)
fused_mlp_wide_fwd_kernel(WideArgs a, WideLayout s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rg = f32_rg(), c0 = TC * f32_cg();
  const int64_t n_tiles = (a.batch + kR - 1) / kR;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kR;
    float z[4][TC];
    wide_z<T, TC>(a, s, smem, row0, z);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t b = row0 + 4 * rg + i;
      if (b >= a.batch) continue;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        if (c0 + j >= a.n) continue;
        const int64_t e = b * a.y_stride_b + (c0 + j) * a.y_stride_d;
        const float v = activate(z[i][j], a.act);
        if (a.y_bf16)
          store(static_cast<__nv_bfloat16*>(a.y) + e, v);
        else
          store(static_cast<float*>(a.y) + e, v);
      }
    }
  }
}

// The backward: persistent CTAs walk the 64-row tiles; each CTA's partial
// dW (k x n) in device memory, stored on its first tile, added to after.
template <typename T, int TC>
__global__ void __launch_bounds__(kThreadsF32, 2)
fused_mlp_wide_bwd_kernel(WideArgs a, WideLayout s) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* dz = reinterpret_cast<float*>(smem + s.dz);
  const int rg = f32_rg(), c0 = TC * f32_cg();
  const int64_t n_tiles = (a.batch + kR - 1) / kR;
  float* part = a.partials + int64_t(blockIdx.x) * a.k * a.n;
  bool first = true;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int64_t row0 = tile * kR;
    float z[4][TC];
    wide_z<T, TC>(a, s, smem, row0, z);
    // dz = g · act'(z), rounded to the compute dtype; zero past the batch
    // and past N (np columns: f32_wgrad reads pad8(N) rows)
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t b = row0 + 4 * rg + i;
        const int n = c0 + j;
        const float gv = b < a.batch && n < a.n ? a.g[b * a.g_stride_b + n * a.g_stride_d] : 0.0f;
        d[i] = round_to(gv * activate_derivative(z[i][j], a.act), static_cast<T*>(nullptr));
      }
      *reinterpret_cast<float4*>(dz + (c0 + j) * kLd + 4 * rg) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
    stream_k<T, true>(a, s, smem, row0, [&](int k0, const float* xf, const float* wt) {
      const int kc = min(kChunk, a.k - k0);
      f32_wgrad<kR, false, true>(xf, 0, dz, kc, a.n, part + int64_t(k0) * a.n, first);
      float acc[4][kChunk / 8];
      f32_product<kChunk / 8, false, true, kR>(dz, 0, wt, kChunk, a.n, 0, acc);
      const int cx = (kChunk / 8) * f32_cg();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t b = row0 + 4 * rg + i;
        if (b >= a.batch) continue;
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
          if (cx + j >= kc) continue;
          const int64_t e = b * a.dx_stride_b + (k0 + cx + j) * a.dx_stride_d;
          if (a.dx_bf16)
            store(static_cast<__nv_bfloat16*>(a.dx) + e, acc[i][j]);
          else
            store(static_cast<float*>(a.dx) + e, acc[i][j]);
        }
      }
    });
  }
}

// fn(kernel) with the instance of these arguments' dtype and column count.
template <bool kBackward, typename T, typename Fn>
cudaError_t with_wide_kernel(int np, Fn fn) {
#define TCNN_WIDE_CASE(TC)                                                          \
  case 8 * TC:                                                                      \
    return kBackward ? fn(fused_mlp_wide_bwd_kernel<T, TC>) : fn(fused_mlp_wide_fwd_kernel<T, TC>);
  switch (np) {
    TCNN_WIDE_CASE(1)
    TCNN_WIDE_CASE(2)
    TCNN_WIDE_CASE(4)
    TCNN_WIDE_CASE(8)
    TCNN_WIDE_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef TCNN_WIDE_CASE
}

template <bool kBackward, typename T>
cudaError_t launch_wide(WideArgs& a, const std::function<float*(int64_t)>* scratch, float* dw,
                        cudaStream_t stream) {
  const WideLayout s = wide_layout<T>(a.n, kBackward);
  const int64_t n_tiles = (a.batch + kR - 1) / kR;
  int ctas = 0;
  const cudaError_t err = with_wide_kernel<kBackward, T>(s.np, [&](auto kernel) {
    const cudaError_t e = persistent_ctas(kernel, kThreadsF32, s.bytes, n_tiles, &ctas);
    if (e != cudaSuccess) return e;
    if (kBackward) a.partials = (*scratch)(int64_t(ctas) * a.k * a.n);
    kernel<<<ctas, kThreadsF32, s.bytes, stream>>>(a, s);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || !kBackward) return err;
  const int64_t total = int64_t(a.k) * a.n;
  sum_partials_kernel<<<unsigned((total + 255) / 256), 256, 0, stream>>>(a.partials, ctas,
                                                                         total, dw);
  return cudaGetLastError();
}

}  // namespace

cudaError_t fused_mlp_wide_fwd_launch(const void* x, int64_t x_stride_b, int64_t x_stride_d,
                                      int k, const void* w, int n, void* y, int64_t y_stride_b,
                                      int64_t y_stride_d, bool y_bf16, int64_t batch,
                                      bool compute_bf16, int act, cudaStream_t stream) {
  if (batch <= 0 || k < 1 || n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  WideArgs a{};
  a.x = x;
  a.x_stride_b = x_stride_b;
  a.x_stride_d = x_stride_d;
  a.k = k;
  a.n = n;
  a.w = w;
  a.y = y;
  a.y_stride_b = y_stride_b;
  a.y_stride_d = y_stride_d;
  a.y_bf16 = y_bf16 ? 1 : 0;
  a.batch = batch;
  a.act = act;
  return compute_bf16 ? launch_wide<false, __nv_bfloat16>(a, nullptr, nullptr, stream)
                      : launch_wide<false, float>(a, nullptr, nullptr, stream);
}

cudaError_t fused_mlp_wide_bwd_launch(const void* x, int64_t x_stride_b, int64_t x_stride_d,
                                      int k, const void* w, int n, const float* g,
                                      int64_t g_stride_b, int64_t g_stride_d, void* dx,
                                      int64_t dx_stride_b, int64_t dx_stride_d, bool dx_bf16,
                                      const std::function<float*(int64_t)>& scratch, float* dw,
                                      int64_t batch, bool compute_bf16, int act,
                                      cudaStream_t stream) {
  if (batch <= 0 || k < 1 || n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  WideArgs a{};
  a.x = x;
  a.x_stride_b = x_stride_b;
  a.x_stride_d = x_stride_d;
  a.k = k;
  a.n = n;
  a.w = w;
  a.g = g;
  a.g_stride_b = g_stride_b;
  a.g_stride_d = g_stride_d;
  a.dx = dx;
  a.dx_stride_b = dx_stride_b;
  a.dx_stride_d = dx_stride_d;
  a.dx_bf16 = dx_bf16 ? 1 : 0;
  a.batch = batch;
  a.act = act;
  return compute_bf16 ? launch_wide<true, __nv_bfloat16>(a, &scratch, dw, stream)
                      : launch_wide<true, float>(a, &scratch, dw, stream);
}

}  // namespace tcnn_tpu_torch

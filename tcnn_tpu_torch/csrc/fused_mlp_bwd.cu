// Kernel MB: fused MLP backward, all layers in one kernel.
//
// Replaces the TPU's fused_mlp.py::_bwd_kernel (:113).  Per batch tile it
// recomputes the forward as kernel M does, then runs the dgrad chain and
// the weight gradient of every layer, with the same rounding points as the
// JAX kernel: dz = g * out_act'(z_out) rounded to the compute dtype;
// dW_out += h^T dz; dh = dz W_out^T in fp32; per hidden layer
// dz_k = dh * act'(z_k) rounded, dW_k += h_{k-1}^T dz_k, dh = dz_k W_k^T;
// finally dW_in += x^T dz_1 and dx = dz_1 W_in^T in fp32, written in the
// dtype of dx.
//
// The weight gradient is a sum over the whole batch.  The TPU summed it
// in its sequential grid, so deterministically.  Here a fixed number of
// persistent CTAs (chosen by the caller from the SM count) each walk the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... and keep their own fp32
// partial dW in device memory (written on the first tile, added to after);
// a second small kernel sums the partials in CTA order.  The result does
// not depend on scheduling, so it is the same from run to run on a card.
//
// bf16 compute (BF16_POLICY): 8 warps per CTA, warp w owning rows
// [16w, 16w+16) of a 128-row tile, mma.sync m16n8k16 with fp32
// accumulation as in M.  The forward keeps each hidden layer's fp32
// pre-activation z_k in shared memory (act'(z_k) and h_k = bf16(act(z_k))
// are both taken from it, exactly); dz of the current layer is kept in
// shared memory in bf16 for the weight gradient and in registers, as A
// fragments, for the dgrad product.  The weight gradient h^T dz contracts
// over the tile's 128 rows: each warp owns whole 16 x 16 blocks of dW and
// reads both operands transposed from shared memory (ldmatrix.trans for
// bf16, scalar loads through act() for z).  Weights are staged per layer
// and per tile, transposed, in shared memory; the dgrad product reads them
// through ldmatrix.trans.
//
// fp32 compute (DEFAULT_POLICY): plain fp32 FMA loops, no TF32; 64-row
// tiles, 128 threads, thread t owning row t % 64 in the row-wise phases
// and every 128th element of dW in the weight gradient.
//
// Bound on the H100: at the config_hash shape (B = 2^18, 32 -> 64 -> 64 ->
// 3, bf16, SoA input, AoS gradient) the function reads 16.8 MB of input and
// 3.1 MB of output gradient and writes 16.8 MB of bf16 input gradient:
// about 36.7 MB, 11 us at 3.35 TB/s, against 3 x 3.3 GFLOP of bf16
// products, 10 us at the 989 TFLOP/s bf16 peak.  Recomputing the forward
// costs one third of the products and saves a 2 x 33 MB activation stash.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"
#include "mlp_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kRowsF32 = 64;     // fp32 kernel: batch rows per tile
constexpr int kThreadsF32 = 128;

struct BwdArgs {
  const void* x;
  int64_t x_stride_b, x_stride_d;
  int d_in;
  const void* w[kMaxLayers];  // layer l: (fan_in, fan_out) row-major, compute dtype
  int n_layers, width, d_out;
  const float* g;
  int64_t g_stride_b, g_stride_d;
  void* dx;
  int64_t dx_stride_b, dx_stride_d;
  int dx_bf16;                // dx's dtype: a runtime flag, not a template
                              // parameter, halves the instances ptxas builds
  float* partials;            // (gridDim.x, total_dw)
  int64_t total_dw;
  int64_t batch;
  int act, out_act;
  int soa_in;
};

__host__ __device__ inline int fan_in_of(const BwdArgs& a, int l) {
  return l == 0 ? a.d_in : a.width;
}
__host__ __device__ inline int fan_out_of(const BwdArgs& a, int l) {
  return l == a.n_layers - 1 ? a.d_out : a.width;
}
// Offset of layer l's (fan_in, fan_out) block in the flat dW.
__host__ __device__ inline int64_t dw_offset(const BwdArgs& a, int l) {
  return l == 0 ? 0 : int64_t(a.d_in) * a.width + int64_t(l - 1) * a.width * a.width;
}

// Adds c into this CTA's partial dW, or stores it on the CTA's first tile.
__device__ __forceinline__ void accumulate(float* p, float c, bool first) {
  *p = first ? c : *p + c;
}

// Writes element (b, d) of dx in its dtype.
__device__ __forceinline__ void store_dx(const BwdArgs& a, int64_t b, int d, float v) {
  const int64_t i = b * a.dx_stride_b + d * a.dx_stride_d;
  if (a.dx_bf16)
    store(static_cast<__nv_bfloat16*>(a.dx) + i, v);
  else
    store(static_cast<float*>(a.dx) + i, v);
}

// ---------------------------------------------------------------------------
// bf16 kernel
// ---------------------------------------------------------------------------

struct Bf16Layout {
  int ldx, ldw, rows_w, ldd, ldz;
  int xs, wt, dz, zs, bytes;  // byte offsets, total
};

__host__ __device__ inline Bf16Layout bf16_layout(int d_in, int d_out, int width,
                                                 int n_layers) {
  Bf16Layout s;
  const int kin = pad16(d_in), kout = pad16(d_out);
  s.ldx = kin + kSkew;
  s.ldw = (kin > width ? kin : width) + kSkew;
  s.rows_w = kout > width ? kout : width;
  s.ldd = (kout > width ? kout : width) + kSkew;
  s.ldz = width + 4;  // ≡ 4 (mod 32) words: conflict-free transposed reads
  s.xs = 0;
  s.wt = s.xs + kRows * s.ldx * 2;
  s.dz = s.wt + s.rows_w * s.ldw * 2;
  s.zs = s.dz + kRows * s.ldd * 2;
  s.bytes = s.zs + (n_layers - 1) * kRows * s.ldz * 4;
  return s;
}

// The weight gradient of one layer over the tile's 128 rows,
// dW[m][n] += Σ_r h[r][m] · dz[r][n], shared among the warps by 16 x 16
// blocks.  a_frag(k0, m0, af) yields the A fragment of hᵀ at rows
// [k0, k0+16) of the tile and columns [m0, m0+16) of h.
template <typename AFrag>
__device__ __forceinline__ void wgrad_bf16(const BwdArgs& a, int layer, AFrag a_frag,
                                           const __nv_bfloat16* dz, int ldd, bool first) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int fan_in = fan_in_of(a, layer), fan_out = fan_out_of(a, layer);
  const int n_mt = pad16(fan_in) / 16, n_np = pad16(fan_out) / 16;
  float* part = a.partials + blockIdx.x * a.total_dw + dw_offset(a, layer);
  for (int u = warp; u < n_mt * n_np; u += kWarps) {
    const int mt = u / n_np, np = u % n_np;
    float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kb = 0; kb < kRows / 16; ++kb) {
      uint32_t af[4], b[4];
      a_frag(16 * kb, 16 * mt, af);
      load_b_pair(dz, ldd, 16 * kb, 16 * np, b);
      mma_bf16(c[0], af, b[0], b[1]);
      mma_bf16(c[1], af, b[2], b[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 16 * mt + g + 8 * (i / 2);
        const int n = 16 * np + 8 * h + 2 * t + i % 2;
        if (m < fan_in && n < fan_out) accumulate(part + m * fan_out + n, c[h][i], first);
      }
  }
}

// The A fragment of act(z)ᵀ, rounded to bf16, at tile rows [k0, k0+16)
// and columns [m0, m0+16) of a row-major fp32 z tile in shared memory
// (row stride ld words): scalar loads, the activation on each element.
template <bool kFast>
__device__ __forceinline__ void load_act_a_trans(const float* z, int ld, int act, int k0,
                                                 int m0, uint32_t (&af)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* p = z + (k0 + 2 * t) * ld + m0 + g;
  af[0] = pack_bf16(act_fn<kFast>(p[0], act), act_fn<kFast>(p[ld], act));
  af[1] = pack_bf16(act_fn<kFast>(p[8], act), act_fn<kFast>(p[ld + 8], act));
  af[2] = pack_bf16(act_fn<kFast>(p[8 * ld], act), act_fn<kFast>(p[9 * ld], act));
  af[3] = pack_bf16(act_fn<kFast>(p[8 * ld + 8], act), act_fn<kFast>(p[9 * ld + 8], act));
}

// kFast: every activation is None or ReLU (mlp_common.cuh: act_fn).
template <int W, bool kFast>
__global__ void __launch_bounds__(kWarps * 32)
fused_mlp_bwd_bf16_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Layout s = bf16_layout(a.d_in, a.d_out, W, a.n_layers);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + s.xs);  // xs[r * ldx + k]
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + s.wt);  // wt[n * ldw + k]
  __nv_bfloat16* dzs = reinterpret_cast<__nv_bfloat16*>(smem + s.dz); // dz[r * ldd + n]
  float* zs = reinterpret_cast<float*>(smem + s.zs);  // z_k[r * ldz + n] per hidden layer

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  const int L = a.n_layers;
  const int64_t n_tiles = (a.batch + kRows - 1) / kRows;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  constexpr int NT = W / 8;    // n-tiles of a hidden layer
  constexpr int KB = W / 16;   // k-steps of a product fed by a hidden layer
  float acc[NT][4];
  uint32_t afrag[KB][4];

  const auto x_frag = [&](int k0, int m0, uint32_t(&af)[4]) {
    load_a_trans(xs, s.ldx, k0, m0, af);
  };

  bool first = true;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int64_t row0 = tile * kRows;
    __syncthreads();  // the previous tile's readers of shared memory are done
    stage_input_tile(x, a.x_stride_b, a.x_stride_d, a.d_in, a.batch, row0, a.soa_in != 0,
                     xs, s.ldx);

    // -- forward, recomputed as in kernel M, keeping each z_k -----------
    for (int layer = 0; layer < L; ++layer) {
      const bool last = layer == L - 1;
      const int k_real = fan_in_of(a, layer), n_real = fan_out_of(a, layer);
      const int K = pad16(k_real), N = last ? pad16(n_real) : W;
      __syncthreads();
      stage_weights_t<W>(static_cast<const __nv_bfloat16*>(a.w[layer]), k_real, n_real, K, N,
                         wt, s.ldw);
      __syncthreads();
      if (!last) {
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        if (layer == 0) {
          const __nv_bfloat16* arow = xs + r0 * s.ldx + 2 * t;
          for (int kb = 0; kb < K / 16; ++kb) {
            const uint32_t af[4] = {ld32(arow + 16 * kb), ld32(arow + 8 * s.ldx + 16 * kb),
                                    ld32(arow + 16 * kb + 8),
                                    ld32(arow + 8 * s.ldx + 16 * kb + 8)};
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              uint32_t b0, b1;
              load_b(wt, s.ldw, j, kb, g, t, &b0, &b1);
              mma_bf16(acc[j], af, b0, b1);
            }
          }
        } else {
#pragma unroll
          for (int kb = 0; kb < KB; ++kb)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              uint32_t b0, b1;
              load_b(wt, s.ldw, j, kb, g, t, &b0, &b1);
              mma_bf16(acc[j], afrag[kb], b0, b1);
            }
        }
        float* z = zs + layer * kRows * s.ldz;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          *reinterpret_cast<float2*>(z + r0 * s.ldz + 8 * j + 2 * t) =
              make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(z + (r0 + 8) * s.ldz + 8 * j + 2 * t) =
              make_float2(acc[j][2], acc[j][3]);
        }
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          afrag[kb][0] = pack_bf16(act_fn<kFast>(acc[2 * kb][0], a.act),
                                   act_fn<kFast>(acc[2 * kb][1], a.act));
          afrag[kb][1] = pack_bf16(act_fn<kFast>(acc[2 * kb][2], a.act),
                                   act_fn<kFast>(acc[2 * kb][3], a.act));
          afrag[kb][2] = pack_bf16(act_fn<kFast>(acc[2 * kb + 1][0], a.act),
                                   act_fn<kFast>(acc[2 * kb + 1][1], a.act));
          afrag[kb][3] = pack_bf16(act_fn<kFast>(acc[2 * kb + 1][2], a.act),
                                   act_fn<kFast>(acc[2 * kb + 1][3], a.act));
        }
      } else {
        // Output layer: dz = g · out_act'(z_out), rounded, into shared memory
        // (zero in the padding columns and past the batch).
        for (int j = 0; j < N / 8; ++j) {
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            uint32_t b0, b1;
            load_b(wt, s.ldw, j, kb, g, t, &b0, &b1);
            mma_bf16(c, afrag[kb], b0, b1);
          }
          float d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int64_t b = row0 + r0 + 8 * (i / 2);
            const int n = 8 * j + 2 * t + i % 2;
            const float gv = (b < a.batch && n < a.d_out)
                ? a.g[b * a.g_stride_b + n * a.g_stride_d] : 0.0f;
            d[i] = gv * act_grad<kFast>(c[i], a.out_act);
          }
          *reinterpret_cast<uint32_t*>(dzs + r0 * s.ldd + 8 * j + 2 * t) = pack_bf16(d[0], d[1]);
          *reinterpret_cast<uint32_t*>(dzs + (r0 + 8) * s.ldd + 8 * j + 2 * t) =
              pack_bf16(d[2], d[3]);
        }
      }
    }
    __syncthreads();  // dz_out is complete

    // -- backward ------------------------------------------------------
    // Output layer: wgrad from h_{L-2} = act(z_{L-2}); dgrad with W_out,
    // still staged in wt (rows: output index, columns: hidden index).
    {
      const float* zp = zs + (L - 2) * kRows * s.ldz;
      const auto h_frag = [&](int k0, int m0, uint32_t(&af)[4]) {
        load_act_a_trans<kFast>(zp, s.ldz, a.act, k0, m0, af);
      };
      wgrad_bf16(a, L - 1, h_frag, dzs, s.ldd, first);
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      const __nv_bfloat16* arow = dzs + r0 * s.ldd + 2 * t;
      for (int kb = 0; kb < pad16(a.d_out) / 16; ++kb) {
        const uint32_t af[4] = {ld32(arow + 16 * kb), ld32(arow + 8 * s.ldd + 16 * kb),
                                ld32(arow + 16 * kb + 8), ld32(arow + 8 * s.ldd + 16 * kb + 8)};
#pragma unroll
        for (int p = 0; p < W / 16; ++p) {
          uint32_t b[4];
          load_b_pair(wt, s.ldw, 16 * kb, 16 * p, b);
          mma_bf16(acc[2 * p], af, b[0], b[1]);
          mma_bf16(acc[2 * p + 1], af, b[2], b[3]);
        }
      }
    }

    for (int layer = L - 2; layer >= 0; --layer) {
      // dz_k = dh · act'(z_k), rounded; its A fragments stay in registers.
      const float* z = zs + layer * kRows * s.ldz;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 za = *reinterpret_cast<const float2*>(z + r0 * s.ldz + 8 * j + 2 * t);
        const float2 zb = *reinterpret_cast<const float2*>(z + (r0 + 8) * s.ldz + 8 * j + 2 * t);
        acc[j][0] *= act_grad<kFast>(za.x, a.act);
        acc[j][1] *= act_grad<kFast>(za.y, a.act);
        acc[j][2] *= act_grad<kFast>(zb.x, a.act);
        acc[j][3] *= act_grad<kFast>(zb.y, a.act);
      }
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        afrag[kb][0] = pack_bf16(acc[2 * kb][0], acc[2 * kb][1]);
        afrag[kb][1] = pack_bf16(acc[2 * kb][2], acc[2 * kb][3]);
        afrag[kb][2] = pack_bf16(acc[2 * kb + 1][0], acc[2 * kb + 1][1]);
        afrag[kb][3] = pack_bf16(acc[2 * kb + 1][2], acc[2 * kb + 1][3]);
      }
      __syncthreads();  // every warp is done with the previous dz and weights
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        __nv_bfloat16* p = dzs + r0 * s.ldd + 16 * kb + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = afrag[kb][0];
        *reinterpret_cast<uint32_t*>(p + 8 * s.ldd) = afrag[kb][1];
        *reinterpret_cast<uint32_t*>(p + 8) = afrag[kb][2];
        *reinterpret_cast<uint32_t*>(p + 8 * s.ldd + 8) = afrag[kb][3];
      }
      const int k_real = fan_in_of(a, layer);
      stage_weights_t<W>(static_cast<const __nv_bfloat16*>(a.w[layer]), k_real, W,
                         pad16(k_real), W, wt, s.ldw);
      __syncthreads();

      if (layer == 0) {
        wgrad_bf16(a, 0, x_frag, dzs, s.ldd, first);
        // dx = dz_1 · W_inᵀ in fp32, only the real rows and columns stored.
        for (int p = 0; p < pad16(a.d_in) / 16; ++p) {
          float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            uint32_t b[4];
            load_b_pair(wt, s.ldw, 16 * kb, 16 * p, b);
            mma_bf16(c[0], afrag[kb], b[0], b[1]);
            mma_bf16(c[1], afrag[kb], b[2], b[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int64_t b = row0 + r0 + 8 * (i / 2);
              const int n = 16 * p + 8 * h + 2 * t + i % 2;
              if (b < a.batch && n < a.d_in) store_dx(a, b, n, c[h][i]);
            }
        }
      } else {
        const float* zp = zs + (layer - 1) * kRows * s.ldz;
        const auto h_frag = [&](int k0, int m0, uint32_t(&af)[4]) {
          load_act_a_trans<kFast>(zp, s.ldz, a.act, k0, m0, af);
        };
        wgrad_bf16(a, layer, h_frag, dzs, s.ldd, first);
        // dh = dz_k · W_kᵀ
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
#pragma unroll
          for (int p = 0; p < W / 16; ++p) {
            uint32_t b[4];
            load_b_pair(wt, s.ldw, 16 * kb, 16 * p, b);
            mma_bf16(acc[2 * p], afrag[kb], b[0], b[1]);
            mma_bf16(acc[2 * p + 1], afrag[kb], b[2], b[3]);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 kernel
// ---------------------------------------------------------------------------

struct F32Layout {
  int ldx, ldz, ldd, ldh, wfloats;
  int xs, zs, dz, dh, w, bytes;  // float offsets; total bytes
};

inline F32Layout f32_layout(int d_in, int d_out, int width, int n_layers) {
  F32Layout s;
  s.ldx = d_in + 1;  // odd strides: the rows of a warp fall in distinct banks
  s.ldz = width + 1;
  s.ldd = (d_out > width ? d_out : width) + 1;
  s.ldh = width + 1;
  const int kin = pad16(d_in), kout = pad16(d_out);
  int wmax = kin * width;
  if (width * width > wmax) wmax = width * width;
  if (width * kout > wmax) wmax = width * kout;
  s.wfloats = wmax;
  s.xs = 0;
  s.zs = s.xs + kRowsF32 * s.ldx;
  s.dz = s.zs + (n_layers - 1) * kRowsF32 * s.ldz;
  s.dh = s.dz + kRowsF32 * s.ldd;
  s.w = s.dh + kRowsF32 * s.ldh;
  s.bytes = (s.w + s.wfloats) * 4;
  return s;
}

__global__ void __launch_bounds__(kThreadsF32)
fused_mlp_bwd_f32_kernel(BwdArgs a, F32Layout s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* xs = smem + s.xs;
  float* zs = smem + s.zs;
  float* dz = smem + s.dz;
  float* dh = smem + s.dh;
  float* ws = smem + s.w;  // current layer, ws[k * N + n], zero-padded to (pad16, pad16)

  const int tid = threadIdx.x;
  const int r = tid % kRowsF32, part = tid / kRowsF32;
  constexpr int n_parts = kThreadsF32 / kRowsF32;
  const int L = a.n_layers, W = a.width;
  const int64_t n_tiles = (a.batch + kRowsF32 - 1) / kRowsF32;
  const float* x = static_cast<const float*>(a.x);

  const auto stage_w = [&](int layer) {
    const int k_real = fan_in_of(a, layer), n_real = fan_out_of(a, layer);
    const int N = pad16(n_real);
    const float* w = static_cast<const float*>(a.w[layer]);
    staged_copy<float>(
        pad16(k_real) * N,
        [&](int i) {
          const int k = i / N, n = i % N;
          return (k < k_real && n < n_real) ? w[k * n_real + n] : 0.0f;
        },
        [&](int i, float v) { ws[i] = v; });
  };
  // h_{layer}[r][k]: the input for layer 0, act(z) after a hidden layer.
  const auto h_in = [&](int layer, int row, int k) {
    return layer == 0 ? xs[row * s.ldx + k]
                      : activate(zs[(layer - 1) * kRowsF32 * s.ldz + row * s.ldz + k], a.act);
  };

  bool first = true;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int64_t row0 = tile * kRowsF32;
    __syncthreads();
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
          xs[rr * s.ldx + k] = v;
        });

    // -- forward, keeping z of every hidden layer, dz of the output layer
    for (int layer = 0; layer < L; ++layer) {
      const bool last = layer == L - 1;
      const int k_real = fan_in_of(a, layer), n_real = fan_out_of(a, layer);
      const int N = pad16(n_real);
      __syncthreads();
      stage_w(layer);
      __syncthreads();
      for (int n0 = part * 16; n0 < N; n0 += 16 * n_parts) {
        float acc[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
        for (int k = 0; k < k_real; ++k) {
          const float h = h_in(layer, r, k);
          const float* wk = ws + k * N + n0;
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[j] = fmaf(h, wk[j], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + j;
          if (n >= n_real) continue;
          if (!last) {
            zs[layer * kRowsF32 * s.ldz + r * s.ldz + n] = acc[j];
          } else {
            const int64_t b = row0 + r;
            const float gv = b < a.batch ? a.g[b * a.g_stride_b + n * a.g_stride_d] : 0.0f;
            dz[r * s.ldd + n] = gv * activate_derivative(acc[j], a.out_act);
          }
        }
      }
    }
    __syncthreads();

    // -- backward: wgrad and dgrad of each layer, output layer first -----
    for (int layer = L - 1; layer >= 0; --layer) {
      const int fan_in = fan_in_of(a, layer), fan_out = fan_out_of(a, layer);
      const int N = pad16(fan_out);
      if (layer < L - 1) {
        for (int n = part; n < W; n += n_parts)
          dz[r * s.ldd + n] = dh[r * s.ldh + n] *
              activate_derivative(zs[layer * kRowsF32 * s.ldz + r * s.ldz + n], a.act);
        stage_w(layer);
        __syncthreads();
      }
      float* pw = a.partials + blockIdx.x * a.total_dw + dw_offset(a, layer);
      for (int e = tid; e < fan_in * fan_out; e += kThreadsF32) {
        const int m = e / fan_out, n = e % fan_out;
        float sum = 0.0f;
        for (int rr = 0; rr < kRowsF32; ++rr) sum = fmaf(h_in(layer, rr, m), dz[rr * s.ldd + n], sum);
        accumulate(pw + e, sum, first);
      }
      for (int m0 = part * 16; m0 < fan_in; m0 += 16 * n_parts) {
        float acc[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
        for (int n = 0; n < fan_out; ++n) {
          const float d = dz[r * s.ldd + n];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[j] = fmaf(d, ws[(m0 + j) * N + n], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int m = m0 + j;
          if (m >= fan_in) continue;
          if (layer > 0) {
            dh[r * s.ldh + m] = acc[j];
          } else {
            const int64_t b = row0 + r;
            if (b < a.batch) store_dx(a, b, m, acc[j]);
          }
        }
      }
      __syncthreads();  // dh is complete; dz and ws are free
    }
  }
}

// dw[i] = Σ_c partials[c][i], summed in CTA order: deterministic.
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ partials, int n_parts, int64_t total,
                    float* __restrict__ dw) {
  const int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  float sum = 0.0f;
  for (int c = 0; c < n_parts; ++c) sum += partials[c * total + i];
  dw[i] = sum;
}

template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, int n_ctas, int threads, int smem,
                             cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_ctas, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <bool kFast>
cudaError_t launch_bf16(const BwdArgs& a, int n_ctas, cudaStream_t stream) {
  const int smem = bf16_layout(a.d_in, a.d_out, a.width, a.n_layers).bytes;
  const int threads = kWarps * 32;
  switch (a.width) {
    case 16: return launch_with_smem(fused_mlp_bwd_bf16_kernel<16, kFast>, n_ctas, threads, smem, stream, a);
    case 32: return launch_with_smem(fused_mlp_bwd_bf16_kernel<32, kFast>, n_ctas, threads, smem, stream, a);
    case 64: return launch_with_smem(fused_mlp_bwd_bf16_kernel<64, kFast>, n_ctas, threads, smem, stream, a);
    case 128: return launch_with_smem(fused_mlp_bwd_bf16_kernel<128, kFast>, n_ctas, threads, smem, stream, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

int fused_mlp_bwd_smem_bytes(int d_in, int d_out, int width, int n_layers,
                             bool compute_bf16) {
  return compute_bf16 ? bf16_layout(d_in, d_out, width, n_layers).bytes
                      : f32_layout(d_in, d_out, width, n_layers).bytes;
}

cudaError_t fused_mlp_bwd_launch(
    const void* x, int64_t x_stride_b, int64_t x_stride_d, int d_in,
    const void* const* weights, int n_layers, int width, int d_out,
    const float* g, int64_t g_stride_b, int64_t g_stride_d, void* dx,
    int64_t dx_stride_b, int64_t dx_stride_d, bool dx_bf16, float* partials,
    int n_ctas, float* dw, int64_t batch, bool compute_bf16, int act, int out_act,
    bool soa_in, cudaStream_t stream) {
  const int64_t tile = compute_bf16 ? kRows : kRowsF32;
  const int64_t n_tiles = (batch + tile - 1) / tile;
  // Every CTA must own at least one tile: its partial is written there.
  if (batch <= 0 || n_layers < 2 || n_layers > kMaxLayers || d_in < 1 || d_out < 1 ||
      n_ctas < 1 || n_ctas > n_tiles)
    return cudaErrorInvalidValue;
  BwdArgs a{};
  a.x = x;
  a.x_stride_b = x_stride_b;
  a.x_stride_d = x_stride_d;
  a.d_in = d_in;
  for (int l = 0; l < n_layers; ++l) a.w[l] = weights[l];
  a.n_layers = n_layers;
  a.width = width;
  a.d_out = d_out;
  a.g = g;
  a.g_stride_b = g_stride_b;
  a.g_stride_d = g_stride_d;
  a.dx = dx;
  a.dx_stride_b = dx_stride_b;
  a.dx_stride_d = dx_stride_d;
  a.dx_bf16 = dx_bf16 ? 1 : 0;
  a.partials = partials;
  a.total_dw = int64_t(d_in) * width + int64_t(n_layers - 2) * width * width +
               int64_t(width) * d_out;
  a.batch = batch;
  a.act = act;
  a.out_act = out_act;
  a.soa_in = soa_in ? 1 : 0;

  cudaError_t err;
  if (compute_bf16) {
    err = act <= 1 && out_act <= 1 ? launch_bf16<true>(a, n_ctas, stream)
                                   : launch_bf16<false>(a, n_ctas, stream);
  } else {
    const F32Layout s = f32_layout(d_in, d_out, width, n_layers);
    err = launch_with_smem(fused_mlp_bwd_f32_kernel, n_ctas, kThreadsF32, s.bytes, stream,
                           a, s);
  }
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<unsigned((a.total_dw + 255) / 256), 256, 0, stream>>>(
      partials, n_ctas, a.total_dw, dw);
  return cudaGetLastError();
}

}  // namespace tcnn_tpu_torch

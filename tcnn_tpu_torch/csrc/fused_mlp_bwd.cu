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
// What bounds it on the H100.  At config_btf (B = 2^18, 40 -> 64 x 3 -> 3,
// bf16) the function moves 45 MB (input, output gradient, input gradient:
// 13 us at 3.35 TB/s) and does 3 x 5.7 GFLOP of bf16 products (17 us at
// the 989 TFLOP/s tensor-core peak): bound by the tensor cores, closely
// followed by memory.  At the SDF step (16 -> 64 x 2 -> 1, fp32) it moves
// 35 MB (10 us) against 3 x 2.7 GFLOP of fp32 FMA (122 us at 67 TFLOP/s):
// bound by the FMA units.  Near either bound only if weights,
// activations and the partial dW stay on chip, with few shared-memory
// loads per operation and few __syncthreads per tile.  The design:
//
// Persistent CTAs, as many as the occupancy calculator puts on the card
// and at most one per tile (persistent_ctas, mlp_common.cuh, as for kernel
// M), walk the tiles blockIdx.x, blockIdx.x + gridDim.x, ...  Each stages
// all layers' weights into shared memory once, and keeps its partial dW in
// fp32 shared memory across its tiles (`resident`, every configuration of
// the repo); it writes the partial to device memory once, at its end, and
// sum_partials_kernel sums the partials in CTA order.  Each dW element has
// one owner thread and every sum runs in a fixed order, so dW is the same
// from run to run on a card.  Where weights and dW do not fit (width 128
// at depth), each tile stages each layer as it needs it and adds into the
// partial in device memory.  The input tile of the next block is copied by
// cp.async while the current one computes, where a second buffer fits and
// the layout allows 16-byte copies (bf16 AoS rows, fp32 SoA features).
//
// bf16 compute (BF16_POLICY): 128-row tiles, 8 warps, warp w owning rows
// [16w, 16w+16), mma.sync m16n8k16 with fp32 accumulation as in M.  The
// resident weights are row-major W[k][n]: the forward reads B fragments
// through ldmatrix.trans, the dgrad product dz Wᵀ through plain ldmatrix,
// so nothing is restaged.  For None and ReLU (the kFast instance) the
// forward stores h_k = bf16(act(z_k)) once, row-major, and keeps act'(z_k)
// as one bit per element in shared memory, private to the thread that
// owns the element; the weight gradient h_kᵀ dz then reads h_k through
// ldmatrix.trans.  Other activations keep the fp32 z_k and apply act() as
// they read it.  dz_k is written over h_k's buffer once the layer above
// has read h_k.  The weight gradient contracts over the tile's 128 rows
// with each warp owning whole 16 x 16 blocks of dW.
//
// fp32 compute (DEFAULT_POLICY): plain fp32 FMA (no TF32), 64-row tiles,
// 128 threads, activations feature-major in shared memory, each product
// register-tiled (mlp_common.cuh: f32_product, f32_wgrad): a thread owns a
// 4-row x W/8-column block, one 16-byte activation load and W/8 weight
// loads per k for 4·W/8 FMAs; the weight gradient's 4 x 4 blocks take
// 8 float4 loads per 64 FMAs.  The weights are resident twice, W and Wᵀ,
// so that both the forward and the dgrad read 16-byte rows.  3xTF32 on the
// tensor cores (mlp_common.cuh: kTf32x3, the ablation f32_3xtf32 of
// tools/kernel_ablation.py) was built and measured against it on an H100
// and set aside: at the SDF shape it ran this kernel in 0.66 ms against
// FMA's 0.45, and at 2^18 samples it switched about one ReLU near 0 per
// MLP, moving that sample's dx row and dW beyond the fp32 bounds
// (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "kernels.h"
#include "mlp_common.cuh"

namespace tcnn_tpu_torch {
namespace {

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
// The instance for None and ReLU only (kFast), which keeps act'(z) as bits.
__host__ __device__ inline bool fast_instance(const BwdArgs& a) {
  return a.act <= 1 && a.out_act <= 1;
}
// Offset of layer l's (fan_in, fan_out) block in the flat dW.
__host__ __device__ inline int64_t dw_offset(const BwdArgs& a, int l) {
  return l == 0 ? 0 : int64_t(a.d_in) * a.width + int64_t(l - 1) * a.width * a.width;
}

// Writes element (b, d) of dx in its dtype.
__device__ __forceinline__ void store_dx(const BwdArgs& a, int64_t b, int d, float v) {
  const int64_t i = b * a.dx_stride_b + d * a.dx_stride_d;
  if (a.dx_bf16)
    store(static_cast<__nv_bfloat16*>(a.dx) + i, v);
  else
    store(static_cast<float*>(a.dx) + i, v);
}

// Copies this CTA's partial dW from shared memory to its row of partials.
__device__ __forceinline__ void write_partial(const BwdArgs& a, const float* dws) {
  float* dst = a.partials + blockIdx.x * a.total_dw;
  for (int64_t i = threadIdx.x; i < a.total_dw; i += blockDim.x) dst[i] = dws[i];
}

// ---------------------------------------------------------------------------
// bf16 kernel
// ---------------------------------------------------------------------------

// act'(z) bits of a hidden layer (kFast): W/2 per thread, in words.
__host__ __device__ constexpr int mask_words(int width) { return (width / 2 + 31) / 32; }
// A tile of `rows` rows runs one warp per 16 rows.
__host__ __device__ constexpr int bf16_threads(int rows) { return rows / 16 * 32; }

struct Bf16Layout {
  int rows;                   // of a tile: kRows, or 64 where 128 rows do not fit
  int ldx, ldh, ldz, ldo;     // elements per row: input tile, h_k / dz_k, z_k (fp32), dz_out
  int x0, x1, hz, hz_bytes;   // byte offsets; hz_bytes per hidden layer
  int mask, dzo, w, dw;
  int n_xbuf, resident, bytes;
};

__host__ __device__ inline int bf16_w_rows(const BwdArgs& a, int l) { return pad16(fan_in_of(a, l)); }
__host__ __device__ inline int bf16_w_cols(const BwdArgs& a, int l) {
  return l == a.n_layers - 1 ? pad16(a.d_out) : a.width;
}

inline Bf16Layout bf16_layout(const BwdArgs& a, bool fast, int rows) {
  Bf16Layout s{};
  const int L = a.n_layers, W = a.width;
  s.rows = rows;
  s.ldx = pad16(a.d_in) + kSkew;
  s.ldh = W + kSkew;
  s.ldz = W + 4;  // ≡ 4 (mod 32) words: conflict-free transposed reads
  s.ldo = pad16(a.d_out) + kSkew;
  const int xb = rows * s.ldx * 2;
  s.hz_bytes = fast ? rows * s.ldh * 2 : rows * s.ldz * 4;
  const int maskb = fast ? (L - 1) * mask_words(W) * bf16_threads(rows) * 4 : 0;
  const int dzob = rows * s.ldo * 2;
  int64_t wall = 0, wone = 0;
  for (int l = 0; l < L; ++l) {
    const int64_t b = int64_t(bf16_w_rows(a, l)) * (bf16_w_cols(a, l) + kSkew) * 2;
    wall += b;
    wone = b > wone ? b : wone;
  }
  const int64_t dwb = (a.total_dw * 4 + 15) / 16 * 16;
  const int64_t common = xb + int64_t(L - 1) * s.hz_bytes + maskb + dzob;
  s.resident = common + wall + dwb <= kMaxSmem;
  const int64_t wb = s.resident ? wall + dwb : wone;
  s.n_xbuf = common + xb + wb <= kMaxSmem ? 2 : 1;
  s.x0 = 0;
  s.x1 = s.n_xbuf == 2 ? xb : 0;
  s.hz = s.n_xbuf * xb;
  s.mask = s.hz + (L - 1) * s.hz_bytes;
  s.dzo = s.mask + maskb;
  s.w = s.dzo + dzob;
  s.dw = s.w + int(s.resident ? wall : wone);
  const int64_t bytes = int64_t(s.dw) + (s.resident ? dwb : 0);
  s.bytes = bytes > kMaxSmem ? kMaxSmem + 1 : int(bytes);
  return s;
}

// The weight gradient of one layer over the tile's R rows,
// dW[m][n] += Σ_r h[r][m] · dz[r][n], shared among the R / 16 warps by
// 16 x 16 blocks; part is the layer's block of the CTA's partial dW (shared
// or device memory).  a_frag(k0, m0, af) yields the A fragment of hᵀ at
// rows [k0, k0+16) of the tile and columns [m0, m0+16) of h.
template <int R, typename AFrag>
__device__ __forceinline__ void wgrad_bf16(const BwdArgs& a, int layer, AFrag a_frag,
                                           const __nv_bfloat16* dz, int ldd, float* part,
                                           bool first) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int fan_in = fan_in_of(a, layer), fan_out = fan_out_of(a, layer);
  const int n_mt = pad16(fan_in) / 16, n_np = pad16(fan_out) / 16;
  for (int u = warp; u < n_mt * n_np; u += R / 16) {
    const int mt = u / n_np, np = u % n_np;
    float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kb = 0; kb < R / 16; ++kb) {
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
// Only the instance for other activations than None and ReLU reads z so.
__device__ __forceinline__ void load_act_a_trans(const float* z, int ld, int act, int k0,
                                                 int m0, uint32_t (&af)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* p = z + (k0 + 2 * t) * ld + m0 + g;
  af[0] = pack_bf16(activate(p[0], act), activate(p[ld], act));
  af[1] = pack_bf16(activate(p[8], act), activate(p[ld + 8], act));
  af[2] = pack_bf16(activate(p[8 * ld], act), activate(p[9 * ld], act));
  af[3] = pack_bf16(activate(p[8 * ld + 8], act), activate(p[9 * ld + 8], act));
}

// Stores a warp's A fragments (16 rows x 16·KB columns of bf16) row-major
// at rows r0, r0 + 8 of a shared tile: the layout ldmatrix reads back.
template <int KB>
__device__ __forceinline__ void store_frags(const uint32_t (&f)[KB][4], __nv_bfloat16* m,
                                            int ld, int r0, int t) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    __nv_bfloat16* p = m + r0 * ld + 16 * kb + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = f[kb][0];
    *reinterpret_cast<uint32_t*>(p + 8 * ld) = f[kb][1];
    *reinterpret_cast<uint32_t*>(p + 8) = f[kb][2];
    *reinterpret_cast<uint32_t*>(p + 8 * ld + 8) = f[kb][3];
  }
}

// kFast: every activation is None or ReLU (mlp_common.cuh: act_fn).  Up
// to width 64, at most 128 registers, so that two CTAs fit on an SM where
// their shared memory does (config_hash: left to itself ptxas took 168
// and the kernel ran at one CTA per SM, 0.17 in place of 0.13 ms on an
// H100).  R: rows of a tile, one warp per 16 (kRows; 64 at width 128 where
// the hidden layers of 128 rows exceed kMaxSmem, bwd_tile_rows).
template <int W, bool kFast, int R>
__global__ void __launch_bounds__(R * 2, W <= 64 ? 2 : 1)
fused_mlp_bwd_bf16_kernel(BwdArgs a, Bf16Layout s) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xb[2] = {reinterpret_cast<__nv_bfloat16*>(smem + s.x0),
                          reinterpret_cast<__nv_bfloat16*>(smem + s.x1)};
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + s.mask);
  __nv_bfloat16* dzo = reinterpret_cast<__nv_bfloat16*>(smem + s.dzo);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + s.w);
  float* dws = reinterpret_cast<float*>(smem + s.dw);
  // Hidden layer l's buffer: h_{l+1} (kFast) or z_l (fp32), later dz_l.
  const auto h_buf = [&](int l) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s.hz + l * s.hz_bytes);
  };
  const auto z_buf = [&](int l) { return reinterpret_cast<float*>(smem + s.hz + l * s.hz_bytes); };

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  const int L = a.n_layers, d_in = a.d_in, kin = pad16(a.d_in);
  const int64_t n_tiles = (a.batch + R - 1) / R;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  constexpr int NT = W / 8;    // n-tiles of a hidden layer
  constexpr int KB = W / 16;   // k-steps of a product fed by a hidden layer
  constexpr int MW = mask_words(W);
  float* part = s.resident ? dws : a.partials + blockIdx.x * a.total_dw;

  const auto w_ld = [&](int l) { return bf16_w_cols(a, l) + kSkew; };
  const auto stage_w = [&](int l, __nv_bfloat16* dst) {
    stage_rowmajor<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(a.w[l]), fan_in_of(a, l),
                                  fan_out_of(a, l), bf16_w_rows(a, l), bf16_w_cols(a, l), dst,
                                  w_ld(l));
  };
  const auto w_at = [&](int l) -> const __nv_bfloat16* {
    if (!s.resident) return wsm;
    int off = 0;
    for (int j = 0; j < l; ++j) off += bf16_w_rows(a, j) * w_ld(j);
    return wsm + off;
  };
  // The input tile: 16-byte cp.async copies for full tiles of contiguous
  // AoS rows (they land by the next cp_async_wait_all), else as before.
  const bool async_x = !a.soa_in && a.x_stride_d == 1 && a.x_stride_b == d_in && d_in % 8 == 0 &&
                       (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const auto stage_x = [&](int64_t tile, __nv_bfloat16* dst) {
    const int64_t row0 = tile * R;
    if (async_x && row0 + R <= a.batch) {
      const int chunks = d_in / 8;
      for (int c = tid; c < R * chunks; c += blockDim.x) {
        const int r = c / chunks, q = c % chunks;
        cp_async16(dst + r * s.ldx + 8 * q, x + (row0 + r) * d_in + 8 * q);
      }
      cp_async_commit();
    } else {
      stage_input_tile<R>(x, a.x_stride_b, a.x_stride_d, d_in, a.batch, row0, a.soa_in != 0,
                          dst, s.ldx);
    }
  };

  // Columns [D_in, pad16(D_in)) of the input tiles stay zero.
  if (kin > d_in) {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int i = tid; i < R * (kin - d_in); i += blockDim.x) {
      const int r = i / (kin - d_in), c = d_in + i % (kin - d_in);
      xb[0][r * s.ldx + c] = xb[1][r * s.ldx + c] = zero;
    }
  }
  if (s.resident)
    for (int l = 0; l < L; ++l) stage_w(l, const_cast<__nv_bfloat16*>(w_at(l)));

  walk_tiles(n_tiles, s.n_xbuf, xb, stage_x, [&](int64_t tile, const __nv_bfloat16* xs,
                                                  bool first) {
    const int64_t row0 = tile * R;
    float acc[NT][4];        // a layer's outputs for this warp's 16 rows
    uint32_t afrag[KB][4];   // the same, as A fragments of the next product

    // -- forward, recomputed as in kernel M, keeping each h_k (or z_k) ---
    for (int layer = 0; layer < L; ++layer) {
      const bool last = layer == L - 1;
      const __nv_bfloat16* wl = w_at(layer);
      const int ld = w_ld(layer);
      if (!s.resident) {
        __syncthreads();  // every warp is done with the previous weights
        stage_w(layer, wsm);
        __syncthreads();
      }
      if (!last) {
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        if (layer == 0) {
          const __nv_bfloat16* arow = xs + r0 * s.ldx + 2 * t;
          for (int kb = 0; kb < kin / 16; ++kb) {
            const uint32_t af[4] = {ld32(arow + 16 * kb), ld32(arow + 8 * s.ldx + 16 * kb),
                                    ld32(arow + 16 * kb + 8),
                                    ld32(arow + 8 * s.ldx + 16 * kb + 8)};
#pragma unroll
            for (int p = 0; p < W / 16; ++p) {
              uint32_t b[4];
              load_b_pair(wl, ld, 16 * kb, 16 * p, b);
              mma_bf16(acc[2 * p], af, b[0], b[1]);
              mma_bf16(acc[2 * p + 1], af, b[2], b[3]);
            }
          }
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
          afrag[kb][0] = pack_bf16(act_fn<kFast>(acc[2 * kb][0], a.act),
                                   act_fn<kFast>(acc[2 * kb][1], a.act));
          afrag[kb][1] = pack_bf16(act_fn<kFast>(acc[2 * kb][2], a.act),
                                   act_fn<kFast>(acc[2 * kb][3], a.act));
          afrag[kb][2] = pack_bf16(act_fn<kFast>(acc[2 * kb + 1][0], a.act),
                                   act_fn<kFast>(acc[2 * kb + 1][1], a.act));
          afrag[kb][3] = pack_bf16(act_fn<kFast>(acc[2 * kb + 1][2], a.act),
                                   act_fn<kFast>(acc[2 * kb + 1][3], a.act));
        }
        if constexpr (kFast) {
          store_frags<KB>(afrag, h_buf(layer), s.ldh, r0, t);
          uint32_t bits[MW] = {};
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (act_grad<true>(acc[j][i], a.act) != 0.0f)
                bits[(4 * j + i) / 32] |= 1u << ((4 * j + i) % 32);
#pragma unroll
          for (int w = 0; w < MW; ++w) mask[(layer * MW + w) * (R * 2) + tid] = bits[w];
        } else {
          float* z = z_buf(layer);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            *reinterpret_cast<float2*>(z + r0 * s.ldz + 8 * j + 2 * t) =
                make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(z + (r0 + 8) * s.ldz + 8 * j + 2 * t) =
                make_float2(acc[j][2], acc[j][3]);
          }
        }
      } else {
        // Output layer: dz = g · out_act'(z_out), rounded, into dzo (zero
        // in the padding columns and past the batch).
        for (int p = 0; p < pad16(a.d_out) / 16; ++p) {
          float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            uint32_t b[4];
            load_b_pair(wl, ld, 16 * kb, 16 * p, b);
            mma_bf16(c[0], afrag[kb], b[0], b[1]);
            mma_bf16(c[1], afrag[kb], b[2], b[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float d[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int64_t b = row0 + r0 + 8 * (i / 2);
              const int n = 16 * p + 8 * h + 2 * t + i % 2;
              const float gv = (b < a.batch && n < a.d_out)
                  ? a.g[b * a.g_stride_b + n * a.g_stride_d] : 0.0f;
              d[i] = gv * act_grad<kFast>(c[h][i], a.out_act);
            }
            __nv_bfloat16* q = dzo + r0 * s.ldo + 16 * p + 8 * h + 2 * t;
            *reinterpret_cast<uint32_t*>(q) = pack_bf16(d[0], d[1]);
            *reinterpret_cast<uint32_t*>(q + 8 * s.ldo) = pack_bf16(d[2], d[3]);
          }
        }
      }
    }
    __syncthreads();  // dz_out and every h_k are complete

    // hᵀ fragments of layer l's input (l >= 1): h_buf(l - 1) through
    // ldmatrix.trans, or act(z_{l-1}) element by element.
    const auto h_frag = [&](int l) {
      return [&, l](int k0, int m0, uint32_t(&af)[4]) {
        if constexpr (kFast)
          load_a_trans(h_buf(l - 1), s.ldh, k0, m0, af);
        else
          load_act_a_trans(z_buf(l - 1), s.ldz, a.act, k0, m0, af);
      };
    };

    // -- backward ------------------------------------------------------
    // Output layer: wgrad from h_{L-1}; dgrad with W_out (resident, or
    // still staged from the forward).
    {
      wgrad_bf16<R>(a, L - 1, h_frag(L - 1), dzo, s.ldo, part + dw_offset(a, L - 1), first);
      const __nv_bfloat16* wl = w_at(L - 1);
      const int ld = w_ld(L - 1);
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      const __nv_bfloat16* arow = dzo + r0 * s.ldo + 2 * t;
      for (int kb = 0; kb < pad16(a.d_out) / 16; ++kb) {
        const uint32_t af[4] = {ld32(arow + 16 * kb), ld32(arow + 8 * s.ldo + 16 * kb),
                                ld32(arow + 16 * kb + 8), ld32(arow + 8 * s.ldo + 16 * kb + 8)};
#pragma unroll
        for (int p = 0; p < W / 16; ++p) {
          uint32_t b[4];
          load_bt_pair(wl, ld, 16 * kb, 16 * p, b);
          mma_bf16(acc[2 * p], af, b[0], b[1]);
          mma_bf16(acc[2 * p + 1], af, b[2], b[3]);
        }
      }
    }

    for (int layer = L - 2; layer >= 0; --layer) {
      // dz_k = dh · act'(z_k), rounded; its A fragments stay in registers.
      if constexpr (kFast) {
        uint32_t bits[MW];
#pragma unroll
        for (int w = 0; w < MW; ++w) bits[w] = mask[(layer * MW + w) * (R * 2) + tid];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[j][i] *= (bits[(4 * j + i) / 32] >> ((4 * j + i) % 32)) & 1u ? 1.0f : 0.0f;
      } else {
        const float* z = z_buf(layer);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 za = *reinterpret_cast<const float2*>(z + r0 * s.ldz + 8 * j + 2 * t);
          const float2 zb = *reinterpret_cast<const float2*>(z + (r0 + 8) * s.ldz + 8 * j + 2 * t);
          acc[j][0] *= act_grad<false>(za.x, a.act);
          acc[j][1] *= act_grad<false>(za.y, a.act);
          acc[j][2] *= act_grad<false>(zb.x, a.act);
          acc[j][3] *= act_grad<false>(zb.y, a.act);
        }
      }
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        afrag[kb][0] = pack_bf16(acc[2 * kb][0], acc[2 * kb][1]);
        afrag[kb][1] = pack_bf16(acc[2 * kb][2], acc[2 * kb][3]);
        afrag[kb][2] = pack_bf16(acc[2 * kb + 1][0], acc[2 * kb + 1][1]);
        afrag[kb][3] = pack_bf16(acc[2 * kb + 1][2], acc[2 * kb + 1][3]);
      }
      __syncthreads();  // every warp is done with h_{k+1} (and the staged weights)
      __nv_bfloat16* dz = h_buf(layer);
      store_frags<KB>(afrag, dz, s.ldh, r0, t);
      if (!s.resident) stage_w(layer, wsm);
      __syncthreads();
      const __nv_bfloat16* wl = w_at(layer);
      const int ld = w_ld(layer);

      if (layer == 0) {
        const auto x_frag = [&](int k0, int m0, uint32_t(&af)[4]) {
          load_a_trans(xs, s.ldx, k0, m0, af);
        };
        wgrad_bf16<R>(a, 0, x_frag, dz, s.ldh, part, first);
        // dx = dz_1 · W_inᵀ in fp32, only the real rows and columns stored.
        for (int p = 0; p < kin / 16; ++p) {
          float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            uint32_t b[4];
            load_bt_pair(wl, ld, 16 * kb, 16 * p, b);
            mma_bf16(c[0], afrag[kb], b[0], b[1]);
            mma_bf16(c[1], afrag[kb], b[2], b[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int64_t b = row0 + r0 + 8 * (i / 2);
              const int n = 16 * p + 8 * h + 2 * t + i % 2;
              if (b < a.batch && n < d_in) store_dx(a, b, n, c[h][i]);
            }
        }
      } else {
        wgrad_bf16<R>(a, layer, h_frag(layer), dz, s.ldh, part + dw_offset(a, layer), first);
        // dh = dz_k · W_kᵀ
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
#pragma unroll
          for (int p = 0; p < W / 16; ++p) {
            uint32_t b[4];
            load_bt_pair(wl, ld, 16 * kb, 16 * p, b);
            mma_bf16(acc[2 * p], afrag[kb], b[0], b[1]);
            mma_bf16(acc[2 * p + 1], afrag[kb], b[2], b[3]);
          }
      }
    }
  });
  if (s.resident) {
    __syncthreads();
    write_partial(a, dws);
  }
}

// ---------------------------------------------------------------------------
// fp32 kernel
// ---------------------------------------------------------------------------

// Float offsets of the fp32 kernel's shared memory for tiles of `rows`
// rows (kRowsF32, or 32 where 64 rows do not fit): input tiles of
// pad8(D_in) features (two where they fit), z_k or h_k of each hidden
// layer and then dz_k in its place (feature-major, W x f32_ld(rows)),
// dz_out (padc(D_out) x f32_ld(rows)), weights W_l (fan_in x ld) and W_lᵀ
// (fan_out x padc(fan_in)) of every layer, and dW, or one layer's staging
// buffer where those do not fit.
struct F32BwdLayout {
  int rows;
  int x0, x1, z, dzo, w, dw;
  int n_xbuf, resident, bytes;
};

__host__ __device__ inline int f32_w_ld(const BwdArgs& a, int l, int rows) {
  return f32_ldw(fan_out_of(a, l), rows);
}
__host__ __device__ inline int f32_wt_ld(const BwdArgs& a, int l, int rows) {
  return f32_ldw(fan_in_of(a, l), rows);
}
__host__ __device__ inline int f32_w_floats(const BwdArgs& a, int l, int rows) {
  return fan_in_of(a, l) * f32_w_ld(a, l, rows);
}
__host__ __device__ inline int f32_wt_floats(const BwdArgs& a, int l, int rows) {
  return fan_out_of(a, l) * f32_wt_ld(a, l, rows);
}

inline F32BwdLayout f32_layout(const BwdArgs& a, int rows) {
  F32BwdLayout s{};
  const int L = a.n_layers, ld = f32_ld(rows);
  s.rows = rows;
  const int64_t xf = ((a.d_in + 7) / 8 * 8) * ld, zf = int64_t(a.width) * ld;
  const int64_t dzof = padc(a.d_out, rows) * ld;
  int64_t wall = 0, wone = 0;
  for (int l = 0; l < L; ++l) {
    const int64_t w = f32_w_floats(a, l, rows), wt = f32_wt_floats(a, l, rows);
    wall += w + wt;
    wone = w > wone ? w : wone;
    wone = wt > wone ? wt : wone;
  }
  const int64_t dwf = pad4(int(a.total_dw));
  const int64_t common = xf + (L - 1) * zf + dzof;
  s.resident = (common + wall + dwf) * 4 <= kMaxSmem;
  const int64_t wf = s.resident ? wall + dwf : wone;
  s.n_xbuf = (common + xf + wf) * 4 <= kMaxSmem ? 2 : 1;
  s.x0 = 0;
  s.x1 = s.n_xbuf == 2 ? int(xf) : 0;
  s.z = s.n_xbuf * int(xf);
  s.dzo = s.z + (L - 1) * int(zf);
  s.w = s.dzo + int(dzof);
  s.dw = s.w + int(s.resident ? wall : wone);
  const int64_t bytes = (int64_t(s.dw) + (s.resident ? dwf : 0)) * 4;
  s.bytes = bytes > kMaxSmem ? kMaxSmem + 1 : int(bytes);
  return s;
}

// kFast (None, ReLU): the forward stores h_k = act(z_k); act'(z_k) is
// read back from h_k (ReLU: h > 0 exactly where z > 0).  Otherwise it
// stores z_k and applies act() as it reads.  R: rows of a tile (kRowsF32;
// 32 at width 128 where the hidden layers of 64 rows exceed kMaxSmem,
// bwd_tile_rows).
template <int W, bool kFast, int R>
__global__ void __launch_bounds__(kThreadsF32, 2)
fused_mlp_bwd_f32_kernel(BwdArgs a, F32BwdLayout s) {
  constexpr int LD = f32_ld(R), CG = f32_col_groups(R);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* xb[2] = {sm + s.x0, sm + s.x1};
  float* dzo = sm + s.dzo;
  float* wsm = sm + s.w;
  float* dws = sm + s.dw;
  const auto zt = [&](int l) { return sm + s.z + l * W * LD; };

  const int L = a.n_layers, d_in = a.d_in, rg = f32_rg<R>();
  const int64_t n_tiles = (a.batch + R - 1) / R;
  const float* x = static_cast<const float*>(a.x);
  float* part = s.resident ? dws : a.partials + blockIdx.x * a.total_dw;

  const auto stage_w = [&](int l, float* dst) {
    stage_rowmajor<float>(static_cast<const float*>(a.w[l]), fan_in_of(a, l), fan_out_of(a, l),
                          fan_in_of(a, l), padc(fan_out_of(a, l), R), dst, f32_w_ld(a, l, R));
  };
  const auto stage_wt = [&](int l, float* dst) {   // dst[n * ld + m] = W[m][n]
    const int fi = fan_in_of(a, l), fo = fan_out_of(a, l), ld = f32_wt_ld(a, l, R);
    const float* w = static_cast<const float*>(a.w[l]);
    staged_copy<float>(
        fo * ld, [&](int i) { const int n = i / ld, m = i % ld; return m < fi ? w[m * fo + n] : 0.0f; },
        [&](int i, float v) { dst[i] = v; });
  };
  const auto w_at = [&](int l, bool transposed) -> float* {
    if (!s.resident) return wsm;
    int off = 0;
    for (int j = 0; j < l; ++j) off += f32_w_floats(a, j, R) + f32_wt_floats(a, j, R);
    return wsm + off + (transposed ? f32_w_floats(a, l, R) : 0);
  };

  // Features [D_in, pad8(D_in)) of the input tiles stay zero (f32_wgrad reads them).
  for (int i = threadIdx.x; i < ((d_in + 7) / 8 * 8 - d_in) * LD; i += blockDim.x)
    xb[0][d_in * LD + i] = xb[1][d_in * LD + i] = 0.0f;
  if (s.resident)
    for (int l = 0; l < L; ++l) {
      stage_w(l, w_at(l, false));
      stage_wt(l, w_at(l, true));
    }

  const auto stage_x = [&](int64_t tile, float* dst) {
    stage_f32_tile<R>(x, a.x_stride_b, a.x_stride_d, d_in, a.batch, tile * R, dst);
  };
  walk_tiles(n_tiles, s.n_xbuf, xb, stage_x, [&](int64_t tile, const float* xt, bool first) {
    const int64_t row0 = tile * R;

    // -- forward: h_k (or z_k) of every hidden layer, dz of the output ---
    for (int l = 0; l < L; ++l) {
      const float* wl = w_at(l, false);
      if (!s.resident) {
        __syncthreads();  // the previous layer's weights are read, its outputs written
        stage_w(l, wsm);
        __syncthreads();
      }
      const float* in = l == 0 ? xt : zt(l - 1);
      const int k_real = fan_in_of(a, l), ld = f32_w_ld(a, l, R);
      if (l < L - 1) {
        float acc[4][W / CG];
        if (l > 0)   // h_l, or act() of the stored z_{l-1}
          f32_product<W / CG, !kFast, kFast, R>(in, a.act, wl, ld, k_real, 0, acc);
        else
          f32_product<W / CG, false, kFast, R>(in, a.act, wl, ld, k_real, 0, acc);
        float* out = zt(l);
#pragma unroll
        for (int j = 0; j < W / CG; ++j) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = kFast ? act_fn<true>(acc[i][j], a.act) : acc[i][j];
          *reinterpret_cast<float4*>(out + ((W / CG) * f32_cg<R>() + j) * LD + 4 * rg) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
        const auto epi = [&](int c, auto& acc) {
          constexpr int TC = sizeof(acc[0]) / sizeof(float);
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int n = c + j;
            float d[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int64_t b = row0 + 4 * rg + i;
              const float gv = (b < a.batch && n < a.d_out)
                  ? a.g[b * a.g_stride_b + n * a.g_stride_d] : 0.0f;
              d[i] = gv * act_grad<kFast>(acc[i][j], a.out_act);
            }
            *reinterpret_cast<float4*>(dzo + n * LD + 4 * rg) = make_float4(d[0], d[1], d[2], d[3]);
          }
        };
        f32_product_cols<!kFast, kFast, R>(in, a.act, wl, ld, k_real, padc(a.d_out, R), epi);   // l >= 1
      }
      if (s.resident) __syncthreads();  // the next layer reads these outputs
    }
    if (!s.resident) __syncthreads();

    // -- backward: wgrad and dgrad of each layer, output layer first -----
    for (int l = L - 1; l >= 0; --l) {
      const int fan_in = fan_in_of(a, l), fan_out = fan_out_of(a, l);
      const float* dz = l == L - 1 ? dzo : zt(l);   // dz_l, feature-major
      const float* wt = w_at(l, true);
      if (!s.resident) {
        stage_wt(l, wsm);   // the last reader of the buffer finished before the last sync
        __syncthreads();
      }
      float* pw = part + dw_offset(a, l);
      if (l == 0) {
        f32_wgrad<R, false, kFast>(xt, a.act, dz, fan_in, fan_out, pw, first);
        f32_product_cols<false, kFast, R>(dz, a.act, wt, f32_wt_ld(a, 0, R), fan_out,
                                          padc(d_in, R),
                                       [&](int c, auto& acc) {
          constexpr int TC = sizeof(acc[0]) / sizeof(float);
#pragma unroll
          for (int j = 0; j < TC; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int64_t b = row0 + 4 * rg + i;
              if (b < a.batch && c + j < d_in) store_dx(a, b, c + j, acc[i][j]);
            }
        });
        if (!s.resident) __syncthreads();  // the staging buffer is free again
      } else {
        f32_wgrad<R, !kFast, kFast>(zt(l - 1), a.act, dz, fan_in, fan_out, pw, first);
        float acc[4][W / CG];
        f32_product<W / CG, false, kFast, R>(dz, a.act, wt, f32_wt_ld(a, l, R), fan_out, 0,
                                                  acc);
        __syncthreads();  // every thread is done reading h_l (z_{l-1}) and the weights
        // dz_{l-1} = dh · act'(z_{l-1}), in place of h_l (z_{l-1})
        float* zp = zt(l - 1);
#pragma unroll
        for (int j = 0; j < W / CG; ++j) {
          float4* p = reinterpret_cast<float4*>(zp + ((W / CG) * f32_cg<R>() + j) * LD + 4 * rg);
          const float4 z = *p;
          *p = make_float4(acc[0][j] * act_grad<kFast>(z.x, a.act),
                           acc[1][j] * act_grad<kFast>(z.y, a.act),
                           acc[2][j] * act_grad<kFast>(z.z, a.act),
                           acc[3][j] * act_grad<kFast>(z.w, a.act));
        }
        __syncthreads();
      }
    }
  });
  if (s.resident) {
    __syncthreads();
    write_partial(a, dws);
  }
}

// The arguments of one shape, as far as the layouts need them.
BwdArgs shape_args(int d_in, int d_out, int width, int n_layers, int act, int out_act) {
  BwdArgs a{};
  a.d_in = d_in;
  a.d_out = d_out;
  a.width = width;
  a.n_layers = n_layers;
  a.act = act;
  a.out_act = out_act;
  a.total_dw = int64_t(d_in) * width + int64_t(n_layers - 2) * width * width +
               int64_t(width) * d_out;
  return a;
}

// Shared memory of one CTA at tiles of `rows` rows.
int smem_bytes(const BwdArgs& a, bool compute_bf16, int rows) {
  return compute_bf16 ? bf16_layout(a, fast_instance(a), rows).bytes : f32_layout(a, rows).bytes;
}

// Rows of a tile: kRows (bf16) or kRowsF32 (fp32), or half as many at
// width 128 where the full tile's hidden layers exceed kMaxSmem.  Every
// layer's h_k (or z_k) of a tile stays in shared memory, so the tile's
// rows bound the depth: the 128 -> 128 x 5 -> 3 MLP of
// configs/config_oneblob.json needs 260,096 bytes in bf16 and 276,608 in
// fp32 at the full tile, 164,864 and 196,864 at half of it.  Only width
// 128 has half-tile instances.
int bwd_tile_rows(const BwdArgs& a, bool compute_bf16) {
  const int full = compute_bf16 ? kRows : kRowsF32;
  return a.width == 128 && smem_bytes(a, compute_bf16, full) > kMaxSmem ? full / 2 : full;
}

// fn(kernel) with the instance that runs these arguments at tiles of `rows` rows.
template <typename Fn>
cudaError_t with_kernel(const BwdArgs& a, bool compute_bf16, int rows, Fn fn) {
  const bool fast = fast_instance(a);
#define TCNN_MB_CASE(K, W, R) \
  case W: return fast ? fn(K<W, true, R>) : fn(K<W, false, R>);
  if (rows != (compute_bf16 ? kRows : kRowsF32)) {
    if (a.width != 128) return cudaErrorInvalidValue;
    return compute_bf16 ? (fast ? fn(fused_mlp_bwd_bf16_kernel<128, true, kRows / 2>)
                                : fn(fused_mlp_bwd_bf16_kernel<128, false, kRows / 2>))
                        : (fast ? fn(fused_mlp_bwd_f32_kernel<128, true, kRowsF32 / 2>)
                                : fn(fused_mlp_bwd_f32_kernel<128, false, kRowsF32 / 2>));
  }
  if (compute_bf16) {
    switch (a.width) {
      TCNN_MB_CASE(fused_mlp_bwd_bf16_kernel, 16, kRows)
      TCNN_MB_CASE(fused_mlp_bwd_bf16_kernel, 32, kRows)
      TCNN_MB_CASE(fused_mlp_bwd_bf16_kernel, 64, kRows)
      TCNN_MB_CASE(fused_mlp_bwd_bf16_kernel, 128, kRows)
      default: return cudaErrorInvalidValue;
    }
  }
  switch (a.width) {
    TCNN_MB_CASE(fused_mlp_bwd_f32_kernel, 16, kRowsF32)
    TCNN_MB_CASE(fused_mlp_bwd_f32_kernel, 32, kRowsF32)
    TCNN_MB_CASE(fused_mlp_bwd_f32_kernel, 64, kRowsF32)
    TCNN_MB_CASE(fused_mlp_bwd_f32_kernel, 128, kRowsF32)
    default: return cudaErrorInvalidValue;
  }
#undef TCNN_MB_CASE
}

}  // namespace

int fused_mlp_bwd_smem_bytes(int d_in, int d_out, int width, int n_layers, bool compute_bf16,
                             int act, int out_act) {
  const BwdArgs a = shape_args(d_in, d_out, width, n_layers, act, out_act);
  return smem_bytes(a, compute_bf16, bwd_tile_rows(a, compute_bf16));
}

cudaError_t fused_mlp_bwd_launch(
    const void* x, int64_t x_stride_b, int64_t x_stride_d, int d_in,
    const void* const* weights, int n_layers, int width, int d_out,
    const float* g, int64_t g_stride_b, int64_t g_stride_d, void* dx,
    int64_t dx_stride_b, int64_t dx_stride_d, bool dx_bf16,
    const std::function<float*(int64_t)>& scratch, float* dw, int64_t batch,
    bool compute_bf16, int act, int out_act, bool soa_in, cudaStream_t stream) {
  if (batch <= 0 || n_layers < 2 || n_layers > kMaxLayers || d_in < 1 || d_out < 1)
    return cudaErrorInvalidValue;
  BwdArgs a = shape_args(d_in, d_out, width, n_layers, act, out_act);
  const int rows = bwd_tile_rows(a, compute_bf16);
  const int64_t n_tiles = (batch + rows - 1) / rows;
  a.x = x;
  a.x_stride_b = x_stride_b;
  a.x_stride_d = x_stride_d;
  for (int l = 0; l < n_layers; ++l) a.w[l] = weights[l];
  a.g = g;
  a.g_stride_b = g_stride_b;
  a.g_stride_d = g_stride_d;
  a.dx = dx;
  a.dx_stride_b = dx_stride_b;
  a.dx_stride_d = dx_stride_d;
  a.dx_bf16 = dx_bf16 ? 1 : 0;
  a.batch = batch;
  a.soa_in = soa_in ? 1 : 0;

  const int threads = compute_bf16 ? bf16_threads(rows) : kThreadsF32;
  const Bf16Layout sb = compute_bf16 ? bf16_layout(a, fast_instance(a), rows) : Bf16Layout{};
  const F32BwdLayout sf = compute_bf16 ? F32BwdLayout{} : f32_layout(a, rows);
  const int smem = compute_bf16 ? sb.bytes : sf.bytes;
  int n_ctas = 0;
  const cudaError_t err = with_kernel(a, compute_bf16, rows, [&](auto kernel) {
    const cudaError_t e = persistent_ctas(kernel, threads, smem, n_tiles, &n_ctas);
    if (e != cudaSuccess) return e;
    a.partials = scratch(n_ctas * a.total_dw);
    if constexpr (std::is_same_v<decltype(kernel), void (*)(BwdArgs, Bf16Layout)>)
      kernel<<<n_ctas, threads, smem, stream>>>(a, sb);
    else
      kernel<<<n_ctas, threads, smem, stream>>>(a, sf);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<unsigned((a.total_dw + 255) / 256), 256, 0, stream>>>(
      a.partials, n_ctas, a.total_dw, dw);
  return cudaGetLastError();
}

}  // namespace tcnn_tpu_torch

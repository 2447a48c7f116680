// Kernels M and MB for one layer streamed through shared memory (MW, MBW):
// the instances that take a layer whose weights, with a batch tile of its
// input, do not fit in one CTA's shared memory, at any fan-in and fan-out.
//
// Replaces, for those shapes, one layer of the TPU's
// fused_mlp.py::_fwd_kernel (:100) and ::_bwd_kernel (:113), which hold
// every layer in VMEM.  Kernels M and MB (fused_mlp.cu, fused_mlp_bwd.cu)
// keep all of a tile's layers in one CTA's shared memory: layer 0's
// pad(D_in) x W weights and an input tile of D_in features, and the last
// layer's W x D_out.  Past about 207 inputs at width 128 in fp32 (M) or 464
// in bf16 (MB, three layers), or 192 to 480 outputs, that no longer fits.
// The wrappers (ops/cuda/fused_mlp.py: plan_runs) then run such a layer
// alone through these kernels and the other layers through M and MB, in
// runs: a run's output, the hidden activation in the compute dtype, is what
// one launch of M holds between those layers, so the chain keeps the fused
// chain's rounding points.
//
// One product engine, wide_product_kernel, computes a 128 x BN tile of
// C = A B (BN = 64 or 128 columns, 8 warps of 32 rows x BN/2 columns) for
// every pass.  A and B stream through shared memory in stages of 64 (bf16)
// or 32 (fp32) reduction elements, by 16-byte cp.async into a ring of 3
// stages (zeros past the operands' ends, element by element where a row is
// ragged or unaligned), each operand in the layout it has in device memory
// (k-major or not; ldmatrix or ldmatrix.trans makes the fragments).  The
// epilogue stages the fp32 tile in shared memory and writes 16-byte runs
// of the output (and reads g so in MBW's first pass).
//  * bf16: mma.sync m16n8k16 with fp32 accumulation.  A product of two
//    bf16 values is exact in fp32, so the sums are fp32 sums of the plain
//    version's terms.
//  * fp32: two products measured on the same tiles at 256 -> 128 on an
//    H100 (PERF.md; tools/kernel_ablation.py "wide_z_3xtf32",
//    "wide_grads_fma"): 3xTF32 on the tensor cores (mma.sync m16n8k8, each
//    operand split into TF32 big and small parts, big·big + big·small +
//    small·big; mlp_common.cuh: mma_3xtf32), 1.4-1.5x the faster, and a
//    register-blocked FMA product (4 rows x BN/8 columns a thread, each sum
//    in k order).  dx and dW take 3xTF32 (kFmaGrads).  The forward's z, whose
//    act' decides a ReLU, takes FMA (kFmaZ): the tensor cores' accumulation
//    truncates, and 3xTF32's z moved by up to 7.6e-6 at 256 -> 128 (the fp32
//    bound is 1e-5) and switched a ReLU at 128 -> 600, where the FMA sums
//    gave the plain version's bits.
// The passes:
//  * MW, the forward: y = act(x W), a grid of (row tile, column block),
//    any number of columns in blocks of BN.
//  * MBW, the backward, MB's step at a layer, in three products and a sum:
//    1. dz = g · act'(x W), rounded to the compute dtype, written once to
//       device memory (B x pad8(N), zeros past N): the forward's engine
//       and tiles, so z has MW's bits;
//    2. dx = dz Wᵀ, a grid of (row tile, block of K), the sum over N in
//       stages in order, written in dx's dtype and layout;
//    3. dW = xᵀ dz as the CUDA original forms it (fully_fused_mlp.cu:782-829,
//       a batch-wide split-k product): each CTA owns one (128 features x BN
//       columns) accumulator in registers over a fixed range of batch rows
//       and writes it as its partial; sum_partials_kernel adds the ranges'
//       partials in range order.
//    No atomics: dW and dx keep their bits from launch to launch on a card
//    (the number of batch ranges follows the card's SMs and occupancy).
// The sums over K (or N, or the batch) run in stages, in another order than
// the plain version's: two fp32 sums of the same n terms differ by at most
// 2(n - 1)·2^-24·Σ|x·w| (tests/test_torch_mlp.py replays MBW's sums).
//
// What bounds it on the H100.  At the wide image's first layer (512 ->
// 128, bf16, B = 2^18) the forward moves 0.34 GB (0.10 ms at 3.35 TB/s)
// for 34.4 GFLOP (0.035 ms on the bf16 tensor cores): bytes bound it, and
// the ring keeps 2 x 16 KB of x in flight per CTA, two CTAs an SM.  The
// backward reads x twice (passes 1 and 3), g once, writes and reads dz
// (64 MiB) and writes dx: about 1.1 GB against the 0.94 GB its plain
// version's tensors hold.  At the wide SDF's (256 -> 128, fp32) the
// forward's 17.2 GFLOP on the FMA units take 0.26 ms at least (operations
// bound it); dx's and dW's, three TF32 products each in 3xTF32, 0.21 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"
#include "mlp_common.cuh"

namespace tcnn_tpu_torch {
namespace {

constexpr int kBM = 128;                 // rows of an output tile
constexpr int kThreads = 256;            // 8 warps: 4 along the rows x 2 along the columns
// fp32 products: register-blocked FMA (true) or 3xTF32 on the tensor cores
// (false); for the forward's z, which act' reads, and for dx and dW.
constexpr bool kFmaZ = true;             // 3xTF32's sums switch ReLUs (PERF.md)
constexpr bool kFmaGrads = false;        // FMA measured slower (PERF.md)

// Reduction elements per stage, 64 in bf16 and 32 in fp32, and stages in
// the ring (measured against 32 x 4, 32 x 6 and, in fp32, 64 x 2; PERF.md).
template <typename T>
__host__ __device__ constexpr int stage_k() { return sizeof(T) == 2 ? 64 : 32; }
constexpr int kStages = 3;

// One operand of C = A B as the kernel reads it: element (i, k) of A (i a
// row of C) or (k, j) of B (j a column of C) at p[outer * ld + inner], with
// (outer, inner) = (k, i) or (k, j) for a k-major operand, else (i, k) or
// (j, k); zeros for i or j at or past `mn` and k at or past `k_end`.
struct Operand {
  const void* p;
  int64_t ld;
  int64_t mn;
  int64_t k_end;
};

// Where a tile of C goes: element (m, n) at out[split * split_stride + m *
// s_m + n * s_n] for m < m_end, n < n_end, in fp32 or bf16, as act(c); or,
// with `dz`, as g(m, n) · act'(c) rounded to the compute dtype (g fp32 at
// g[m * g_m + n * g_n], 0 at n >= n_true).
struct Epilogue {
  void* out;
  int64_t split_stride, s_m, s_n, m_end, n_end;
  int out_bf16, act, dz;
  const float* g;
  int64_t g_m, g_n, n_true;
};

// A tile of one operand in shared memory, MN rows of C (A) or columns (B)
// by kBK = stage_k<T>() reduction elements, stored as in device memory:
// [kBK][MN] when k-major, else [MN][kBK], each row padded so that the
// fragment loads of a warp fall in distinct banks (bf16: a row of ldmatrix's 16-byte reads at
// ≡ 16 mod 128 bytes; fp32: 32-bit reads of the lanes' (g, t) at 8t + g or
// 4g + t mod 32 words), 16-byte aligned for cp.async.
template <typename T, bool kKMajor, int MN>
struct Tile {
  static constexpr int kBK = stage_k<T>();
  static constexpr int kOuter = kKMajor ? kBK : MN;
  static constexpr int kInner = kKMajor ? MN : kBK;
  static constexpr int kLd = kInner + (kKMajor || sizeof(T) == 2 ? 8 : 4);
  static constexpr int kElems = kOuter * kLd;

  // element (mn, k) of an fp32 tile (bf16 fragments come by ldmatrix)
  static __device__ __forceinline__ float at(const T* t, int mn, int k) {
    return t[kKMajor ? k * kLd + mn : mn * kLd + k];
  }
};

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Whether an operand's rows take 16-byte copies: an aligned base and a row
// stride of whole 16-byte vectors (tiles start at multiples of 8 elements).
template <typename T>
__device__ __forceinline__ bool rows_aligned(const Operand& op) {
  constexpr int kVec = 16 / int(sizeof(T));
  return (reinterpret_cast<uintptr_t>(op.p) & 15) == 0 && op.ld % kVec == 0;
}

// Issues the copies of the tile at (mn0, k0) of an operand into dst: a
// 16-byte cp.async per vector inside the operand (completed at a later
// cp_async_wait), zeros past its ends, element by element where a vector
// crosses an end or the rows are not aligned.
template <typename T, bool kKMajor, int MN>
__device__ __forceinline__ void load_tile(const Operand& op, int64_t mn0, int64_t k0, T* dst,
                                          bool aligned) {
  using S = Tile<T, kKMajor, MN>;
  constexpr int kVec = 16 / int(sizeof(T));
  constexpr int kPerRow = S::kInner / kVec;
  const T* src = static_cast<const T*>(op.p);
  const int64_t o0 = kKMajor ? k0 : mn0, i0 = kKMajor ? mn0 : k0;
  const int64_t o_end = kKMajor ? op.k_end : op.mn, i_end = kKMajor ? op.mn : op.k_end;
  for (int c = threadIdx.x; c < S::kOuter * kPerRow; c += kThreads) {
    const int o = c / kPerRow, v = c % kPerRow;
    T* d = dst + o * S::kLd + v * kVec;
    const int64_t go = o0 + o, gi = i0 + v * kVec;
    if (aligned && go < o_end && gi + kVec <= i_end) {
      cp_async16(d, src + go * op.ld + gi);
    } else {
      alignas(16) T tmp[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        tmp[e] = go < o_end && gi + e < i_end ? src[go * op.ld + gi + e] : zero_val<T>();
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

// The bf16 A fragment of the m-tile at rows m0, reduction k0 of a tile
// (mma_bf16's layout): ldmatrix.trans from a k-major tile, ldmatrix from
// an m-major one (blocks (m0, k0), (m0 + 8, k0), (m0, k0 + 8), (m0 + 8, k0 + 8)).
template <bool kKMajor, int LD>
__device__ __forceinline__ void frag_a(const __nv_bfloat16* t, int m0, int k0, uint32_t (&a)[4]) {
  if constexpr (kKMajor) {
    load_a_trans(t, LD, k0, m0, a);
  } else {
    const int lane = threadIdx.x % 32, i = lane / 8;
    ldsm_x4(t + (m0 + lane % 8 + 8 * (i % 2)) * LD + k0 + 8 * (i / 2), a);
  }
}

// The bf16 B fragments of n-tiles n0/8 and n0/8 + 1 at reduction k0.
template <bool kKMajor, int LD>
__device__ __forceinline__ void frag_b(const __nv_bfloat16* t, int k0, int n0, uint32_t (&b)[4]) {
  if constexpr (kKMajor) load_b_pair(t, LD, k0, n0, b);
  else load_bt_pair(t, LD, k0, n0, b);
}

// c += one stage's product: warp (wm, wn) owns rows 32wm + 16u + {g, g+8}
// and columns 8·NT·wn + 8j + {2t, 2t+1} of the 128 x 16·NT tile (u < 2,
// j < NT, lane = 4g + t; c[u][j] in the mma C layout).
template <typename T, bool kAKMajor, bool kBKMajor, bool kFma, int NT>
__device__ __forceinline__ void stage_product(const T* as, const T* bs, float (&c)[2][NT][4]) {
  using SA = Tile<T, kAKMajor, kBM>;
  using SB = Tile<T, kBKMajor, 16 * NT>;
  constexpr int kBK = stage_k<T>();
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int m0 = 32 * (warp % 4), n0 = 8 * NT * (warp / 4);
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) frag_a<kAKMajor, SA::kLd>(as, m0 + 16 * u, kk, a[u]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        frag_b<kBKMajor, SB::kLd>(bs, kk, n0 + 8 * j, b);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma_bf16(c[u][j], a[u], b[0], b[1]);
          mma_bf16(c[u][j + 1], a[u], b[2], b[3]);
        }
      }
    }
  } else if constexpr (kFma) {
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[2][2], b[NT][2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) a[u][h] = SA::at(as, m0 + 16 * u + g + 8 * h, k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (kBKMajor) {   // the pair is adjacent: one 8-byte load
          const float2 v = *reinterpret_cast<const float2*>(bs + k * SB::kLd + n0 + 8 * j + 2 * t);
          b[j][0] = v.x;
          b[j][1] = v.y;
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) b[j][e] = SB::at(bs, n0 + 8 * j + 2 * t + e, k);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[u][j][i] = fmaf(a[u][i / 2], b[j][i % 2], c[u][j][i]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = m0 + 16 * u + g;
        split_frag<4>({SA::at(as, m, kk + t), SA::at(as, m + 8, kk + t),
                       SA::at(as, m, kk + t + 4), SA::at(as, m + 8, kk + t + 4)},
                      a_big[u], a_small[u]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + g;
        uint32_t b_big[2], b_small[2];
        split_frag<2>({SB::at(bs, n, kk + t), SB::at(bs, n, kk + t + 4)}, b_big, b_small);
#pragma unroll
        for (int u = 0; u < 2; ++u) mma_3xtf32(c[u][j], a_big[u], a_small[u], b_big, b_small);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_as(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// Shared memory to stage a tile of C in fp32: 128 x BN, along n (row
// major, rows of BN + 8 floats) or along m (rows of 128 + 4), so that the
// fragments' stores fall in distinct banks and rows stay 16-byte aligned.
constexpr int kLdCol = kBM + 4;
template <int NT>
__host__ __device__ constexpr int staged_bytes() {
  return (kBM * (16 * NT + 8) > 16 * NT * kLdCol ? kBM * (16 * NT + 8) : 16 * NT * kLdCol) * 4;
}

// The epilogue: the fragments go to shared memory in fp32, laid out as the
// output is (along n where s_n == 1, else along m); then each thread takes
// runs of 8 (bf16) or 4 (fp32) consecutive outputs, applies act(c), or g ·
// act'(c) rounded to the compute dtype (ep.dz; g read as float4 where it
// runs along the same dimension), and writes them as one 16-byte vector,
// element by element where a run crosses the output's end or is not
// aligned.
template <typename O, typename T, int NT>
__device__ __forceinline__ void store_tile(const Epilogue& ep, const float (&c)[2][NT][4],
                                           int64_t m0, int64_t n0, int64_t split,
                                           unsigned char* smem) {
  constexpr int BN = 16 * NT, kVec = 16 / int(sizeof(O)), kLdRow = BN + 8;
  float* st = reinterpret_cast<float*>(smem);
  O* out = static_cast<O*>(ep.out) + split * ep.split_stride;
  const bool by_row = ep.s_n == 1;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int mw = 32 * (warp % 4) + g, nw = 8 * NT * (warp / 4) + 2 * t;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int mi = mw + 16 * u + 8 * h, ni = nw + 8 * j;
        const float v0 = c[u][j][2 * h], v1 = c[u][j][2 * h + 1];
        if (by_row) {
          *reinterpret_cast<float2*>(st + mi * kLdRow + ni) = make_float2(v0, v1);
        } else {
          st[ni * kLdCol + mi] = v0;
          st[(ni + 1) * kLdCol + mi] = v1;
        }
      }
  __syncthreads();
  // runs along the output's contiguous dimension: `inner` within `outer`
  const int per = (by_row ? BN : kBM) / kVec, n_runs = per * (by_row ? kBM : BN);
  const int64_t i_end = by_row ? ep.n_end : ep.m_end, o_end = by_row ? ep.m_end : ep.n_end;
  const int64_t i0 = by_row ? n0 : m0, o0 = by_row ? m0 : n0;
  const int64_t s_o = by_row ? ep.s_m : ep.s_n;
  const int64_t g_o = by_row ? ep.g_m : ep.g_n, g_i = by_row ? ep.g_n : ep.g_m;
  const int ld = by_row ? kLdRow : kLdCol;
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0 && s_o % kVec == 0;
  const bool g_vec = ep.dz && g_i == 1 && (reinterpret_cast<uintptr_t>(ep.g) & 15) == 0 &&
                     g_o % 4 == 0;
  for (int q = threadIdx.x; q < n_runs; q += kThreads) {
    const int o = q / per, v = q % per;
    const int64_t go = o0 + o, gi = i0 + int64_t(v) * kVec;
    if (go >= o_end || gi >= i_end) continue;
    const bool whole = gi + kVec <= i_end;
    float r[kVec];
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(r + e) =
          *reinterpret_cast<const float4*>(st + o * ld + v * kVec + e);
    if (ep.dz) {
      const int64_t n_true_i = by_row ? ep.n_true : ep.m_end;   // g's extent along `inner`
      const int64_t n_true_o = by_row ? ep.m_end : ep.n_true;
      float gv[kVec];
      if (g_vec && go < n_true_o && gi + kVec <= n_true_i) {
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          *reinterpret_cast<float4*>(gv + e) =
              *reinterpret_cast<const float4*>(ep.g + go * g_o + gi + e);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          gv[e] = go < n_true_o && gi + e < n_true_i ? ep.g[go * g_o + (gi + e) * g_i] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        r[e] = round_as<T>(gv[e] * activate_derivative(r[e], ep.act));
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) r[e] = activate(r[e], ep.act);
    }
    O* dst = out + go * s_o + gi;
    if (aligned && whole) {
      alignas(16) O w[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) store(w + e, r[e]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(w);
    } else {
      for (int e = 0; e < kVec && gi + e < i_end; ++e) store(dst + e, r[e]);
    }
  }
}

// C = A B over the reduction range [split·k_split, (split + 1)·k_split) of
// [0, k_total), for the tile (row tile, column block, split) of blockIdx.x
// (the column block varies fastest, so the CTAs of one row tile run side by
// side and share its A rows in L2), written by the epilogue.
template <typename T, bool kAKMajor, bool kBKMajor, bool kFma, int NT>
__global__ void __launch_bounds__(kThreads, 2)
wide_product_kernel(Operand a, Operand b, Epilogue ep, int64_t n_blocks, int64_t n_row_tiles,
                    int64_t k_total, int64_t k_split) {
  constexpr int BN = 16 * NT, S = kStages, kBK = stage_k<T>();
  using SA = Tile<T, kAKMajor, kBM>;
  using SB = Tile<T, kBKMajor, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = as + S * SA::kElems;
  const int64_t blk = blockIdx.x % n_blocks, rest = blockIdx.x / n_blocks;
  const int64_t row_tile = rest % n_row_tiles, split = rest / n_row_tiles;
  const int64_t m0 = row_tile * kBM, n0 = blk * BN;
  const int64_t kb = split * k_split, ke = kb + k_split < k_total ? kb + k_split : k_total;
  a.k_end = a.k_end < ke ? a.k_end : ke;
  b.k_end = b.k_end < ke ? b.k_end : ke;
  const bool a_vec = rows_aligned<T>(a), b_vec = rows_aligned<T>(b);
  const int nk = int((ke - kb + kBK - 1) / kBK);
  const auto load = [&](int kt) {
    const int st = kt % S;
    load_tile<T, kAKMajor, kBM>(a, m0, kb + int64_t(kt) * kBK, as + st * SA::kElems, a_vec);
    load_tile<T, kBKMajor, BN>(b, n0, kb + int64_t(kt) * kBK, bs + st * SB::kElems, b_vec);
  };
  float c[2][NT][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j) c[u][j][0] = c[u][j][1] = c[u][j][2] = c[u][j][3] = 0.0f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();   // stage kt has landed; every warp is done with stage kt - 1
    if (kt + S - 1 < nk) load(kt + S - 1);
    cp_async_commit();
    stage_product<T, kAKMajor, kBKMajor, kFma, NT>(as + (kt % S) * SA::kElems,
                                                   bs + (kt % S) * SB::kElems, c);
  }

  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages, which now stage the output
  if (ep.out_bf16)
    store_tile<__nv_bfloat16, T, NT>(ep, c, m0, n0, split, smem);
  else
    store_tile<float, T, NT>(ep, c, m0, n0, split, smem);
}

// The product engine's instance for operand layouts and, in fp32, the
// product unit (kFma); bf16 runs on the tensor cores whatever kFma says.
template <typename T, bool kAKMajor, bool kBKMajor, bool kFma = false>
struct Product {
  // the stages, or the staged output tile where it is larger
  template <int NT>
  static constexpr int smem_bytes() {
    constexpr int ring = kStages *
                         (Tile<T, kAKMajor, kBM>::kElems + Tile<T, kBKMajor, 16 * NT>::kElems) *
                         int(sizeof(T));
    return ring > staged_bytes<NT>() ? ring : staged_bytes<NT>();
  }

  // fn(kernel, BN, shared-memory bytes) with the instance for n columns.
  template <typename Fn>
  static cudaError_t with(int64_t n, Fn fn) {
    constexpr bool kF = kFma && sizeof(T) == 4;
    if (n <= 64) return fn(wide_product_kernel<T, kAKMajor, kBKMajor, kF, 4>, 64, smem_bytes<4>());
    return fn(wide_product_kernel<T, kAKMajor, kBKMajor, kF, 8>, 128, smem_bytes<8>());
  }

  // C (m x n) = A B over a reduction of k_total elements, in ranges of
  // k_split (one range unless the caller splits it).
  static cudaError_t run(const Operand& a, const Operand& b, const Epilogue& ep, int64_t m,
                         int64_t n, int64_t k_total, int64_t k_split, cudaStream_t stream) {
    if (ep.s_n != 1 && ep.s_m != 1) return cudaErrorInvalidValue;   // store_tile's layouts
    return with(n, [&](auto kernel, int bn, int bytes) {
      const cudaError_t e = allow_smem(kernel, bytes);
      if (e != cudaSuccess) return e;
      const int64_t n_blocks = (n + bn - 1) / bn, n_row_tiles = (m + kBM - 1) / kBM;
      const int64_t n_splits = (k_total + k_split - 1) / k_split;
      kernel<<<unsigned(n_blocks * n_row_tiles * n_splits), kThreads, bytes, stream>>>(
          a, b, ep, n_blocks, n_row_tiles, k_total, k_split);
      return cudaGetLastError();
    });
  }
};

// x as the A operand of the forward (rows: samples, reduction: features):
// k-major where x is feature-major (x_stride_b == 1), else sample-major.
struct Input {
  const void* x;
  int64_t x_stride_b, x_stride_d, batch;
  int k;
  bool soa() const { return x_stride_b == 1; }
  Operand rows() const { return {x, soa() ? x_stride_d : x_stride_b, batch, k}; }
  // xᵀ as the A operand of the weight gradient (rows: features, reduction:
  // samples): sample-major rows of a feature-major x, k-major otherwise
  Operand features() const { return {x, soa() ? x_stride_d : x_stride_b, k, batch}; }
};

template <typename T, typename Fn>
cudaError_t by_layout(const Input& in, Fn fn) {
  if (in.x_stride_b != 1 && in.x_stride_d != 1) return cudaErrorInvalidValue;
  return in.soa() ? fn(Product<T, true, true, kFmaZ>{}) : fn(Product<T, false, true, kFmaZ>{});
}

// y (batch x n_cols) through the epilogue from x W, W (k, n) row-major;
// columns of y past n read W as zeros.
template <typename T>
cudaError_t forward(const Input& in, const void* w, int n, int64_t n_cols, const Epilogue& ep,
                    cudaStream_t stream) {
  const Operand wk{w, n, n, in.k};   // W: k-major
  return by_layout<T>(in, [&](auto product) {
    return decltype(product)::run(in.rows(), wk, ep, in.batch, n_cols, in.k, in.k, stream);
  });
}

// fn(product) with the instance of the weight gradient, whose A operand is
// xᵀ: [k][b] rows of a feature-major x (not k-major), k-major for a
// sample-major one.
template <typename T, typename Fn>
cudaError_t by_wgrad_layout(const Input& in, Fn fn) {
  return in.soa() ? fn(Product<T, false, true, kFmaGrads>{})
                   : fn(Product<T, true, true, kFmaGrads>{});
}

// The batch rows each CTA of the weight gradient sums: enough ranges for
// one CTA on every slot the card has for this instance (occupancy times
// SMs) over the `tiles` (K x N) output tiles, a multiple of kBK rows each.
template <int kBK, typename Kernel>
cudaError_t wgrad_rows(Kernel kernel, int bytes, int64_t tiles, int64_t batch, int64_t* rows) {
  int slots = 0;
  const cudaError_t e = persistent_ctas(kernel, kThreads, bytes, int64_t(1) << 40, &slots);
  if (e != cudaSuccess) return e;
  const int64_t ranges = (slots + tiles - 1) / tiles;
  *rows = ((batch + ranges - 1) / ranges + kBK - 1) / kBK * kBK;
  return cudaSuccess;
}

template <typename T>
cudaError_t backward(const Input& in, const void* w, int n, const float* g, int64_t g_stride_b,
                     int64_t g_stride_d, void* dx, int64_t dx_stride_b, int64_t dx_stride_d,
                     bool dx_bf16, const std::function<float*(int64_t)>& scratch, float* dw,
                     int act, cudaStream_t stream) {
  const int64_t B = in.batch, K = in.k, ldz = (n + 7) / 8 * 8;
  int64_t rows = 0;
  cudaError_t err = by_wgrad_layout<T>(in, [&](auto product) {
    return decltype(product)::with(n, [&](auto kernel, int bn, int bytes) {
      const int64_t tiles = ((K + kBM - 1) / kBM) * ((n + bn - 1) / bn);
      return wgrad_rows<stage_k<T>()>(kernel, bytes, tiles, B, &rows);
    });
  });
  if (err != cudaSuccess) return err;
  const int64_t n_ranges = (B + rows - 1) / rows;
  // scratch: dz (B x ldz in the compute dtype), then the ranges' partial dW
  const int64_t dz_floats = (B * ldz * int64_t(sizeof(T)) + 15) / 16 * 4;
  float* buf = scratch(dz_floats + n_ranges * K * n);
  T* dz = reinterpret_cast<T*>(buf);
  float* partials = buf + dz_floats;

  // 1. dz = g · act'(x W) rounded to the compute dtype; columns [n, ldz)
  //    read W as zeros and g as zeros: dz 0 there
  const Epilogue e1{dz, 0, ldz, 1, B, ldz, sizeof(T) == 2 ? 1 : 0, act, 1,
                    g, g_stride_b, g_stride_d, n};
  err = forward<T>(in, w, n, ldz, e1, stream);
  if (err != cudaSuccess) return err;
  // 2. dx = dz Wᵀ: A = dz (sample-major), B = Wᵀ, whose column k is row k
  //    of W (k, n): not k-major
  const Epilogue e2{dx, 0, dx_stride_b, dx_stride_d, B, K, dx_bf16 ? 1 : 0, 0, 0,
                    nullptr, 0, 0, 0};
  err = Product<T, false, false, kFmaGrads>::run({dz, ldz, B, ldz}, {w, n, K, n}, e2, B, K,
                                                 ldz, ldz, stream);
  if (err != cudaSuccess) return err;
  // 3. each range's partial dW = xᵀ dz (B = dz, k-major), then their sum in
  //    range order
  const Epilogue e3{partials, K * n, n, 1, K, n, 0, 0, 0, nullptr, 0, 0, 0};
  err = by_wgrad_layout<T>(in, [&](auto product) {
    return decltype(product)::run(in.features(), {dz, ldz, ldz, B}, e3, K, n, B, rows, stream);
  });
  if (err != cudaSuccess) return err;
  const int64_t total = K * n;
  sum_partials_kernel<<<unsigned((total + 255) / 256), 256, 0, stream>>>(
      partials, int(n_ranges), total, dw);
  return cudaGetLastError();
}

}  // namespace

cudaError_t fused_mlp_wide_fwd_launch(const void* x, int64_t x_stride_b, int64_t x_stride_d,
                                      int k, const void* w, int n, void* y, int64_t y_stride_b,
                                      int64_t y_stride_d, bool y_bf16, int64_t batch,
                                      bool compute_bf16, int act, cudaStream_t stream) {
  if (batch <= 0 || k < 1 || n < 1) return cudaErrorInvalidValue;
  const Input in{x, x_stride_b, x_stride_d, batch, k};
  const Epilogue ep{y, 0, y_stride_b, y_stride_d, batch, n, y_bf16 ? 1 : 0, act, 0,
                    nullptr, 0, 0, 0};
  return compute_bf16 ? forward<__nv_bfloat16>(in, w, n, n, ep, stream)
                      : forward<float>(in, w, n, n, ep, stream);
}

cudaError_t fused_mlp_wide_bwd_launch(const void* x, int64_t x_stride_b, int64_t x_stride_d,
                                      int k, const void* w, int n, const float* g,
                                      int64_t g_stride_b, int64_t g_stride_d, void* dx,
                                      int64_t dx_stride_b, int64_t dx_stride_d, bool dx_bf16,
                                      const std::function<float*(int64_t)>& scratch, float* dw,
                                      int64_t batch, bool compute_bf16, int act,
                                      cudaStream_t stream) {
  if (batch <= 0 || k < 1 || n < 1) return cudaErrorInvalidValue;
  const Input in{x, x_stride_b, x_stride_d, batch, k};
  return compute_bf16
             ? backward<__nv_bfloat16>(in, w, n, g, g_stride_b, g_stride_d, dx, dx_stride_b,
                                       dx_stride_d, dx_bf16, scratch, dw, act, stream)
             : backward<float>(in, w, n, g, g_stride_b, g_stride_d, dx, dx_stride_b, dx_stride_d,
                               dx_bf16, scratch, dw, act, stream);
}

}  // namespace tcnn_tpu_torch

"""Where the time of kernels G, GB, GI, GG, GT, RS, M and MB goes, on the card.

    python3 -m tcnn_tpu_torch.tools.kernel_ablation [--out DIR] [--only PREFIX ...]
                                                   [--baseline ROOT]
    python3 -m tcnn_tpu_torch.tools.kernel_ablation --steps ROUNDS --baseline ROOT
    python3 -m tcnn_tpu_torch.tools.kernel_ablation --atomics   # no card needed
    python3 -m tcnn_tpu_torch.tools.kernel_ablation --sectors   # no card needed

At B = 2^18 with random inputs from a seed it times, as device time in a
CUDA graph of 30 calls:
  * G at the config_hash, config_btf (4-D, strided input, AoS output) and
    SDF (fp32 table) shapes, and GI and GG at the SDF step's (GI also on
    a bf16 table and cotangent, and under per-sample level masks);
  * GB, M and MB at the config_hash shapes (BF16_POLICY), M and MB in fp32
    at the SDF sample's MLP (16 -> 64 x 2 -> 1) and at config_hash's
    (32 -> 64 x 2 -> 3), SoA input, in bf16 at config_btf's
    (40 -> 64 x 3 -> 3, AoS input), and in both dtypes at
    config_oneblob's (128 -> 128 x 5 -> 3, AoS input);
  * GB at the SDF step's shape (3-D, fp32 table, surface points) and at
    config_btf's (4-D CoherentAdd, 2^19-row levels, bf16 table); GG at
    the SDF step's shape also at 2^14 samples, unsharded and in shard mode
    (shard 0 of 2), and the grid's second order as the eikonal step calls
    it (``GridBwdBwdFunction.forward``: GG, or in a checkout before GG
    added its table gradient itself, GG and RS); RS on GG's updates as
    (rows, g) at the eikonal step's layout; GT at the SDF step's shape
    with all outputs and with the curvature step's (d_dcols and the table
    gradient, no d_x), at 2^14, under a mask at 0.5 and at 2^14 in shard
    mode (shard 0 of 2);
  * GB over no level (its zeroing and cast) and one level at a time;
  * the same kernels in ablated copies of the package: ``DIR/<name>``
    holds a copy of ``tcnn_tpu_torch`` with one source patch
    (``ABLATIONS``; ``--only`` keeps those whose names start with a
    prefix given), built in its own process, all copies at once.  An
    ablated kernel may compute a wrong result by design; only its time is
    read, and for the fp32 MLPs it is checked (``fp32_check``) at the
    tolerances of ``chip_smoke.py``.
``--baseline ROOT`` also times the ``tcnn_tpu_torch`` of another checkout
at ROOT (say, the parent commit unpacked by ``git archive`` into a
directory ``.gitignore`` lists) with this file's timing code, in the same
call, as the variant ``baseline``, and says which outputs of the
deterministic kernels (G, GI, GG's and GT's d_dcols and d_x, M, MB's dW), and
GB's on inputs whose sums are exact in any order, have the same bits in
both.
``--steps ROUNDS`` instead times whole steps of this checkout and of ROOT
in turn, ROUNDS runs each (``compare_steps``): ``chip_smoke.py``'s
config_hash step (on the device, eager, its parts alone, the loop) and
its SDF eikonal step (on the device, eager, its peak device memory
above what it finds allocated, and what it holds when it calls the
grid's second order and the peak inside that call) and its curvature
step (the eikonal loss plus 1e-3 · mean |H v|², on the device and eager),
and the host's share of each step (``host_ms``: the wall time one call
takes to return and to finish on the card, the card idle before it,
median and least), each with the build time of both checkouts, and per
number the rounds in which this checkout read lower.
Every number is printed beside the card's name and power limit.  Needs
one CUDA device; DIR defaults to ``build/ablations`` at the checkout's
root.  ``--atomics`` instead counts, on the CPU, the global atomics one
launch of GB, of RS and of GT issues at B = 2^18 on inputs drawn as
``chip_smoke.py`` draws them, in this design and in the one before it
(``atomic_counts``);
``--sectors`` the 32-byte table sectors one launch of G requests
(``sector_counts``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]

_FAST = "  return a.act <= 1 && a.out_act <= 1;"

_GB_PLAN = "../ops/cuda/grid_encode.py"

_M_LAUNCH = "  kernel<<<ctas, threads, s.bytes, stream>>>(a, s);"
_M_RESIDENT = "  s.resident = s.w + all <= kMaxSmem;"
_G_SAMPLES = "constexpr int kSamples = 2;"
_G_REGS = "constexpr int kLoadRegs = 48;"
_G_ROWS = "    lc.rows(hc, pow2, rows[s]);"
_GI_CTAS = "  return (1 << D) * F <= 16 ? 4 : 1;"
_G_ROWS_IN_FULL = "#pragma unroll\n    for (int c = 0; c < C; ++c) rows[s][c] = lc.row(c, hc);"

# Kernel M's bf16 weights staged TRANSPOSED and each B fragment read by two
# 32-bit loads (the layout before ldmatrix.trans), for ``m_no_ldmatrix``.
_M_TRANSPOSED_HELPERS = r"""// Stages a row-major (k_real, n_real) bf16 weight matrix from global
// memory into shared memory TRANSPOSED, dst[n * ld + k], zero-padded to
// (K, N): a B fragment of mma.m16n8k16 is then two 32-bit loads of
// consecutive k.  Rows of W elements move as 16-byte chunks, consecutive
// lanes on consecutive k so the transposing stores do not collide in a
// bank; others (the D_out-wide output layer) go element by element.
template <int W>
__device__ __forceinline__ void stage_weights_t(const __nv_bfloat16* __restrict__ w,
                                                int k_real, int n_real, int K, int N,
                                                __nv_bfloat16* dst, int ld) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (n_real == W && N == W && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    constexpr int kChunks = W / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < K * kChunks; c += blockDim.x) {
      const int k = c % K, j = c / K;
      const uint4 v = k < k_real
          ? __ldg(reinterpret_cast<const uint4*>(w + k * W) + j)
          : make_uint4(0, 0, 0, 0);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int u = 0; u < 8; ++u) dst[(8 * j + u) * ld + k] = e[u];
    }
    return;
  }
  staged_copy<__nv_bfloat16>(
      K * N,
      [&](int i) {
        const int n = i / K, k = i % K;
        return (k < k_real && n < n_real) ? w[k * n_real + n] : zero;
      },
      [&](int i, __nv_bfloat16 v) { dst[(i / K) * ld + i % K] = v; });
}

// The B fragment of n-tile j, k-step kb, from transposed weights wt.
__device__ __forceinline__ void load_b(const __nv_bfloat16* wt, int ld, int j, int kb,
                                       int g, int t, uint32_t* b0, uint32_t* b1) {
  const __nv_bfloat16* p = wt + (8 * j + g) * ld + 16 * kb + 2 * t;
  *b0 = ld32(p);
  *b1 = ld32(p + 8);
}

"""
_M_NO_LDMATRIX = [
    ("fused_mlp.cu", "// bf16 compute: persistent CTAs walk the tiles",
     _M_TRANSPOSED_HELPERS + "// bf16 compute: persistent CTAs walk the tiles"),
    ("fused_mlp.cu", "  return make_int2(k, n + kSkew);", "  return make_int2(n, k + kSkew);"),
    ("fused_mlp.cu", "stage_rowmajor<__nv_bfloat16>(src, k_real, n_real, pad16(k_real), n, dst,",
     "stage_weights_t<W>(src, k_real, n_real, pad16(k_real), n, dst,"),
    ("fused_mlp.cu", "load_b_pair(wl, ld, 16 * kb, 16 * p, b);",
     "load_b(wl, ld, 2 * p, kb, g, t, &b[0], &b[1]); "
     "load_b(wl, ld, 2 * p + 1, kb, g, t, &b[2], &b[3]);"),
]


def _g_pair_loads(unit: int) -> list:
    """Kernel G with the dim-0 pair loads: corners 2p and 2p + 1 (dim-0
    neighbours) by one ``unit``-byte load of the unit holding row 2p, and a
    load of row 2p + 1 only where it lies in another unit (checked on the
    rows computed: a CoherentPrime pair shares a unit only from an even
    cell, a dense or CoherentAdd pair not across a unit's end or the
    level's wrap); for 2-, 4- and 8-byte rows (``sector_counts`` counts
    their sectors)."""
    unit_rows = r"""
template <typename T, int F>
__host__ __device__ constexpr int unit_rows() {
  constexpr int rb = row_bytes<T, F>();
  return ((rb == 2 || rb == 4 || rb == 8) && 2 * rb <= kPairUnit) ? kPairUnit / rb : 0;
}
"""
    unit_loads = r"""using PairUnit = std::conditional_t<kPairUnit == 16, uint4, uint2>;
__device__ __forceinline__ uint32_t unit_word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
__device__ __forceinline__ uint32_t unit_word(const uint2& u, int i) { return i ? u.y : u.x; }

// Row `pos` of a unit of (kPairUnit / row_bytes) rows, as fp32.
template <typename T, int F>
__device__ __forceinline__ void unit_row(const PairUnit& u, int pos, float (&v)[F]) {
  constexpr int rb = row_bytes<T, F>();
  uint2 w;
  if constexpr (rb == 8) {
    w = make_uint2(unit_word(u, 2 * pos), unit_word(u, 2 * pos + 1));
  } else {
    w.x = unit_word(u, rb == 4 ? pos : pos >> 1);
    if (rb == 2) w.x >>= 16 * (pos & 1);
    w.y = 0;
  }
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = to_f32(e[f]);
}

"""
    pairs = r"""  constexpr int U = unit_rows<T, F>();
  if constexpr (U > 0) {
    PairUnit unit[S][C / 2];
    RawRow<T, F> lone[S][C / 2];
    // Per pair: the two rows' places in the unit (bits 0-3, 4-7) and
    // whether row 2p + 1 lies in it (bit 8).
    uint32_t where[S][C / 2];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int p = 0; p < C / 2; ++p) {
        const uint32_t r0 = rows[s][2 * p], r1 = rows[s][2 * p + 1];
        const bool shared = r0 / U == r1 / U;
        unit[s][p] = __ldg(reinterpret_cast<const PairUnit*>(table) + r0 / U);
        if (!shared) lone[s][p].load(table + int64_t(r1) * F);
        where[s][p] = r0 % U | (r1 % U) << 4 | uint32_t(shared) << 8;
      }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t wp = where[s][c / 2];
        float v[F];
        if ((c & 1) && !(wp >> 8))
          lone[s][c / 2].get(v);
        else
          unit_row<T, F>(unit[s][c / 2], int((c & 1) ? (wp >> 4) & 15 : wp & 15), v);
        const float w = corner_weight<D>(w1[s], c);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[s][f] = __fadd_rn(acc[s][f], __fmul_rn(w, v[f]));
      }
    return;
  }
"""
    row_bytes = "__host__ __device__ constexpr int row_bytes() { return F * int(sizeof(T)); }\n"
    return [
        ("grid_encode.cu", row_bytes,
         row_bytes + f"constexpr int kPairUnit = {unit};\n" + unit_rows),
        ("grid_encode.cu", "  constexpr int n = kLoadRegs / ((1 << D) * words);",
         "  constexpr int n = kLoadRegs / (unit_rows<T, F>() ? (1 << (D - 1)) * "
         "(kPairUnit / 4 + words) : (1 << D) * words);"),
        ("grid_encode.cu", "// One level for S samples:",
         unit_loads + "// One level for S samples:"),
        ("grid_encode.cu", "  RawRow<T, F> raw[S][C];\n", pairs + "  RawRow<T, F> raw[S][C];\n"),
    ]


# name: [(source file under csrc/, or a path from there, text, replacement)]
ABLATIONS = {
    # MB without its weight gradient (the dgrad chain and dx stay).
    "mb_no_wgrad": [("fused_mlp_bwd.cu", " wgrad_bf16<R>(a,",
                     " if (a.batch < 0) wgrad_bf16<R>(a,"),
                    ("fused_mlp_bwd.cu", "        f32_wgrad<",
                     "        if (a.batch < 0) f32_wgrad<")],
    # M and MB with the switch over every activation inlined at each call
    # site, as first written, in place of inline None and ReLU, an
    # out-of-line call for the rest and MB's instance for None and ReLU.
    "mlp_switch_inlined": [
        ("fused_mlp_bwd.cu", _FAST, "  return false;"),
        ("mlp_common.cuh", "__noinline__ float activate_other",
         "__forceinline__ float activate_other"),
        ("mlp_common.cuh", "__noinline__ float activate_derivative_other",
         "__forceinline__ float activate_derivative_other"),
        ("mlp_common.cuh", "  if (act == 1) return fmaxf(z, 0.0f);\n  if (act == 0) return z;\n",
         ""),
        ("mlp_common.cuh",
         "  if (act == 1) return z > 0.0f ? 1.0f : 0.0f;\n  if (act == 0) return 1.0f;\n", ""),
        ("mlp_common.cuh", "    case 2: return fmaxf(z, 0.0f) + 0.01f * fminf(z, 0.0f);",
         "    case 1: return fmaxf(z, 0.0f);\n"
         "    case 2: return fmaxf(z, 0.0f) + 0.01f * fminf(z, 0.0f);"),
        ("mlp_common.cuh", "    case 2: return z > 0.0f ? 1.0f : 0.01f;",
         "    case 1: return z > 0.0f ? 1.0f : 0.0f;\n"
         "    case 2: return z > 0.0f ? 1.0f : 0.01f;")],
    # MB without its instance for None and ReLU only (every activation
    # through the inline None/ReLU test and the out-of-line call; z kept in
    # fp32 in place of h and act'(z) bits).
    "mb_no_fast_instance": [("fused_mlp_bwd.cu", _FAST, "  return false;")],
    # M (fp32) and MB without resident weights: every tile stages every
    # layer's weights, between __syncthreads, and MB adds into its partial
    # dW in device memory per tile (the first design's traffic).
    "mlp_not_resident": [
        ("fused_mlp_bwd.cu", "  s.resident = common + wall + dwb <= kMaxSmem;",
         "  s.resident = false;"),
        ("fused_mlp_bwd.cu", "  s.resident = (common + wall + dwf) * 4 <= kMaxSmem;",
         "  s.resident = false;"),
        ("fused_mlp.cu", "  s.resident = (base + all) * 4 <= kMaxSmem;", "  s.resident = false;")],
    # M (fp32) and MB with one input buffer: the next tile's input is not
    # copied while the current one computes.
    "mlp_no_prefetch": [
        ("fused_mlp_bwd.cu", "  s.n_xbuf = common + xb + wb <= kMaxSmem ? 2 : 1;",
         "  s.n_xbuf = 1;"),
        ("fused_mlp_bwd.cu", "  s.n_xbuf = (common + xf + wf) * 4 <= kMaxSmem ? 2 : 1;",
         "  s.n_xbuf = 1;"),
        ("fused_mlp.cu", "  s.n_xbuf = (base + xf + wf) * 4 <= kMaxSmem ? 2 : 1;",
         "  s.n_xbuf = 1;")],
    # M and MB in fp32 on the tensor cores in 3xTF32 (mma.m16n8k8) in place
    # of register-tiled fp32 FMA.
    "f32_3xtf32": [("mlp_common.cuh", "constexpr bool kTf32x3 = false;",
                    "constexpr bool kTf32x3 = true;")],
    # M and MB in fp32 with 256 threads per CTA (16 warps per SM at two
    # CTAs), each owning half the columns.
    "f32_256_threads": [("mlp_common.cuh", "constexpr int kThreadsF32 = 128;",
                         "constexpr int kThreadsF32 = 256;")],
    # MB's fp32 weight gradient in 8 x 8 register blocks (16 float4 loads
    # per 256 FMAs) in place of 4 x 4 (8 per 64).
    "f32_wgrad_8x8": [("mlp_common.cuh", "template <int R, bool kActA, bool kFast, int T = 4>",
                       "template <int R, bool kActA, bool kFast, int T = 8>")],
    # GB and RS with plain stores and adds in place of their atomics, global
    # (float2, float4) and shared (what contention costs).
    "gb_plain_stores": [
        ("scatter_common.cuh",
         "    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));",
         "    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);"),
        ("scatter_common.cuh",
         "    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));",
         "    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);"),
        ("scatter_common.cuh", "float v) { atomicAdd(p, v); }", "float v) { *p += v; }")],
    # GB with every level on direct atomics (no shared-memory windows).
    "gb_no_shared_levels": [(_GB_PLAN, "GB_MAX_PARTS = 2", "GB_MAX_PARTS = 0")],
    # GB with windows for every level that fits in two CTAs, and for levels
    # whose rows take 64, 128, 512 or 1024 updates or more over the batch,
    # in place of 256.
    "gb_hits_0": [(_GB_PLAN, "GB_MIN_HITS = 256", "GB_MIN_HITS = 0")],
    "gb_hits_64": [(_GB_PLAN, "GB_MIN_HITS = 256", "GB_MIN_HITS = 64")],
    "gb_hits_128": [(_GB_PLAN, "GB_MIN_HITS = 256", "GB_MIN_HITS = 128")],
    "gb_hits_512": [(_GB_PLAN, "GB_MIN_HITS = 256", "GB_MIN_HITS = 512")],
    "gb_hits_1024": [(_GB_PLAN, "GB_MIN_HITS = 256", "GB_MIN_HITS = 1024")],
    # GB's two-part levels as 2-CTA clusters in distributed shared memory,
    # every level that fits windowed (at 256 no level of the repo's grids
    # takes two parts).
    "gb_cluster_parts": [("grid_encode_bwd.cu", "constexpr bool kClusterParts = false;",
                          "constexpr bool kClusterParts = true;"),
                         (_GB_PLAN, "GB_CLUSTER_PARTS = False", "GB_CLUSTER_PARTS = True"),
                         (_GB_PLAN, "GB_MIN_HITS = 256", "GB_MIN_HITS = 0")],
    # GB's sample loop one sample at a time (no loads issued ahead).
    "gb_unroll_1": [("grid_encode_bwd.cu", "constexpr int kUnroll = 4;",
                     "constexpr int kUnroll = 1;")],
    # GB's window chunks sized for 2, 4 and 16 updates per row in place of 8.
    "gb_reuse_2": [(_GB_PLAN, "GB_REUSE = 8", "GB_REUSE = 2")],
    "gb_reuse_4": [(_GB_PLAN, "GB_REUSE = 8", "GB_REUSE = 4")],
    "gb_reuse_16": [(_GB_PLAN, "GB_REUSE = 8", "GB_REUSE = 16")],
    # GB's direct items of 8192 samples in place of 2048.
    "gb_direct_chunk_8192": [(_GB_PLAN, "GB_DIRECT_CHUNK = 2048", "GB_DIRECT_CHUNK = 8192")],
    # GB's windows at most 110 KB (two CTAs per SM; 32,768-row levels at F
    # = 2 in three parts) in place of the whole 227 KB, every level that
    # fits windowed.
    "gb_window_110k": [(_GB_PLAN, "GB_WINDOW_BYTES = 232448 - 1024",
                        "GB_WINDOW_BYTES = 110 * 1024"),
                       (_GB_PLAN, "GB_MAX_PARTS = 2", "GB_MAX_PARTS = 3"),
                       (_GB_PLAN, "GB_MIN_HITS = 256", "GB_MIN_HITS = 0")],
    # GG's levels cut into about 32, 128 and 256 items in place of 64; GG
    # with CTAs of 512 threads.
    "gg_items_32": [(_GB_PLAN, "GG_ITEMS = 64", "GG_ITEMS = 32")],
    "gg_items_128": [(_GB_PLAN, "GG_ITEMS = 64", "GG_ITEMS = 128")],
    "gg_items_256": [(_GB_PLAN, "GG_ITEMS = 64", "GG_ITEMS = 256")],
    "gg_threads_512": [("grid_encode_bwd_bwd.cu", "constexpr int kGgThreads = 256;",
                        "constexpr int kGgThreads = 512;"),
                       (_GB_PLAN, "GG_THREADS = 256", "GG_THREADS = 512")],
    # GB's direct path without its 16-byte atomics for dim-0 pairs.
    "gb_no_pair_atomics": [("grid_encode_bwd.cu", "if (o0 && o1 && r1 == r0 + 1 && (r0 & 1) == 0) {",
                            "if (false) {")],
    # Every grid row folded into the first 2^20 (8 MB of fp32 at F = 2):
    # GB's direct atomics at config_btf then land in a buffer that the
    # 50 MB L2 holds, the same number of them at the same rate of
    # issue.  If config_btf's GB runs much faster so, the 62 MB buffer's
    # misses in L2 set its pace; if not, the atomics' rate does.  (Results
    # wrong by design.)
    "gb_btf_l2_resident": [("grid_common.cuh", "    return fastmod(h, magic, size) + offset;",
                            "    return (fastmod(h, magic, size) + offset) & 0xFFFFFu;")],
    # M's bf16 path with one CTA per tile in place of persistent CTAs.
    "m_not_persistent": [("fused_mlp.cu", _M_LAUNCH,
                          "  ctas = int((a.batch + rows - 1) / rows);\n" + _M_LAUNCH)],
    # M's bf16 path persistent, but staging every layer's weights per tile.
    "m_weights_per_tile": [("fused_mlp.cu", _M_RESIDENT, "  s.resident = false;")],
    # M's bf16 path with its weights transposed and B fragments by two
    # 32-bit loads each, in place of ldmatrix.trans.
    "m_no_ldmatrix": _M_NO_LDMATRIX,
    # The first design's bf16 choices together: one CTA per tile, weights
    # per tile, transposed, two 32-bit loads per B fragment.
    "m_first_design": [("fused_mlp.cu", _M_LAUNCH,
                        "  ctas = int((a.batch + rows - 1) / rows);\n" + _M_LAUNCH),
                       ("fused_mlp.cu", _M_RESIDENT, "  s.resident = false;"),
                       *_M_NO_LDMATRIX],
    # G with the dim-0 pair loads: corners c, c|1 by one 16-byte (8-byte)
    # load where their rows share its unit.
    "g_pair_loads": _g_pair_loads(16),
    "g_pair_loads_8": _g_pair_loads(8),
    # G computing each corner's row in full (LevelCorners::row: D
    # multiplies and the 64-bit modulo per corner).
    "g_no_per_dim_terms": [("grid_encode.cu", _G_ROWS, _G_ROWS_IN_FULL)],
    # G with 1 and 4 samples per thread, at most, in place of 2 (4 with
    # twice the registers for loads in flight).
    "g_samples_1": [("grid_encode.cu", _G_SAMPLES, "constexpr int kSamples = 1;")],
    "g_samples_4": [("grid_encode.cu", _G_SAMPLES, "constexpr int kSamples = 4;"),
                    ("grid_encode.cu", _G_REGS, "constexpr int kLoadRegs = 96;")],
    # G with one level per thread for AoS output too (each warp store then
    # writes F values into 32 sectors, which the L2 merges).
    "g_aos_one_level": [("grid_encode.cu", "constexpr bool kAosSectors = true;",
                         "constexpr bool kAosSectors = false;")],
    # The first design's choices together: one sample per thread, every
    # row in full (each row loaded alone, one level per thread, as now).
    "g_first_design": [("grid_encode.cu", _G_ROWS, _G_ROWS_IN_FULL),
                       ("grid_encode.cu", _G_SAMPLES, "constexpr int kSamples = 1;")],
    # Every grid row G reads folded into the first 2^20 (4 MB of config_btf's
    # bf16 table, which the L2 holds whole): if G at config_btf runs much
    # faster so, misses in the L2 set its pace.  (Results wrong by design.)
    "g_btf_l2_resident": [("grid_common.cuh",
                           "      r[c] = (pow2 ? h & (size - 1) : fastmod(h, magic, size)) + offset;",
                           "      r[c] = ((pow2 ? h & (size - 1) : fastmod(h, magic, size)) + offset)"
                           " & 0xFFFFFu;")],
    # GI without its register cap (as many registers as the compiler takes).
    "gi_no_register_cap": [("grid_encode_bwd_input.cu", _GI_CTAS, "  return 1;")],
    # GI's table rows folded into the first 4096, which L1 holds: what its
    # misses in L1 cost.  (Results wrong by design.)
    "gi_rows_in_l1": [("grid_encode_bwd_input.cu",
                       "load_row<T, F>(table + int64_t(rows[c]) * F, t[c]);",
                       "load_row<T, F>(table + int64_t(rows[c] & 0xFFFu) * F, t[c]);")],
    # RS without its shared-memory window (every chunk on direct atomics).
    "rs_no_window": [("row_scatter.cu", "  if (span <= window_floats) {", "  if (false) {")],
    # RS with chunks of 4096, 16,384 and 32,768 updates in place of 8192.
    "rs_chunk_4096": [("row_scatter.cu", "constexpr int kRsPerThread = 16;",
                       "constexpr int kRsPerThread = 8;")],
    "rs_chunk_16384": [("row_scatter.cu", "constexpr int kRsPerThread = 16;",
                        "constexpr int kRsPerThread = 32;")],
    "rs_chunk_32768": [("row_scatter.cu", "constexpr int kRsPerThread = 16;",
                        "constexpr int kRsPerThread = 64;")],
    # RS with a 200 KB window (one CTA per SM) in place of 96 KB.
    "rs_window_200k": [("row_scatter.cu", "constexpr int kRsWindowBytes = 96 * 1024;",
                        "constexpr int kRsWindowBytes = 200 * 1024;")],
}

BATCH = 1 << 18
N_CALLS = 30


def graph_ms(fn, n=N_CALLS, reps=5):
    """Device time per call: n calls captured in one CUDA graph, replayed
    reps times between CUDA events, median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[reps // 2]


def _bits(t: torch.Tensor) -> str:
    """A digest of a tensor's bytes: two runs of deterministic kernels on
    the same inputs (another checkout's, ``--baseline``) compare by it."""
    return hashlib.sha1(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes()).hexdigest()[:16]


def time_kernels(config: str, full: bool) -> dict:
    """Times G, GB, GI, GG, GT, RS, M and MB of the ``tcnn_tpu_torch`` on
    ``sys.path``; entries ``bits ...`` hold digests of the outputs of the
    deterministic kernels (G, GI, GG's and GT's d_dcols and d_x, M, MB's
    dW) and of GB's on inputs whose sums are exact."""
    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.common import Activation, HashType
    from tcnn_tpu_torch import Policy
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_fwd
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_bwd_bwd,
                                                     grid_encode_bwd_input, grid_encode_fwd,
                                                     grid_encode_third)
    from tcnn_tpu_torch.ops.cuda.scatter import row_scatter_add
    from tcnn_tpu_torch.ops.grid_ops import GridBwdBwdFunction
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    model = create_from_config(2, 3, config, policy=BF16_POLICY)
    enc, net = model.network.encoding, model.network.network
    spec, live = enc.spec, list(range(enc.spec.n_levels))
    x = torch.rand((BATCH, 2), generator=gen, device=dev)
    table = enc.grid.detach().to(torch.bfloat16)
    ws = [w.detach().to(torch.bfloat16) for w in net.layers]
    out = {}
    with torch.inference_mode():
        feats = grid_encode_fwd(spec, table, x, live, soa=True)
        dy = torch.randn((BATCH, 3), generator=gen, device=dev) * 1e-3
        mb_args = (ws, feats, dy, net.activation, net.output_activation, torch.bfloat16,
                   True, False)
        dfeats = fused_mlp_bwd(*mb_args)[1]
        out["G"] = graph_ms(lambda: grid_encode_fwd(spec, table, x, live, soa=True))
        out["bits G"] = _bits(feats)
        out["GB"] = graph_ms(lambda: grid_encode_bwd(spec, table, x, dfeats, live))
        # GB on inputs whose sums are exact in fp32 in any order (integer
        # scales, x in 1/16ths, dcols in 1/4ths, rows below 2^22 of
        # 1/(4·16^2)): atomics in any order give these bits
        espec = grid_ops.make_grid_spec(2, 6, 2, 12, 4, 2.0)
        ex = torch.randint(0, 17, (1 << 14, 2), generator=gen, device=dev).float() / 16
        edc = torch.randint(-4, 5, (12, 1 << 14), generator=gen, device=dev).float() / 4
        etable = torch.zeros(espec.n_params, device=dev)
        out["bits GB exact"] = _bits(grid_encode_bwd(espec, etable, ex, edc,
                                                     list(range(espec.n_levels))))
        # every hash type and D the kernels took before the Rng hash and the
        # 5- to 7-D instance: G, GI and GG (deterministic) and GB on sums that
        # are exact (x in quarters: weights of 1/4^D, dcols of 1/4, at most
        # 256 x 2^D updates of a row below 2^(24 - 2 - 2D))
        for ht in (HashType.PRIME, HashType.COHERENT_PRIME, HashType.REVERSED_PRIME,
                   HashType.COHERENT_ADD):
            for d in (1, 2, 3, 4):
                hspec = grid_ops.make_grid_spec(d, 6, 2, 12, 4, 2.0, hash_type=ht)
                hlive = list(range(hspec.n_levels))
                hx = torch.randint(0, 5, (256, d), generator=gen, device=dev).float() / 4
                hdc = torch.randint(-4, 5, (12, 256), generator=gen, device=dev).float() / 4
                htable = torch.rand(hspec.n_params, generator=gen, device=dev) * 2 - 1
                hdx = torch.randn((256, d), generator=gen, device=dev)
                key = f"{ht.value} {d}-D"
                out[f"bits G {key}"] = _bits(grid_encode_fwd(hspec, htable, hx, hlive))
                out[f"bits GB exact {key}"] = _bits(grid_encode_bwd(
                    hspec, torch.zeros_like(htable), hx, hdc, hlive))
                out[f"bits GI {key}"] = _bits(grid_encode_bwd_input(hspec, htable, hx, hdc,
                                                                    hlive))
                hgg = grid_encode_bwd_bwd(hspec, htable, hx, hdc, hdx, hlive)
                out[f"bits GG d_dcols {key}"] = _bits(hgg.d_dcols)
                out[f"bits GG d_x {key}"] = _bits(hgg.d_x)
        # the run-time-D instances at the shapes they took before groups of
        # features: the Rng hash, 5 dims, a per-sample mask, shard mode
        for key, (d, ht, masked, shard) in {
                "Rng 3-D": (3, HashType.RNG, False, None),
                "CoherentPrime 5-D": (5, HashType.COHERENT_PRIME, False, None),
                "CoherentPrime 3-D masked": (3, HashType.COHERENT_PRIME, True, None),
                "CoherentPrime 3-D shard": (3, HashType.COHERENT_PRIME, False, (1, 2))}.items():
            wspec = grid_ops.make_grid_spec(d, 6, 2, 12, 4, 2.0, hash_type=ht,
                                            interpolation=grid_ops.InterpolationType.SMOOTHSTEP)
            wlive = list(range(wspec.n_levels))
            wx = torch.rand((1024, d), generator=gen, device=dev) * 0.9 + 0.05
            wdc = torch.randn((12, 1024), generator=gen, device=dev)
            wtable = torch.rand(wspec.n_params // (shard[1] if shard else 1), generator=gen,
                                device=dev) * 2 - 1
            wv, wb = (torch.randn((1024, d), generator=gen, device=dev) for _ in range(2))
            kw = {"level_frac": torch.rand(1024, generator=gen, device=dev) if masked else None,
                  "shard": shard}
            if not masked:   # G and GI take a mask in their 1- to 4-D instances
                out[f"bits G {key}"] = _bits(grid_encode_fwd(wspec, wtable, wx, wlive, **kw))
                out[f"bits GI {key}"] = _bits(grid_encode_bwd_input(wspec, wtable, wx, wdc,
                                                                    wlive, **kw))
            wgg = grid_encode_bwd_bwd(wspec, wtable, wx, wdc, wv, wlive, **kw)
            out[f"bits GG d_dcols {key}"] = _bits(wgg.d_dcols)
            out[f"bits GG d_x {key}"] = _bits(wgg.d_x)
            wgt = grid_encode_third(wspec, wtable, wx, wdc, wv, wb, wlive, **kw)
            out[f"bits GT d_dcols {key}"] = _bits(wgt.d_dcols)
            out[f"bits GT d_x {key}"] = _bits(wgt.d_x)
        out["M"] = graph_ms(lambda: fused_mlp_fwd(ws, feats, net.activation,
                                                  net.output_activation, torch.bfloat16,
                                                  torch.float32, True, False))
        out["MB"] = graph_ms(lambda: fused_mlp_bwd(*mb_args))
        relu, none = Activation.RELU, Activation.NONE
        for label, dims, soa, cdt in (
                ("sdf", [(16, 64), (64, 64), (64, 1)], True, torch.float32),
                ("config_hash", [(32, 64), (64, 64), (64, 3)], True, torch.float32),
                ("config_btf", [(40, 64), (64, 64), (64, 64), (64, 3)], False, torch.bfloat16),
                ("config_oneblob", [(128, 128)] * 5 + [(128, 3)], False, torch.bfloat16),
                ("config_oneblob", [(128, 128)] * 5 + [(128, 3)], False, torch.float32)):
            ws_ = [(torch.rand(d, generator=gen, device=dev) * 2 - 1) * (6.0 / sum(d)) ** 0.5
                   for d in dims]
            x_ = torch.rand((dims[0][0], BATCH) if soa else (BATCH, dims[0][0]),
                            generator=gen, device=dev).to(cdt)
            g_ = torch.randn((BATCH, dims[-1][1]), generator=gen, device=dev)
            kind = f"{str(cdt)[6:]}, {label}"
            out[f"M {kind}"] = graph_ms(lambda: fused_mlp_fwd(ws_, x_, relu, none, cdt,
                                                              torch.float32, soa, False))
            out[f"bits M {kind}"] = _bits(fused_mlp_fwd(ws_, x_, relu, none, cdt, torch.float32,
                                                        soa, False))
            out[f"bits MB {kind}"] = _bits(torch.cat([d.reshape(-1) for d in fused_mlp_bwd(
                ws_, x_, g_, relu, none, cdt, soa, False)[0]]))
            out[f"MB {kind}"] = graph_ms(lambda: fused_mlp_bwd(ws_, x_, g_, relu, none, cdt,
                                                               soa, False))
            if cdt == torch.float32 and label != "config_oneblob":
                out[f"check {kind}"] = fp32_check(ws_, x_, g_, soa)

        # GB at the SDF step (surface points, fp32) and at config_btf (bf16),
        # GG and RS at the eikonal step's
        smodel = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
        sspec = smodel.network.encoding.spec
        slive = list(range(sspec.n_levels))
        stable = (torch.rand(sspec.n_params, generator=gen, device=dev) * 2 - 1)
        xs, xv = sdf.sample_points(gen, BATCH, dev)
        sdc = torch.randn((sspec.n_output_dims, BATCH), generator=gen, device=dev)
        out["G sdf"] = graph_ms(lambda: grid_encode_fwd(sspec, stable, xs, slive, soa=True))
        out["bits G sdf"] = _bits(grid_encode_fwd(sspec, stable, xs, slive, soa=True))
        out["GB sdf"] = graph_ms(lambda: grid_encode_bwd(sspec, stable, xs, sdc, slive))
        ddx = torch.randn((BATCH, 3), generator=gen, device=dev)
        out["GI sdf"] = graph_ms(lambda: grid_encode_bwd_input(sspec, stable, xv, sdc, slive))
        out["GG sdf"] = graph_ms(lambda: grid_encode_bwd_bwd(sspec, stable, xv, sdc, ddx, slive))
        out["second order sdf"] = graph_ms(lambda: GridBwdBwdFunction.forward(
            stable, xv, sdc, ddx, sspec, tuple(slive), True, True, True, None))
        n14 = 1 << 14
        out["GG sdf 2^14"] = graph_ms(lambda: grid_encode_bwd_bwd(
            sspec, stable, xv[:n14], sdc[:, :n14], ddx[:n14], slive))
        out["second order sdf 2^14"] = graph_ms(lambda: GridBwdBwdFunction.forward(
            stable, xv[:n14], sdc[:, :n14], ddx[:n14], sspec, tuple(slive), True, True, True,
            None))
        half = stable[:sspec.n_params // 2].clone()   # shard 0's size (the bits are not read)
        out["GG sdf 2^14 shard"] = graph_ms(lambda: grid_encode_bwd_bwd(
            sspec, half, xv[:n14], sdc[:, :n14], ddx[:n14], slive, shard=(0, 2)))
        out["bits GI sdf"] = _bits(grid_encode_bwd_input(sspec, stable, xv, sdc, slive))
        # GI on a bf16 table and cotangent, and under a per-sample level mask
        hb, hdc = stable.to(torch.bfloat16), sdc.to(torch.bfloat16)
        frac = torch.rand(BATCH, generator=gen, device=dev)
        out["GI sdf bf16"] = graph_ms(lambda: grid_encode_bwd_input(sspec, hb, xv, hdc, slive))
        out["bits GI sdf bf16"] = _bits(grid_encode_bwd_input(sspec, hb, xv, hdc, slive))
        out["GI sdf masked"] = graph_ms(lambda: grid_encode_bwd_input(
            sspec, stable, xv, sdc, slive, level_frac=frac))
        out["bits GI sdf masked"] = _bits(grid_encode_bwd_input(sspec, stable, xv, sdc, slive,
                                                                level_frac=frac))
        gg = grid_encode_bwd_bwd(sspec, stable, xv, sdc, ddx, slive)
        out["bits GG d_dcols sdf"] = _bits(gg.d_dcols)
        out["bits GG d_x sdf"] = _bits(gg.d_x)
        rows, g = _gg_updates(sspec, stable, xv, sdc, ddx, slive)
        out["RS sdf"] = graph_ms(lambda: row_scatter_add(rows, g, sspec.n_entries))
        # GT at the curvature step's shape (v, β ~ N(0, 1)): all outputs, the
        # step's (no d_x), 2^14, a mask at 0.5 and shard 0 of 2 at 2^14
        beta = torch.randn((BATCH, 3), generator=gen, device=dev)
        gt_args = (sspec, stable, xv, sdc, ddx, beta, slive)
        g14 = (xv[:n14], sdc[:, :n14], ddx[:n14], beta[:n14], slive)
        mid = torch.full((BATCH,), 0.5, device=dev)
        out["GT sdf"] = graph_ms(lambda: grid_encode_third(*gt_args))
        out["GT sdf step outputs"] = graph_ms(lambda: grid_encode_third(*gt_args, need_x=False))
        out["GT sdf 2^14"] = graph_ms(lambda: grid_encode_third(sspec, stable, *g14))
        out["GT sdf masked"] = graph_ms(lambda: grid_encode_third(*gt_args, level_frac=mid))
        out["GT sdf 2^14 shard"] = graph_ms(lambda: grid_encode_third(sspec, half, *g14,
                                                                      shard=(0, 2)))
        gt = grid_encode_third(*gt_args)
        out["bits GT d_dcols sdf"] = _bits(gt.d_dcols)
        out["bits GT d_x sdf"] = _bits(gt.d_x)
        btf = create_from_config(6, 3, str(Path(config).parent / "config_btf.json"),
                                 policy=BF16_POLICY)
        bspec = btf.network.encoding.nested[0].spec
        blive = list(range(bspec.n_levels))
        btable = torch.zeros(bspec.n_params, dtype=torch.bfloat16, device=dev)
        bx = torch.rand((BATCH, 6), generator=gen, device=dev)[:, :4]
        gtable = (torch.rand(bspec.n_params, generator=gen, device=dev) * 2 - 1).to(btable.dtype)
        out["G config_btf"] = graph_ms(lambda: grid_encode_fwd(bspec, gtable, bx, blive))
        out["bits G config_btf"] = _bits(grid_encode_fwd(bspec, gtable, bx, blive))
        bdc = torch.randn((BATCH, 40), generator=gen, device=dev).to(torch.bfloat16)
        bdc = bdc[:, :bspec.n_output_dims].t()
        out["GB config_btf"] = graph_ms(lambda: grid_encode_bwd(bspec, btable, bx, bdc, blive))
        if full:
            for lv in blive:
                level = bspec.levels[lv]
                out[f"G config_btf level {lv} ({level.size} rows, "
                    f"{'hashed' if level.use_hash else 'dense'})"] = graph_ms(
                        lambda: grid_encode_fwd(bspec, gtable, bx, [lv]))
            out["GB no level"] = graph_ms(lambda: grid_encode_bwd(spec, table, x, dfeats, []))
            for lv in live:
                level = spec.levels[lv]
                out[f"GB level {lv} ({level.size} rows, "
                    f"{'hashed' if level.use_hash else 'dense'})"] = graph_ms(
                        lambda: grid_encode_bwd(spec, table, x, dfeats, [lv]))
    return out


def _gg_updates(spec, table, x, dcols, ddx, live):
    """GG's table-gradient updates as (rows, g), kernel RS's input at the
    eikonal step's layout: ``plain_path.gg_rows_and_g``, or in a checkout
    from before GG added them itself (``--baseline``), its kernel's own."""
    try:
        from tcnn_tpu_torch.tools.plain_path import gg_rows_and_g
    except ImportError:
        from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd_bwd

        bb = grid_encode_bwd_bwd(spec, table, x, dcols, ddx, live, need_dcols=False,
                                 need_x=False)
        return bb.rows, bb.g
    return gg_rows_and_g(spec, x, dcols, ddx, live)


def fp32_check(ws, x, g, soa: bool) -> str:
    """Kernels M and MB in fp32 against their plain versions (TF32 off), at
    the tolerances of ``chip_smoke.py``: M's output within rtol 1e-5 and
    atol 1e-5; each dW of MB within 1e-4 of its largest magnitude; dx rows
    beyond 1e-4 of its largest magnitude, with the number of them that a
    ReLU switched within 2^-16 of Σ|h·w| of 0 explains
    (``tools.plain_path.relu_flip_rows``).  Errors are given as a share of
    the tolerance: above 1 fails."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.tools.plain_path import relu_flip_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    f32, args = torch.float32, (Activation.RELU, Activation.NONE, torch.float32)
    y, want = fused_mlp_fwd(ws, x, *args, f32, soa, False), fused_mlp_plain(ws, x, *args, f32,
                                                                           soa, False)
    m_err = ((y - want).abs() / (1e-5 + 1e-5 * want.abs())).max().item()
    (dws, dx), (want_dws, want_dx) = (f(ws, x, g, *args, soa, False)
                                      for f in (fused_mlp_bwd, fused_mlp_bwd_plain))
    dw_err = max(((a - b).abs().max() / (1e-4 * b.abs().max())).item()
                 for a, b in zip(dws, want_dws))
    a, b = (dx.t(), want_dx.t()) if soa else (dx, want_dx)
    tol = 1e-4 * b.abs().max().item()
    rows = ((a - b).abs() > tol).any(dim=1).nonzero().flatten()
    explained = (int(relu_flip_rows(ws, x, g, Activation.NONE, f32, rows, a[rows], tol,
                                    soa)[0].sum()) if rows.numel() else 0)
    return (f"M err/tol {m_err:.3f}, MB dW err/tol {dw_err:.3f}, dx rows beyond tol "
            f"{rows.numel()} of {a.shape[0]} ({explained} explained by a switched ReLU)")


def _plan_atomics(plan, level: int, offset: int, rows, nonzero, F: int) -> int:
    """Global atomics that the items of ``plan`` on ``level`` issue, given
    the (C, B) table rows of its corners and where their updates are
    nonzero: a window item one per row its samples' updates touch; a direct
    item one per corner of nonzero update, one float4 for two dim-0
    neighbours on rows r, r + 1 with r even (F = 2)."""
    n = 0
    for _, lo, n_rows, b0, b1 in plan.items[plan.items[:, 0] == level].tolist():
        r, ok = rows[:, b0:b1] - offset, nonzero[:, b0:b1]
        if n_rows:
            ok = ok & (r >= lo) & (r < lo + n_rows)
            n += int(torch.unique(r[ok]).numel())
        elif F == 2:   # pairs of corners c, c + 1 (dim 0)
            r0, r1 = r[0::2], r[1::2]
            pair = (r1 == r0 + 1) & (r0 % 2 == 0) & (ok[0::2] | ok[1::2])
            n += int(pair.sum()) + int((ok[0::2] & ~pair).sum()) + int((ok[1::2] & ~pair).sum())
        else:
            n += int(ok.sum())
    return n


def atomic_counts(batch: int = BATCH, seed: int = 0) -> dict:
    """Global atomics of one launch of GB (config_hash, the SDF step's
    surface points, config_btf), of RS (the eikonal step's (rows, g)) and
    of GT (the SDF grid at the volume points, all outputs), counted from
    the kernels' code on inputs drawn as ``chip_smoke.py`` draws them: each
    a float2 (float4 at F = 4, scalar at F = 1, as ``scatter_vec``) unless
    said otherwise.

      GB, the design before this one (one thread per sample and level):
        a level of at most 4096 values was summed per 4096-sample chunk in
        shared memory and flushed with one scalar atomic per nonzero value;
        any other level took one atomic per corner of nonzero weight.
      GB now (``gb_plan``): a window item flushes one atomic per row that
        its samples touched; a direct item one per corner, one float4 for
        two dim-0 neighbours on rows r, r + 1 with r even (F = 2).
      RS before: one atomic per update; now: per chunk of 8192 updates
        (csrc/row_scatter.cu) one per distinct row where the chunk's row
        range fits the 96 KB window, else one per update.
      GT before (one thread per (sample, level) over a grid of levels): one
        per corner of nonzero u; now on ``gb_plan`` with GG's chunks, as GB
        now, for the corners of nonzero u."""
    import torch

    from ..ops.cuda.grid_encode import gb_plan, gg_chunks
    from ..ops.grid_ops import build_indices_weights
    from .. import Policy, create_from_config
    from ..samples import fit_sdf_eikonal as sdf

    gen = torch.Generator().manual_seed(seed)
    configs = _PKG.parent / "configs"
    cases = {
        "config_hash": (create_from_config(2, 3, str(configs / "config_hash.json"),
                                           device="cpu").network.encoding.spec,
                        torch.rand((batch, 2), generator=gen)),
        "sdf": (create_from_config(3, 1, sdf.CONFIG, policy=Policy(),
                                   device="cpu").network.encoding.spec,
                sdf.sample_points(gen, batch, "cpu")[0]),
        "config_btf": (create_from_config(6, 3, str(configs / "config_btf.json"),
                                          device="cpu").network.encoding.nested[0].spec,
                       torch.rand((batch, 4), generator=gen)),
    }
    out = {}
    for name, (spec, x) in cases.items():
        F, C = spec.n_features_per_level, 1 << spec.n_dims
        before = after = 0
        plan = gb_plan(spec, list(range(spec.n_levels)), batch)
        for li, lv in enumerate(spec.levels):
            idx, ws = build_indices_weights(spec, x, [li])
            rows, live = idx.reshape(C, batch), ws.reshape(C, batch) != 0
            if lv.size * F <= 4096:
                for b0 in range(0, batch, 4096):
                    before += F * int(torch.unique(rows[:, b0:b0 + 4096][live[:, b0:b0 + 4096]]).numel())
            else:
                before += int(live.sum()) * max(1, F // 4 if F % 4 == 0 else F // 2 if F % 2 == 0 else F)
            after += _plan_atomics(plan, li, lv.offset, rows, live, F)
            del idx, ws, rows, live
        out[f"GB {name}"] = (before, after)
    # RS on GG's level-major rows at the SDF grid (x_vol)
    spec, _ = cases["sdf"]
    xv = sdf.sample_points(torch.Generator().manual_seed(seed + 1), batch, "cpu")[1]
    idx, _ = build_indices_weights(spec, xv, list(range(spec.n_levels)))
    rows = idx.reshape(-1)
    after = 0
    for i0 in range(0, rows.numel(), 8192):
        r = rows[i0:i0 + 8192]
        span = int(r.max() - r.min() + 1)
        after += int(torch.unique(r).numel()) if span * 2 <= 96 * 1024 // 4 else r.numel()
    out["RS sdf"] = (rows.numel(), after)
    # GT at the SDF grid on the volume points, v and β ~ N(0, 1)
    C, F = 1 << spec.n_dims, spec.n_features_per_level
    v, beta = (torch.randn((batch, spec.n_dims), generator=gen) for _ in range(2))
    plan = gb_plan(spec, list(range(spec.n_levels)), batch, chunks=gg_chunks(batch))
    before = after = 0
    for li, lv in enumerate(spec.levels):
        idx, _, _, d2ws = build_indices_weights(spec, xv, [li], order=2)
        u = torch.einsum("nbde,bd,be->nb", d2ws, beta, v)
        rows, nonzero = idx.reshape(C, batch), u != 0
        before += int(nonzero.sum()) * max(1, F // 2 if F % 2 == 0 else F)
        after += _plan_atomics(plan, li, lv.offset, rows, nonzero, F)
        del idx, d2ws, u, rows, nonzero
    out["GT sdf"] = (before, after)
    return out


WARP = 32
PAIR_ROW_BYTES = (2, 4, 8)   # the rows _g_pair_loads pairs (its unit_rows)


def _distinct_per_warp(sectors: torch.Tensor, valid: torch.Tensor) -> int:
    """Σ over (load, warp) of the distinct sectors the warp's lanes touch.
    sectors, valid: (K, B, n) per load k, sample b (a lane) and the n
    sectors one lane's load touches; a warp is 32 consecutive samples."""
    K, B, n = sectors.shape
    pad = (-B) % WARP
    sec = torch.where(valid, sectors, torch.full_like(sectors, -1))
    sec = torch.nn.functional.pad(sec, (0, 0, 0, pad), value=-1).reshape(K, -1, WARP * n)
    sec = sec.sort(dim=-1).values
    new = torch.ones_like(sec, dtype=torch.bool)
    new[..., 1:] = sec[..., 1:] != sec[..., :-1]
    return int((new & (sec >= 0)).sum())


def table_sectors(rows: torch.Tensor, row_bytes: int, paired: bool) -> int:
    """The 32-byte table sectors that kernel G's loads of one level request,
    counted per warp-wide load (32 consecutive samples; a sector that
    several lanes of one load touch counts once).  rows: (2^D, B) flat
    table rows, corner c on row c (corners c and c ^ 1 differ in dim 0
    only); row_bytes: F times the table's element size.

    One load per corner (``paired`` false, or rows of other sizes than 2,
    4 and 8 bytes): a row's sectors (two where it straddles a boundary).
    Pair loads (the ablation ``g_pair_loads``): per pair of corners
    2p, 2p + 1, one 16-byte load of the unit holding row 2p, and one load
    of row 2p + 1 by the lanes where it lies in another unit."""
    r = rows.long()
    if not paired or row_bytes not in PAIR_ROW_BYTES:
        lo, hi = r * row_bytes // 32, (r * row_bytes + row_bytes - 1) // 32
        return _distinct_per_warp(torch.stack([lo, hi], -1),
                                  torch.stack([torch.ones_like(lo, dtype=torch.bool),
                                               hi != lo], -1))
    per_unit = 16 // row_bytes
    r0, r1 = r[0::2], r[1::2]
    shared = r0 // per_unit == r1 // per_unit
    unit_sector = (r0 // per_unit * 16 // 32).unsqueeze(-1)
    lone_sector = (r1 * row_bytes // 32).unsqueeze(-1)
    return (_distinct_per_warp(unit_sector, torch.ones_like(unit_sector, dtype=torch.bool))
            + _distinct_per_warp(lone_sector, ~shared.unsqueeze(-1)))


def sector_counts(batch: int = BATCH, seed: int = 0) -> dict:
    """Table sectors of one launch of G at config_hash, config_btf and the
    SDF step (surface points), on inputs drawn as ``chip_smoke.py`` draws
    them and the tables' dtypes there (bf16, bf16, fp32): (one load per
    corner, as G loads them; with the pair loads of ``g_pair_loads``),
    ``table_sectors`` summed over the levels."""
    from ..ops.grid_ops import build_indices_weights
    from .. import Policy, create_from_config
    from ..samples import fit_sdf_eikonal as sdf

    gen = torch.Generator().manual_seed(seed)
    configs = _PKG.parent / "configs"
    cases = {
        "config_hash": (create_from_config(2, 3, str(configs / "config_hash.json"),
                                           device="cpu").network.encoding.spec,
                        torch.rand((batch, 2), generator=gen), 2),
        "config_btf": (create_from_config(6, 3, str(configs / "config_btf.json"),
                                          device="cpu").network.encoding.nested[0].spec,
                       torch.rand((batch, 4), generator=gen), 2),
        "sdf": (create_from_config(3, 1, sdf.CONFIG, policy=Policy(),
                                   device="cpu").network.encoding.spec,
                sdf.sample_points(gen, batch, "cpu")[0], 4),
    }
    out = {}
    for name, (spec, x, elem) in cases.items():
        C, row_bytes = 1 << spec.n_dims, spec.n_features_per_level * elem
        before = after = 0
        for li in range(spec.n_levels):
            rows = build_indices_weights(spec, x, [li])[0].reshape(C, batch)
            before += table_sectors(rows, row_bytes, paired=False)
            after += table_sectors(rows, row_bytes, paired=True)
        out[f"G {name}"] = (before, after)
    return out


STEP_PARTS = ("G", "M", "table copy", "loss", "MB", "GB", "Adam")   # chip_smoke.py's split


def host_ms(fn, n=100, warmup=3) -> dict:
    """The host's share of one call of fn(), each call started with the
    card idle (the launch queue never fills, and no wait for the card is
    counted unless fn() itself waits): the wall time until the call
    returns, and the time from its start to the end of its device work
    (CUDA events), the median and the least of each over n calls.  On a
    host shared with other loads the least is the call's own cost and the
    medians spread with the load (process CPU time, where the kernel counts
    it in 10 ms ticks, is too coarse for one call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    wall, whole = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        w0 = time.perf_counter()
        fn()
        wall.append((time.perf_counter() - w0) * 1e3)
        end.record()
        end.synchronize()
        whole.append(start.elapsed_time(end))
    return {"host wall": statistics.median(wall), "host wall min": min(wall),
            "eager min": min(whole)}


def time_steps() -> dict:
    """The whole steps ``chip_smoke.py`` times, by its own timing code
    (loaded from the checkout this file lies in), of the ``tcnn_tpu_torch``
    on ``sys.path``: config_hash's training step on the device and eager,
    its parts alone on the step's tensors (``slice_times``) and what the
    step holds beyond them, make_training_loop per step; the SDF eikonal
    step and the curvature step on the device and eager, and the eikonal
    step's peak memory; the host's share of the three steps (``host_ms``).  Inputs from seed 0,
    as chip_smoke.py draws them."""
    import importlib.util

    from tcnn_tpu_torch import BF16_POLICY, Policy, create_from_config
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image

    spec = importlib.util.spec_from_file_location("chip_smoke", _PKG.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    config = str(_PKG.parent / "configs" / "config_hash.json")
    model = create_from_config(2, 3, config, policy=BF16_POLICY)
    with torch.no_grad():
        model.network.encoding.grid.uniform_(-1, 1, generator=gen)
    x = torch.rand((BATCH, 2), generator=gen, device=dev)
    target = torch.rand((BATCH, 3), generator=gen, device=dev)
    fit = create_from_config(2, 3, config, policy=BF16_POLICY)
    sampler = ImageSampler(synthetic_image(1024, 1024), seed=0)
    loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(BATCH),
                                          smoke.LOOP_STEPS)
    loop()   # captures the step, as chip_smoke.py's fit has before its timed calls
    t = smoke.slice_times("config_hash", model, x, target, loop)
    out = {f"config_hash {k}": t[k] for k in ("step device", "step", "loop step") + STEP_PARTS}
    out["config_hash rest"] = t["step device"] - sum(t[k] for k in STEP_PARTS)
    out.update({f"config_hash step {k}": v
                for k, v in host_ms(lambda: model.trainer.training_step(x, target)).items()})

    sdf_model = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
    net, opt = sdf_model.network, sdf_model.optimizer
    with torch.no_grad():
        net.encoding.grid.uniform_(-1, 1, generator=gen)
    xs, xv = sdf.sample_points(gen, BATCH, dev)
    opt_state = opt.init(dict(net.named_parameters()), net.param_layout())

    def step():
        return sdf.step(net, opt, opt_state, xs, xv)

    out["sdf step"] = smoke.time_ms(step)
    out["sdf step device"] = smoke.graph_ms(step)
    out.update({f"sdf step {k}": v for k, v in host_ms(step).items()})
    v = sdf.sample_directions(gen, BATCH, dev)
    curvature_state = opt.init(dict(net.named_parameters()), net.param_layout())

    def curvature_step():
        _, grads = sdf.curvature_loss_and_grads(net, xs, xv, v)
        opt.step(curvature_state, grads, dict(net.named_parameters()))

    out["curvature step"] = smoke.time_ms(curvature_step, n=10)
    out["curvature step device"] = smoke.graph_ms(curvature_step, n=5)
    out.update({f"curvature step {k}": v for k, v in host_ms(curvature_step, n=30).items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    out["sdf step peak MB"] = (torch.cuda.max_memory_allocated() - base) / 1e6
    # where that peak lies: what the step holds when it calls the grid's
    # second order (GridBwdBwdFunction.forward: GG, and RS where the
    # checkout has it), and the peak inside that call
    from tcnn_tpu_torch.ops.grid_ops import GridBwdBwdFunction

    forward, seen = GridBwdBwdFunction.forward, {}

    def traced(*args, **kw):
        torch.cuda.synchronize()
        seen["held"] = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        res = forward(*args, **kw)
        torch.cuda.synchronize()
        seen["peak"] = torch.cuda.max_memory_allocated() - base
        return res

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    GridBwdBwdFunction.forward = staticmethod(traced)
    try:
        step()
    finally:
        GridBwdBwdFunction.forward = staticmethod(forward)
    out["sdf step held at the second order MB"] = seen["held"] / 1e6
    out["sdf step peak in the second order MB"] = seen["peak"] / 1e6
    out["second order's own peak MB"] = (seen["peak"] - seen["held"]) / 1e6
    return out


def step_order(rounds: int) -> list:
    """The order of ``--steps``'s runs: baseline, tree, tree, baseline, ...
    so that each side runs as often first as second in a pair."""
    return [side for r in range(rounds)
            for side in (("baseline", "tree") if r % 2 == 0 else ("tree", "baseline"))]


def compare_steps(rounds: int, baseline: Path, smi: str) -> None:
    """``time_steps`` of this checkout ("tree") and of ``baseline`` in
    turn (``step_order``), each run in a process of its own, and the
    median of each number per side."""
    roots = {"tree": _PKG.parent, "baseline": baseline}
    builds = {side: _run(root, "build", side) for side, root in roots.items()}
    failed = [side for side, proc in builds.items() if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"steps: build of {', '.join(failed)} failed")
    order = step_order(rounds)
    print(f"# {smi}; ms at B = {BATCH}; runs in the order {', '.join(order)}", flush=True)
    runs = {side: [] for side in roots}
    for i, side in enumerate(order):
        proc = _run(roots[side], "steps", stdout=subprocess.PIPE, text=True)
        stdout, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"steps: run {i} ({side}) failed:\n{stdout[-4000:]}")
        times = json.loads(stdout.strip().splitlines()[-1])
        runs[side].append(times)
        print(f"run {i} {side}: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()),
              flush=True)
    for k in runs["tree"][0]:
        med = {side: statistics.median(r[k] for r in runs[side]) for side in runs}
        unit = "MB" if k.startswith(("sdf step ", "second order")) and k.endswith(" MB") else "ms"
        rel = f"{med['tree'] / med['baseline'] - 1:+.2%}" if med["baseline"] else "n/a"
        lower = sum(t[k] < b[k] for t, b in zip(runs["tree"], runs["baseline"]))
        print(f"median of {rounds}: {k}: tree {med['tree']:.4f} {unit}, baseline "
              f"{med['baseline']:.4f} {unit} ({rel}; tree lower in {lower} of {rounds} rounds)",
              flush=True)


def _copy(out_dir: Path, name: str, patches) -> Path:
    root = out_dir / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, root / "tcnn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in patches:
        src = (root / "tcnn_tpu_torch" / "csrc" / fname).resolve()
        text = src.read_text()
        if old not in text:
            raise RuntimeError(f"ablation {name}: {old!r} not in {fname}")
        src.write_text(text.replace(old, new))
    return root


def _run(root: Path, *args: str, **kw):
    """This file's ``_child`` in a process whose ``tcnn_tpu_torch`` is the
    one under ``root`` (this file is loaded by its path, so that a
    baseline checkout is timed by this timing code)."""
    code = ("import sys, importlib.util as u; sys.path.insert(0, sys.argv[1]); "
            "spec = u.spec_from_file_location('kernel_ablation_tool', sys.argv[2]); "
            "m = u.module_from_spec(spec); spec.loader.exec_module(m); m._child(sys.argv[3:])")
    return subprocess.Popen([sys.executable, "-c", code, str(root), __file__, *args], **kw)


def _build_seconds() -> float:
    """Seconds the build of the ``tcnn_tpu_torch`` on ``sys.path`` takes."""
    from tcnn_tpu_torch.ops.cuda import kernels

    t0 = time.perf_counter()
    kernels()
    return time.perf_counter() - t0


def _child(args) -> None:
    if args[0] == "build":
        print(f"{args[1]}: build {_build_seconds():.1f} s", flush=True)
    elif args[0] == "steps":
        print(json.dumps(time_steps()))
    else:
        print(json.dumps(time_kernels(args[1], full=False)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(_PKG.parent / "build" / "ablations"))
    parser.add_argument("--only", nargs="*", default=None,
                        help="run the ablations whose names start with one of these")
    parser.add_argument("--baseline", default=None,
                        help="a checkout whose tcnn_tpu_torch is timed as 'baseline'")
    parser.add_argument("--atomics", action="store_true",
                        help="count GB's, RS's and GT's global atomics on the CPU and stop")
    parser.add_argument("--sectors", action="store_true",
                        help="count G's table sectors on the CPU and stop")
    parser.add_argument("--steps", type=int, default=0, metavar="ROUNDS",
                        help="time chip_smoke.py's config_hash and SDF steps of the tree "
                             "and --baseline in turn, ROUNDS pairs, and stop")
    args = parser.parse_args()
    if args.atomics:
        for what, (before, after) in atomic_counts().items():
            print(f"{what}: {before} global atomics per launch before, {after} now "
                  f"(B = {BATCH}, atomic_counts)")
        return
    if args.sectors:
        for what, (before, after) in sector_counts().items():
            print(f"{what}: {before} table sectors per launch, one load per corner; {after} "
                  f"with dim-0 pair loads (B = {BATCH}, sector_counts)")
        return
    if not torch.cuda.is_available():
        sys.exit("kernel_ablation: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.baseline and not (Path(args.baseline) / "tcnn_tpu_torch").is_dir():
        sys.exit(f"kernel_ablation: no tcnn_tpu_torch under {args.baseline}")
    if args.steps:
        if not args.baseline:
            sys.exit("kernel_ablation: --steps needs --baseline")
        compare_steps(args.steps, Path(args.baseline).resolve(), smi)
        return
    config = str(_PKG.parent / "configs" / "config_hash.json")
    out_dir = Path(args.out)
    roots = {name: _copy(out_dir, name, patches) for name, patches in ABLATIONS.items()
             if args.only is None or name.startswith(tuple(args.only))}
    if args.baseline:
        roots = {"baseline": Path(args.baseline).resolve(), **roots}
    builds = {name: _run(root, "build", name) for name, root in roots.items()}
    print(f"# {smi}; device ms per call at B = {BATCH}: config_hash at BF16_POLICY unless "
          f"labelled", flush=True)
    print(f"tree: build {_build_seconds():.1f} s (at once with the others' builds)", flush=True)

    def show(variant, times):
        for what, v in times.items():
            print(f"{variant}: {what}: {v:.4f} ms" if isinstance(v, float) else
                  f"{variant}: {what}: {v}", flush=True)
        return times

    tree = show("tree", time_kernels(config, full=True))   # builds the others meanwhile
    failed = []
    for name, root in roots.items():
        if builds[name].wait() != 0:
            failed.append(f"{name} (build)")
            continue
        proc = _run(root, "time", config, stdout=subprocess.PIPE, text=True)
        stdout, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (timing)")
            continue
        times = show(name, json.loads(stdout.strip().splitlines()[-1]))
        if name == "baseline":
            for what, v in tree.items():
                if what.startswith("bits "):
                    print(f"tree vs baseline: {what[5:]}: "
                          f"{'the same bits' if times.get(what) == v else 'different bits'}",
                          flush=True)
    if failed:
        raise RuntimeError(f"ablations failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()

"""Where the time of kernels GB, RS, M and MB goes, on the card.

    python3 -m tcnn_tpu_torch.tools.kernel_ablation [--out DIR] [--only PREFIX ...]
    python3 -m tcnn_tpu_torch.tools.kernel_ablation --atomics   # no card needed

At B = 2^18 with random inputs from a seed it times, as device time in a
CUDA graph of 30 calls:
  * GB, M and MB at the config_hash shapes (BF16_POLICY), M and MB in fp32
    at the SDF sample's MLP (16 -> 64 x 2 -> 1) and at config_hash's
    (32 -> 64 x 2 -> 3), SoA input, in bf16 at config_btf's
    (40 -> 64 x 3 -> 3, AoS input), and in both dtypes at
    config_oneblob's (128 -> 128 x 5 -> 3, AoS input);
  * GB at the SDF step's shape (3-D, fp32 table, surface points) and at
    config_btf's (4-D CoherentAdd, 2^19-row levels, bf16 table), and RS
    on the eikonal step's (rows, g) from kernel GG;
  * GB over no level (its zeroing and cast) and one level at a time;
  * the same kernels in ablated copies of the package: ``DIR/<name>``
    holds a copy of ``tcnn_tpu_torch`` with one source patch
    (``ABLATIONS``; ``--only`` keeps those whose names start with a
    prefix given), built in its own process, all copies at once.  An
    ablated kernel may compute a wrong result by design; only its time is
    read, and for the fp32 MLPs it is checked (``fp32_check``) at the
    tolerances of ``chip_smoke.py``.
Every number is printed beside the card's name and power limit.  Needs
one CUDA device; DIR defaults to ``build/ablations`` at the checkout's
root.  ``--atomics`` instead counts, on the CPU, the global atomics one
launch of GB and of RS issues at B = 2^18 on the inputs ``chip_smoke.py``
times them on, in this design and in the one before it (``atomic_counts``).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]

_FAST = "  return a.act <= 1 && a.out_act <= 1;"

_GB_PLAN = "../ops/cuda/grid_encode.py"

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
    # GB's direct path without its 16-byte atomics for dim-0 pairs.
    "gb_no_pair_atomics": [("grid_encode_bwd.cu", "if (r1 == r0 + 1 && (r0 & 1) == 0) {",
                            "if (false) {")],
    # Every grid row folded into the first 2^20 (8 MB of fp32 at F = 2):
    # GB's direct atomics at config_btf then land in a buffer that the
    # 50 MB L2 holds, the same number of them at the same rate of
    # issue.  If config_btf's GB runs much faster so, the 62 MB buffer's
    # misses in L2 set its pace; if not, the atomics' rate does.  (Results
    # wrong by design.)
    "gb_btf_l2_resident": [("grid_common.cuh", "    return fastmod(h, magic, size) + offset;",
                            "    return (fastmod(h, magic, size) + offset) & 0xFFFFFu;")],
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


def time_kernels(config: str, full: bool) -> dict:
    """Times GB, M and MB of the ``tcnn_tpu_torch`` on ``sys.path``."""
    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch import Policy
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_fwd
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_bwd_bwd,
                                                     grid_encode_fwd)
    from tcnn_tpu_torch.ops.cuda.scatter import row_scatter_add
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
        out["GB"] = graph_ms(lambda: grid_encode_bwd(spec, table, x, dfeats, live))
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
            out[f"MB {kind}"] = graph_ms(lambda: fused_mlp_bwd(ws_, x_, g_, relu, none, cdt,
                                                               soa, False))
            if cdt == torch.float32 and label != "config_oneblob":
                out[f"check {kind}"] = fp32_check(ws_, x_, g_, soa)

        # GB at the SDF step (surface points, fp32) and at config_btf (bf16),
        # RS on the eikonal step's (rows, g)
        smodel = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
        sspec = smodel.network.encoding.spec
        slive = list(range(sspec.n_levels))
        stable = (torch.rand(sspec.n_params, generator=gen, device=dev) * 2 - 1)
        xs, xv = sdf.sample_points(gen, BATCH, dev)
        sdc = torch.randn((sspec.n_output_dims, BATCH), generator=gen, device=dev)
        out["GB sdf"] = graph_ms(lambda: grid_encode_bwd(sspec, stable, xs, sdc, slive))
        ddx = torch.randn((BATCH, 3), generator=gen, device=dev)
        bb = grid_encode_bwd_bwd(sspec, stable, xv, sdc, ddx, slive, need_dcols=False,
                                 need_x=False)
        out["RS sdf"] = graph_ms(lambda: row_scatter_add(bb.rows, bb.g, sspec.n_entries))
        btf = create_from_config(6, 3, str(Path(config).parent / "config_btf.json"),
                                 policy=BF16_POLICY)
        bspec = btf.network.encoding.nested[0].spec
        blive = list(range(bspec.n_levels))
        btable = torch.zeros(bspec.n_params, dtype=torch.bfloat16, device=dev)
        bx = torch.rand((BATCH, 6), generator=gen, device=dev)[:, :4]
        bdc = torch.randn((BATCH, 40), generator=gen, device=dev).to(torch.bfloat16)
        bdc = bdc[:, :bspec.n_output_dims].t()
        out["GB config_btf"] = graph_ms(lambda: grid_encode_bwd(bspec, btable, bx, bdc, blive))
        if full:
            out["GB no level"] = graph_ms(lambda: grid_encode_bwd(spec, table, x, dfeats, []))
            for lv in live:
                level = spec.levels[lv]
                out[f"GB level {lv} ({level.size} rows, "
                    f"{'hashed' if level.use_hash else 'dense'})"] = graph_ms(
                        lambda: grid_encode_bwd(spec, table, x, dfeats, [lv]))
    return out


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


def atomic_counts(batch: int = BATCH, seed: int = 0) -> dict:
    """Global atomics of one launch of GB (config_hash, the SDF step's
    surface points, config_btf) and of RS (the eikonal step's (rows, g)),
    counted from the kernels' code on inputs drawn as ``chip_smoke.py``
    draws them: each a float2 (float4 at F = 4, scalar at F = 1, as
    ``scatter_vec``) unless said otherwise.

      GB, the design before this one (one thread per sample and level):
        a level of at most 4096 values was summed per 4096-sample chunk in
        shared memory and flushed with one scalar atomic per nonzero value;
        any other level took one atomic per corner of nonzero weight.
      GB now (``gb_plan``): a window item flushes one atomic per row that
        its samples touched; a direct item one per corner, one float4 for
        two dim-0 neighbours on rows r, r + 1 with r even (F = 2).
      RS before: one atomic per update; now: per chunk of 8192 updates
        (csrc/row_scatter.cu) one per distinct row where the chunk's row
        range fits the 96 KB window, else one per update."""
    import torch

    from ..ops.cuda.grid_encode import gb_plan
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
            for _, lo, n, b0, b1 in plan.items[plan.items[:, 0] == li].tolist():
                r, ok = rows[:, b0:b1] - lv.offset, live[:, b0:b1]
                if n:
                    ok = ok & (r >= lo) & (r < lo + n)
                    after += int(torch.unique(r[ok]).numel())
                elif F == 2:   # pairs of corners c, c + 1 (dim 0)
                    r0, r1 = r[0::2], r[1::2]
                    pair = (r1 == r0 + 1) & (r0 % 2 == 0) & (ok[0::2] | ok[1::2])
                    after += int(pair.sum()) + int((ok[0::2] & ~pair).sum()) + int(
                        (ok[1::2] & ~pair).sum())
                else:
                    after += int(ok.sum())
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
    return out


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
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tcnn_tpu_torch.tools.kernel_ablation import _child; _child(sys.argv[2:])")
    return subprocess.Popen([sys.executable, "-c", code, str(root), *args], **kw)


def _child(args) -> None:
    if args[0] == "build":
        from tcnn_tpu_torch.ops.cuda import kernels
        kernels()
    else:
        print(json.dumps(time_kernels(args[1], full=False)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(_PKG.parent / "build" / "ablations"))
    parser.add_argument("--only", nargs="*", default=None,
                        help="run the ablations whose names start with one of these")
    parser.add_argument("--atomics", action="store_true",
                        help="count GB's and RS's global atomics on the CPU and stop")
    args = parser.parse_args()
    if args.atomics:
        for what, (before, after) in atomic_counts().items():
            print(f"{what}: {before} global atomics per launch before, {after} now "
                  f"(B = {BATCH}, atomic_counts)")
        return
    if not torch.cuda.is_available():
        sys.exit("kernel_ablation: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    config = str(_PKG.parent / "configs" / "config_hash.json")
    out_dir = Path(args.out)
    roots = {name: _copy(out_dir, name, patches) for name, patches in ABLATIONS.items()
             if args.only is None or name.startswith(tuple(args.only))}
    builds = {name: _run(root, "build") for name, root in roots.items()}
    print(f"# {smi}; device ms per call at B = {BATCH}: config_hash at BF16_POLICY unless "
          f"labelled", flush=True)

    def show(variant, times):
        for what, v in times.items():
            print(f"{variant}: {what}: {v:.4f} ms" if isinstance(v, float) else
                  f"{variant}: {what}: {v}", flush=True)

    show("tree", time_kernels(config, full=True))   # builds the tree's kernels meanwhile
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
        show(name, json.loads(stdout.strip().splitlines()[-1]))
    if failed:
        raise RuntimeError(f"ablations failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()

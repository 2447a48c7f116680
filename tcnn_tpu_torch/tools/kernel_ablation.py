"""Where the time of kernels GB, M and MB goes, on the card.

    python3 -m tcnn_tpu_torch.tools.kernel_ablation [--out DIR]

At B = 2^18 with random inputs from a seed it times, as device time in a
CUDA graph of 30 calls:
  * GB, M and MB at the config_hash shapes (BF16_POLICY), M and MB in fp32
    at the SDF sample's MLP (16 -> 64 x 2 -> 1) and at config_hash's
    (32 -> 64 x 2 -> 3), SoA input, and in bf16 at config_btf's
    (40 -> 64 x 3 -> 3, AoS input);
  * GB over no level (its zeroing and cast) and one level at a time;
  * the same kernels in ablated copies of the package: ``DIR/<name>``
    holds a copy of ``tcnn_tpu_torch`` with one source patch
    (``ABLATIONS``), built in its own process, all copies at once.  An
    ablated kernel may compute a wrong result by design; only its time is
    read, and for the fp32 MLPs it is checked (``fp32_check``) at the
    tolerances of ``chip_smoke.py``.
Every number is printed beside the card's name and power limit.  Needs
one CUDA device; DIR defaults to ``build/ablations`` at the checkout's
root.
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

# name: [(source file, text, replacement)]
ABLATIONS = {
    # MB without its weight gradient (the dgrad chain and dx stay).
    "mb_no_wgrad": [("fused_mlp_bwd.cu", " wgrad_bf16(a,", " if (a.batch < 0) wgrad_bf16(a,"),
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
    "f32_wgrad_8x8": [("mlp_common.cuh", "template <bool kActA, bool kFast, int T = 4>",
                       "template <bool kActA, bool kFast, int T = 8>")],
    # GB with plain stores in place of its float2 atomics.
    "gb_plain_stores": [("grid_encode_bwd.cu",
                         "atomicAdd(reinterpret_cast<float2*>(p), make_float2(",
                         "*reinterpret_cast<float2*>(p) = (make_float2(")],
    # GB with every level on direct atomics (no shared-memory levels).
    "gb_no_shared_levels": [("grid_encode_bwd.cu",
                             "if (uint64_t(size) * F <= kSharedFloats) {", "if (false) {")],
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
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_fwd
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd, grid_encode_fwd

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
                ("config_btf", [(40, 64), (64, 64), (64, 64), (64, 3)], False, torch.bfloat16)):
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
            if cdt == torch.float32:
                out[f"check {kind}"] = fp32_check(ws_, x_, g_, soa)
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


def _copy(out_dir: Path, name: str, patches) -> Path:
    root = out_dir / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, root / "tcnn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in patches:
        src = root / "tcnn_tpu_torch" / "csrc" / fname
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ablation: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    config = str(_PKG.parent / "configs" / "config_hash.json")
    out_dir = Path(args.out)
    roots = {name: _copy(out_dir, name, patches) for name, patches in ABLATIONS.items()}
    builds = {name: _run(root, "build") for name, root in roots.items()}
    results = {"tree": time_kernels(config, full=True)}   # builds the tree's kernels meanwhile
    for name, proc in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"ablation {name}: build failed")
    for name, root in roots.items():
        proc = _run(root, "time", config, stdout=subprocess.PIPE, text=True)
        stdout, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name}: timing failed")
        results[name] = json.loads(stdout.strip().splitlines()[-1])
    print(f"# {smi}; device ms per call at B = {BATCH}: config_hash at BF16_POLICY unless "
          f"labelled")
    for variant, times in results.items():
        for what, v in times.items():
            print(f"{variant}: {what}: {v:.4f} ms" if isinstance(v, float) else
                  f"{variant}: {what}: {v}")


if __name__ == "__main__":
    main()

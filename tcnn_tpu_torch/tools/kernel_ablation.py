"""Where the time of kernels GB, M and MB goes, on the card.

    python3 -m tcnn_tpu_torch.tools.kernel_ablation [--out DIR]

At the config_hash shapes (B = 2^18, BF16_POLICY, random inputs from a
seed) it times, as device time in a CUDA graph of 30 calls:
  * GB, M and MB;
  * GB over no level (its zeroing and cast) and one level at a time;
  * MB at 1 to 4 persistent CTAs per SM;
  * GB, M and MB in ablated copies of the package: ``DIR/<name>`` holds a
    copy of ``tcnn_tpu_torch`` with one source patch (``ABLATIONS``),
    built in its own process, all copies at once.  An ablated kernel
    computes a wrong result by design; only its time is read.
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

# name: [(source file, text, replacement)]
ABLATIONS = {
    # MB without its weight gradient (the dgrad chain and dx stay).
    "mb_no_wgrad": [("fused_mlp_bwd.cu", " wgrad_bf16(a,", " if (a.batch < 0) wgrad_bf16(a,")],
    # M and MB with the switch over every activation inlined at each call
    # site, as first written, in place of inline None and ReLU, an
    # out-of-line call for the rest and MB's instance for None and ReLU.
    "mlp_switch_inlined": [
        ("fused_mlp_bwd.cu", "err = act <= 1 && out_act <= 1 ?", "err = false ?"),
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
    # through the inline None/ReLU test and the out-of-line call).
    "mb_no_fast_instance": [("fused_mlp_bwd.cu", "err = act <= 1 && out_act <= 1 ?",
                             "err = false ?")],
    # MB writing its per-CTA partial dW without reading it back.
    "mb_partial_store_only": [("fused_mlp_bwd.cu", "*p = first ? c : *p + c;", "*p = c;")],
    # GB with plain stores in place of its float2 atomics.
    "gb_plain_stores": [("grid_encode_bwd.cu",
                         "atomicAdd(reinterpret_cast<float2*>(p), make_float2(",
                         "*reinterpret_cast<float2*>(p) = (make_float2(")],
    # GB with every level on direct atomics (no shared-memory levels).
    "gb_no_shared_levels": [("grid_encode_bwd.cu", "if (size * F <= kSharedFloats) {",
                             "if (false) {")],
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
    """Times GB and MB of the ``tcnn_tpu_torch`` on ``sys.path``."""
    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.ops.cuda import fused_mlp as fm
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
        if full:
            out["GB no level"] = graph_ms(lambda: grid_encode_bwd(spec, table, x, dfeats, []))
            for lv in live:
                level = spec.levels[lv]
                out[f"GB level {lv} ({level.size} rows, "
                    f"{'hashed' if level.use_hash else 'dense'})"] = graph_ms(
                        lambda: grid_encode_bwd(spec, table, x, dfeats, [lv]))
            default = fm.CTAS_PER_SM
            for n in (1, 2, 3, 4):
                fm.CTAS_PER_SM = n
                out[f"MB at {n} CTAs per SM"] = graph_ms(lambda: fused_mlp_bwd(*mb_args))
            fm.CTAS_PER_SM = default
    return out


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
    print(f"# {smi}; device ms per call at B = {BATCH}, config_hash, BF16_POLICY")
    for variant, times in results.items():
        for what, ms in times.items():
            print(f"{variant}: {what}: {ms:.4f} ms")


if __name__ == "__main__":
    main()

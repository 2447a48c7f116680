#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tcnn_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, serves config_hash
requests through ``model.trainer.inference`` (the port's main path),
times the kernels and the whole inference, and prints:

    ... one line per phase ...
    {"kernels": [...]}                       per-kernel numbers
    <name>, <power limit>                    as nvidia-smi gives them
    {"ok": true, "device": {...}}            last line

Any failure raises, so the exit code is nonzero and the last line is
missing.  It needs one CUDA device and fails without one.  It imports
nothing of JAX and nothing of the JAX package ``tcnn_tpu``.

Tolerances (the plain version runs on the same tensors on the card,
with TF32 off):
  * grid encode, float32 table: |d| <= 1e-5·|ref| + 1e-6 (fp32 corner
    sum in another order); bfloat16 table: |d| <= one bf16 ulp of ref.
  * fused MLP, float32: rtol 1e-5, atol 1e-5; bfloat16: rtol 2e-2,
    atol 2e-3 (a hidden activation may round to the other bf16
    neighbour when the sum is taken in another order).
  * whole model: the bfloat16 MLP tolerance, on O(1) outputs.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = "configs/config_hash.json"
MAIN_BATCH = 1 << 18
REQUESTS = (1 << 18, 1 << 16, 12345, 1)
N_TIMED = 30
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, fp32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name}", flush=True)


def bf16_ulp(t):
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare(got, want, kind):
    """(max abs err, max rel err); raises beyond the stated tolerance."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kind}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{kind}: non-finite output")
    err = (g - w).abs()
    if kind == "grid-bf16":
        bad = err > bf16_ulp(w)
    elif kind == "grid-f32":
        bad = err > 1e-5 * w.abs() + 1e-6
    elif kind == "mlp-f32":
        bad = err > 1e-5 * w.abs() + 1e-5
    else:  # mlp-bf16, model
        bad = err > 2e-2 * w.abs() + 2e-3
    rel = (err / w.abs().clamp_min(1e-6)).max().item()
    check(not bool(bad.any()), f"{kind}: {int(bad.sum())} elements beyond "
          f"tolerance, max abs err {err.max().item():.3e}")
    return err.max().item(), rel


def time_ms(fn, n=N_TIMED, warmup=5):
    """Median time of one call of fn(), host work included: CUDA events
    around each call, n calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def eager_ms(fn, n=10, reps=3):
    """Time per call of n back-to-back calls between two CUDA events,
    median of reps (for work that cannot be captured in a graph)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def graph_ms(fn, n=N_TIMED, reps=5):
    """Device time per call: n calls captured in one CUDA graph, replayed
    reps times between CUDA events (no host work inside), median."""
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
    return float(np.median(times))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from tcnn_tpu_torch import BF16_POLICY, DEFAULT_POLICY, create_from_config
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda import kernels
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_fwd, fused_mlp_plain
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_fwd,
                                                     grid_encode_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    phase("build")
    t0 = time.time()
    kernels()
    print(f"kernels built from tcnn_tpu_torch/csrc in {time.time() - t0:.1f} s")

    # The main path's model: config_hash at full width.  A trained table
    # holds O(1) features; the U(±1e-4) init would put every error below
    # any tolerance, so the table is redrawn U(±1) from the seed.
    model = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    enc, net = model.network.encoding, model.network.network
    with torch.no_grad():
        enc.grid.uniform_(-1, 1, generator=gen)
    spec = enc.spec
    live = list(range(spec.n_levels))

    phase("grid encode (G) vs plain, config_hash geometry")
    g_err = 0.0
    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        x = torch.rand((batch, 2), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            table = enc.grid.detach().to(dtype)
            for soa in (True, False):
                with torch.inference_mode():
                    got = grid_encode_fwd(spec, table, x, live, soa=soa)
                    torch.cuda.synchronize()
                    want = grid_encode_plain(spec, table, x, live, soa=soa)
                kind_ = "grid-bf16" if dtype == torch.bfloat16 else "grid-f32"
                abs_err, rel_err = compare(got, want, kind_)
                g_err = max(g_err, abs_err)
                print(f"B={batch} table={str(dtype)[6:]} {'SoA' if soa else 'AoS'}: "
                      f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
                      f"({'one bf16 ulp' if dtype == torch.bfloat16 else 'rtol 1e-5, atol 1e-6'})")

    phase("fused MLP (M) vs plain")
    m_err = 0.0

    def mlp_case(width, batch, dtype, soa_in=True, soa_out=False):
        dims = [(32, width), (width, width), (width, 3)]
        ws = [(torch.rand(d, generator=gen, device=dev) * 2 - 1)
              * float(np.sqrt(6.0 / sum(d))) for d in dims]
        x = torch.rand((32, batch) if soa_in else (batch, 32), generator=gen,
                       device=dev) * 2 - 1
        args = (ws, x.to(dtype), Activation.RELU, Activation.NONE, dtype,
                torch.float32, soa_in, soa_out)
        with torch.inference_mode():
            got = fused_mlp_fwd(*args)
            torch.cuda.synchronize()
            want = fused_mlp_plain(*args)
        abs_err, rel_err = compare(got, want,
                                   "mlp-bf16" if dtype == torch.bfloat16 else "mlp-f32")
        print(f"W={width} B={batch} {str(dtype)[6:]} in={'SoA' if soa_in else 'AoS'} "
              f"out={'SoA' if soa_out else 'AoS'}: max abs err {abs_err:.3e}, "
              f"max rel err {rel_err:.3e}")
        return abs_err

    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        for dtype in (torch.bfloat16, torch.float32):
            err = mlp_case(64, batch, dtype)
            if dtype == torch.bfloat16:
                m_err = max(m_err, err)
    for width in (16, 32, 128):
        for dtype in (torch.bfloat16, torch.float32):
            mlp_case(width, 4133, dtype, soa_in=False, soa_out=True)

    def plain_inference(m, x):
        """The main path through the plain versions, on the same tensors."""
        e, n, pol = m.network.encoding, m.network.network, m.network.policy
        table = e.grid.detach().to(pol.compute_dtype)
        feats = grid_encode_plain(e.spec, table, x, live, soa=True)
        return fused_mlp_plain([w.detach() for w in n.layers],
                               feats.to(pol.compute_dtype), n.activation,
                               n.output_activation, pol.compute_dtype,
                               pol.output_dtype, input_soa=True)

    phase("slice: config_hash requests through model.trainer.inference (BF16_POLICY)")
    xs = [torch.rand((b, 2), generator=gen, device=dev) for b in REQUESTS]
    torch.cuda.synchronize()
    grid_encode_fwd.launches = 0
    fused_mlp_fwd.launches = 0
    answers = []
    for i, x in enumerate(xs):
        y = model.trainer.inference(x)
        torch.cuda.synchronize()
        check(grid_encode_fwd.launches == i + 1 and fused_mlp_fwd.launches == i + 1,
              f"request {i}: launch counts G={grid_encode_fwd.launches} "
              f"M={fused_mlp_fwd.launches}, expected {i + 1} each")
        answers.append(y)
    launches = {"G": grid_encode_fwd.launches, "M": fused_mlp_fwd.launches}
    for x, y in zip(xs, answers):
        check(y.shape == (x.shape[0], 3) and y.dtype == torch.float32,
              f"answer {tuple(y.shape)} {y.dtype}")
        with torch.inference_mode():
            abs_err, rel_err = compare(y, plain_inference(model, x), "model")
        print(f"request B={x.shape[0]}: ({x.shape[0]}, 3) float32, max abs err "
              f"{abs_err:.3e} vs plain path (rtol 2e-2, atol 2e-3)")
    print(f"main-path launches: G {launches['G']}, M {launches['M']}")

    phase("slice: one DEFAULT_POLICY (fp32) request")
    model32 = create_from_config(2, 3, CONFIG, policy=DEFAULT_POLICY)
    with torch.no_grad():
        model32.network.encoding.grid.copy_(enc.grid)
    x = xs[1]
    g0, m0 = grid_encode_fwd.launches, fused_mlp_fwd.launches
    y = model32.trainer.inference(x)
    torch.cuda.synchronize()
    check((grid_encode_fwd.launches - g0, fused_mlp_fwd.launches - m0) == (1, 1),
          "fp32 request did not launch G and M once each")
    with torch.inference_mode():
        abs_err, _ = compare(y, plain_inference(model32, x), "mlp-f32")
    print(f"fp32 request B={x.shape[0]}: max abs err {abs_err:.3e} (rtol 1e-5, atol 1e-5)")

    phase(f"times at B={MAIN_BATCH}: kernels and library chain as device time "
          f"in a CUDA graph of {N_TIMED} calls; plain versions eager")
    x = xs[0]
    table = enc.grid.detach().to(torch.bfloat16)
    ws = [w.detach().to(torch.bfloat16) for w in net.layers]
    with torch.inference_mode():
        feats = grid_encode_fwd(spec, table, x, live, soa=True)
        mlp_args = (ws, feats, net.activation, net.output_activation,
                    torch.bfloat16, torch.float32, True, False)

        def g_call():
            return grid_encode_fwd(spec, table, x, live, soa=True)

        def m_call():
            return fused_mlp_fwd(*mlp_args)

        def library_chain():   # three cuBLAS products, timed only as a yardstick
            h = torch.relu(feats.t() @ ws[0])
            h = torch.relu(h @ ws[1])
            return h @ ws[2]

        def request():
            return model.trainer.inference(x)

        g_ms, g_call_ms = graph_ms(g_call), time_ms(g_call)
        g_plain_ms = eager_ms(lambda: grid_encode_plain(spec, table, x, live, soa=True))
        m_ms, m_call_ms = graph_ms(m_call), time_ms(m_call)
        m_plain_ms = eager_ms(lambda: fused_mlp_plain(*mlp_args))
        m_lib_ms = graph_ms(library_chain)
        inf_device_ms, inf_ms = graph_ms(request), time_ms(request)

    # Least time for the same work: each input read once, each output
    # written once, over HBM; operations over the peak of their type.
    L, F, D, C = spec.n_levels, spec.n_features_per_level, spec.n_dims, 1 << spec.n_dims
    g_bytes = nbytes(x, table, feats) + L * grid_ops.LEVEL_FIELDS * 4  # + level constants
    # per (sample, level): x·scale + 0.5 and fract (3D), 1 − w (D), corner
    # weights C(D − 1), weighted sum 2CF
    g_flops = MAIN_BATCH * L * (4 * D + C * (D - 1) + 2 * C * F)
    g_bound = max(g_bytes / PEAK_BYTES, g_flops / PEAK_FP32) * 1e3
    y_bytes = MAIN_BATCH * net.n_output_dims * 4
    m_bytes = nbytes(feats, *ws) + y_bytes
    m_flops = 2 * MAIN_BATCH * sum(w.numel() for w in ws)
    m_bound = max(m_bytes / PEAK_BYTES, m_flops / PEAK_BF16) * 1e3
    print(f"G: {g_ms:.4f} ms on the device, {g_call_ms:.4f} ms per call with "
          f"the host's work (plain {g_plain_ms:.4f} ms, bound {g_bound:.4f} ms: "
          f"{g_bytes / 1e6:.2f} MB, {g_flops / 1e9:.3f} GFLOP fp32)")
    print(f"M: {m_ms:.4f} ms on the device, {m_call_ms:.4f} ms per call with the "
          f"host's work (plain {m_plain_ms:.4f} ms, three-matmul chain "
          f"{m_lib_ms:.4f} ms, bound {m_bound:.4f} ms: {m_bytes / 1e6:.2f} MB, "
          f"{m_flops / 1e9:.3f} GFLOP bf16)")
    print(f"inference at B={MAIN_BATCH}: {inf_ms:.4f} ms per request, "
          f"{MAIN_BATCH / inf_ms * 1e3:.4e} samples/s; {inf_device_ms:.4f} ms of "
          f"device work (idle share {1 - inf_device_ms / inf_ms:.3f})")

    phase("kernels")
    report = {"kernels": [
        {"name": "grid_encode_fwd", "route": "cuda",
         "source": "tcnn_tpu_torch/csrc/grid_encode.cu",
         "replaces": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel); "
                     "tcnn_tpu/ops/pallas/grid_matmul.py:734 (_gather_kernel_xor)",
         "launches": launches["G"], "max_abs_err": g_err, "ms": g_ms,
         "plain_ms": g_plain_ms, "bound_ms": g_bound,
         "bound_by": "bytes" if g_bytes / PEAK_BYTES >= g_flops / PEAK_FP32 else "operations",
         "library_ms": None},
        {"name": "fused_mlp_fwd", "route": "cuda",
         "source": "tcnn_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
         "launches": launches["M"], "max_abs_err": m_err, "ms": m_ms,
         "plain_ms": m_plain_ms, "bound_ms": m_bound,
         "bound_by": "bytes" if m_bytes / PEAK_BYTES >= m_flops / PEAK_BF16 else "operations",
         "library_ms": m_lib_ms},
    ]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

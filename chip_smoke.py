#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tcnn_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, and drives the port's
paths at full width, each with the launch counts set to 0 just before it
and read just after:
  * config_hash (2-D hash grid, FullyFusedMLP 64 x 2): serving requests
    through ``model.trainer.inference`` (slice 1), training through
    ``model.trainer.training_step`` and ``make_training_loop`` (slice 2);
  * config_btf (Composite of a 4-D CoherentAdd hash grid of 15,474,688
    parameters and OneBlob, FullyFusedMLP 64 x 3, 40 inputs): one request
    of 2^18 and training, the same entry points (slice 3).
It times the kernels, a request and a training step of both, and prints:

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
    sum in another order); bfloat16 table: |d| <= one bf16 ulp of ref
    (the fp32 sum may round to the other neighbour).  At config_btf's 4-D
    grid the bf16 bound adds the fp32 sum's own error, (2^D + 2D)·2^-24 =
    1.43e-6: 16 corner terms, each a product of 4 weights, with the
    weights summing to 1 and the U(±1) table bounding each term by 1;
    where the terms cancel to a value near 0, that error is many bf16
    ulps of it.  config_hash keeps the bound of one ulp, which it meets.
  * fused MLP, float32: rtol 1e-5, atol 1e-5; bfloat16: rtol 2e-2,
    atol 2e-3 (a hidden activation may round to the other bf16
    neighbour when the sum is taken in another order).
  * whole model: the bfloat16 MLP tolerance, on O(1) outputs.
  * grid backward (table gradient): per table entry, with S = Σ|w·dy|
    over its updates, |d| <= 2^-11·S, plus one bf16 ulp of ref for bf16
    tables.  Both sides sum in fp32 in an arbitrary order (atomics); n
    terms in two orders differ by at most (n − 1)·2^-24·S, and 2^-11
    covers n up to 8192: a level-0 row takes about 4096 updates at 2^18
    in config_hash, 64 in config_btf.
  * fused-MLP backward: every dW and dx within 1e-4 (fp32) or 2e-2
    (bf16) of its largest magnitude: sums over the batch in another order,
    and in bf16 a dz may round to the other neighbour.  At config_btf
    (four layers, 2^18 samples) a sample's hidden pre-activation may lie
    so near 0 that a bf16 rounding upstream moves it across, which
    switches its ReLU and moves that sample's dx row by a whole term.  So
    there, and only in bf16, a dx row beyond the bound passes when
    ``tools.plain_path.relu_flip_rows`` explains it: the sample has a
    pre-activation with |z| at most 2^-7 of Σ|h·w| (one bf16 ulp of the
    terms), and the plain version recomputed for the outlying samples
    alone, as it is or with the ReLU of one or two of the sample's
    pre-activations nearest 0 flipped, lies within the bound of that row
    in every entry.  The script prints each such sample with its nearest
    |z| / Σ|h·w|.  dW stays within 2e-2 everywhere.
  * training step: the gradients of the step within the MLP-backward
    tolerance of the plain path's on the same tensors.  At config_btf the
    plain path's table gradient is taken from its MLP input gradient with
    the explained rows (above) replaced by their flipped variants.
  * image fit (200 steps at 2^18 on synthetic_image(1024, 1024)): mean
    loss of the last 10 steps below 0.2x the first step's, and PSNR of the
    whole image above 20 dB, the floors of tests/test_trainer.py.
  * BTF fit (200 steps at 2^18 on synthetic_btf): mean loss of the last
    10 steps below 0.05x the first step's, and relL2 on 2^16 held-out
    samples below 0.35; the plain versions' run meets both in 150 steps
    (at 100 it read 0.016x and relL2 0.302 on an H100).  The JAX sample
    (samples/fit_btf.py 200 14 on the CPU, 16x fewer samples a step)
    reached loss 0.246 at step 50 from a first step near 13 (a prediction
    near 0 under RelativeL2), and held-out relL2 0.2518, where a zero
    prediction scores 0.64.

The whole run takes two to three minutes on an H100, against the 1200 s
a run may take: the kernels' build takes 44 to 79 s, and the plain
versions' BTF fit, 150 eager steps (the kernels' fit runs 200), about
45 s.  It prints its own time before the kernels' line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = "configs/config_hash.json"
BTF_CONFIG = "configs/config_btf.json"
BTF_GRID_PARAMS = 15474688
MAIN_BATCH = 1 << 18
FIT_STEPS = 200
LOOP_STEPS = 100     # the timed make_training_loop call
REQUESTS = (1 << 18, 1 << 16, 12345, 1)
N_TIMED = 30
PLAIN_BTF_STEPS = 150   # the plain versions' BTF fit: reaches the floors with margin
BTF_LOSS_RATIO = 0.05
BTF_REL_FLOOR = 0.35
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


def compare(got, want, kind, atol=0.0):
    """(max abs err, max rel err); raises beyond the stated tolerance
    (``atol``: the fp32 sum's own error added to the grid-bf16 bound)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kind}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{kind}: non-finite output")
    err = (g - w).abs()
    if kind == "grid-bf16":
        bad = err > bf16_ulp(w) + atol
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


def bound_by(n_bytes, flops, peak):
    return "bytes" if n_bytes / PEAK_BYTES >= flops / peak else "operations"


def bound_ms(n_bytes, flops, peak):
    """Least time for the work: bytes over HBM or operations over peak."""
    return max(n_bytes / PEAK_BYTES, flops / peak) * 1e3


def grid_flops(spec, batch):
    """Per (sample, level): x·scale + 0.5 and fract (3D), 1 − w (D), corner
    weights C(D − 1), weighted sum 2CF (GB: w·dy and the add, also 2CF)."""
    L, F, D, C = spec.n_levels, spec.n_features_per_level, spec.n_dims, 1 << spec.n_dims
    return batch * L * (4 * D + C * (D - 1) + 2 * C * F)


def compare_table_grad(got, want, scale):
    """Max abs error of a table gradient; raises beyond 2^-11·S (+ one
    bf16 ulp for bf16 tables), S = Σ|w·dy| per entry."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"table grad: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), "table grad: non-finite values")
    err = (g - w).abs()
    tol = 2.0 ** -11 * scale + 1e-30
    if want.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(w)
    bad = err > tol
    check(not bool(bad.any()), f"table grad: {int(bad.sum())} entries beyond "
          f"tolerance, max abs err {err.max().item():.3e}")
    return err.max().item()


def compare_mlp_grads(got, want, dtype, what):
    """Max abs error over a list of gradients; raises beyond 1e-4 (fp32)
    or 2e-2 (bf16) of each gradient's largest magnitude."""
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape, f"{what}[{i}]: {tuple(a.shape)} vs {tuple(b.shape)}")
        check(bool(torch.isfinite(a.float()).all()), f"{what}[{i}]: non-finite values")
        err = (a.float() - b.float()).abs().max().item()
        lim = rel * b.float().abs().max().item()
        check(err <= lim, f"{what}[{i}]: max abs err {err:.3e} beyond {lim:.3e}")
        worst = max(worst, err)
    return worst


MAX_FLIP_ROWS = 1024   # more rows beyond the bound than switched ReLUs make


def compare_input_grad(got, want, ws, x, g, out_act, soa_in=False, soa_out=False,
                       what="dx"):
    """An MLP input gradient in bf16 against the plain version's, one row
    per sample: within 2e-2 of its largest magnitude, but for rows that
    ``relu_flip_rows`` explains (a pre-activation lies within rounding of
    0, and the plain version recomputed for these rows, with one or two
    ReLUs nearest 0 flipped or none, lies within that bound).  x and g are the plain
    version's MLP input and output gradient.  Returns (max abs err over
    the other rows, the explained rows' sample indices, their flipped
    variants in the rows' layout)."""
    from tcnn_tpu_torch.tools.plain_path import relu_flip_rows

    check(got.shape == want.shape, f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values")
    a, b = (got.t(), want.t()) if soa_in else (got, want)
    err = (a.float() - b.float()).abs()
    tol = 2e-2 * b.float().abs().max().item()
    rows = (err > tol).any(dim=1).nonzero().flatten()
    check(rows.numel() <= MAX_FLIP_ROWS, f"{what}: {rows.numel()} rows beyond {tol:.3e}")
    other = err.max(dim=1).values
    other[rows] = 0
    if not rows.numel():
        return other.max().item(), rows, a[rows].float()
    explained, variants, flipped, nearest = relu_flip_rows(
        ws, x, g, out_act, torch.bfloat16, rows, a[rows], tol, soa_in, soa_out)
    for r, s, e, f, z in zip(range(10), rows.tolist(), err[rows].max(dim=1).values.tolist(),
                             flipped.tolist(), nearest.tolist()):
        fs = [f"{v:.3e}" for v in f if v == v]
        how = ("no flipped ReLU explains it" if not bool(explained[r]) else
               f"the plain row with the ReLU(s) at {', '.join(fs)} flipped matches it" if fs
               else "the plain row recomputed for these samples alone matches it")
        print(f"{what}: sample {s} off by {e / tol * 2e-2:.3e} of the largest magnitude; "
              f"its pre-activation nearest 0 at |z| / Σ|h·w| = {z:.3e}; {how}")
    check(bool(explained.all()), f"{what}: {int((~explained).sum())} of {rows.numel()} "
          f"rows beyond {tol:.3e} not explained by a switched ReLU")
    print(f"{what}: {rows.numel()} of {a.shape[0]} rows beyond 2e-2 of the largest "
          f"magnitude, each explained by a switched ReLU")
    return other.max().item(), rows, variants


def check_step_gradients(model, x, target, flips=False):
    """The trainer's loss and gradients against the plain path's.  With
    ``flips`` (config_btf, bf16), the rows of the MLP input gradient that
    a switched ReLU explains take their flipped variants before the plain
    path's table gradient is formed from it."""
    from tcnn_tpu_torch.tools.plain_path import plain_grid_grads, plain_step_parts

    loss, grads = model.trainer.loss_value_and_grads(x, target)
    p = plain_step_parts(model, x, target)
    dfeats = p.dfeats
    if flips:
        net = model.network.network
        # the kernel path's MLP input gradient on the same tensors (G, M, MB)
        feats = model.network.encoding(x).detach().requires_grad_()
        (got,) = torch.autograd.grad(model.loss(net(feats).float(), target), feats)
        _, rows, variants = compare_input_grad(
            got, dfeats, [w.detach() for w in net.layers], p.feats, p.dy,
            net.output_activation, what="step dx")
        dfeats = dfeats.clone()
        dfeats[rows] = variants.to(dfeats.dtype)
    want_grads = plain_grid_grads(model, x, dfeats, p.soa)
    want_grads.update({f"network.layers.{i}": d for i, d in enumerate(p.dws)})
    want_loss = p.loss
    torch.cuda.synchronize()
    check(abs(loss.item() - want_loss.item()) <= 2e-2 * abs(want_loss.item()),
          f"step loss {loss.item()} vs plain {want_loss.item()}")
    check(set(grads) == set(want_grads), f"gradient names {sorted(grads)}")
    for name in grads:
        check(grads[name].dtype == torch.float32, f"{name}: gradient dtype {grads[name].dtype}")
        err = compare_mlp_grads([grads[name]], [want_grads[name]], torch.bfloat16, name)
        print(f"gradient {name}: max abs err {err:.3e} vs plain path "
              f"(max |g| {want_grads[name].abs().max().item():.3e}, 2e-2 of it)")
    print(f"loss {loss.item():.6f}, plain path {want_loss.item():.6f}")
    return grads


def random_mlp(gen, dev, dims):
    return [(torch.rand(d, generator=gen, device=dev) * 2 - 1)
            * float(np.sqrt(6.0 / sum(d))) for d in dims]


def mlp_dims(d_in, width, n_hidden, d_out=3):
    return [(d_in, width)] + [(width, width)] * (n_hidden - 1) + [(width, d_out)]


def mlp_case(gen, dev, dims, batch, dtype, soa_in=True, soa_out=False):
    """Kernel M against its plain version; returns the max abs error."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_fwd, fused_mlp_plain

    ws = random_mlp(gen, dev, dims)
    d_in = dims[0][0]
    x = torch.rand((d_in, batch) if soa_in else (batch, d_in), generator=gen,
                   device=dev) * 2 - 1
    args = (ws, x.to(dtype), Activation.RELU, Activation.NONE, dtype,
            torch.float32, soa_in, soa_out)
    with torch.inference_mode():
        got = fused_mlp_fwd(*args)
        torch.cuda.synchronize()
        want = fused_mlp_plain(*args)
    abs_err, rel_err = compare(got, want,
                               "mlp-bf16" if dtype == torch.bfloat16 else "mlp-f32")
    print(f"{d_in} -> {dims[0][1]} x {len(dims) - 1} -> {dims[-1][1]} B={batch} "
          f"{str(dtype)[6:]} in={'SoA' if soa_in else 'AoS'} "
          f"out={'SoA' if soa_out else 'AoS'}: max abs err {abs_err:.3e}, "
          f"max rel err {rel_err:.3e}")
    return abs_err


def mlp_bwd_case(gen, dev, dims, batch, dtype, soa_in=True, soa_out=False, flips=False):
    """Kernel MB against its plain version; returns the max abs error.
    With ``flips`` (config_btf) a bf16 dx row beyond the bound passes where
    a switched ReLU explains it (``compare_input_grad``)."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_bwd_plain

    ws = random_mlp(gen, dev, dims)
    d_in = dims[0][0]
    x = torch.rand((d_in, batch) if soa_in else (batch, d_in), generator=gen,
                   device=dev) * 2 - 1
    g = torch.randn((3, batch) if soa_out else (batch, 3), generator=gen, device=dev)
    args = (ws, x.to(dtype), g, Activation.RELU, Activation.NONE, dtype, soa_in, soa_out)
    with torch.inference_mode():
        got_dws, got_dx = fused_mlp_bwd(*args)
        torch.cuda.synchronize()
        want_dws, want_dx = fused_mlp_bwd_plain(*args)
    check(got_dx.dtype == dtype, f"MB: dx dtype {got_dx.dtype}")
    if flips and dtype == torch.bfloat16:
        err = max(compare_mlp_grads(got_dws, want_dws, dtype, "MB"),
                  compare_input_grad(got_dx, want_dx, ws, args[1], g, Activation.NONE,
                                     soa_in, soa_out, "MB dx")[0])
    else:
        err = compare_mlp_grads([*got_dws, got_dx], [*want_dws, want_dx], dtype, "MB")
    print(f"{d_in} -> {dims[0][1]} x {len(dims) - 1} -> {dims[-1][1]} B={batch} "
          f"{str(dtype)[6:]} in={'SoA' if soa_in else 'AoS'} "
          f"out={'SoA' if soa_out else 'AoS'}: max abs err {err:.3e} over dW and dx "
          f"({'2e-2' if dtype == torch.bfloat16 else '1e-4'} of each max"
          f"{', dx rows of switched ReLUs aside' if flips and dtype == torch.bfloat16 else ''})")
    return err


def grid_bwd_case(spec, table, x, dc, label):
    """Kernel GB against its plain version; returns the max abs error."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd, grid_encode_bwd_plain

    live = list(range(spec.n_levels))
    with torch.inference_mode():
        got = grid_encode_bwd(spec, table, x, dc, live)
        torch.cuda.synchronize()
        want = grid_encode_bwd_plain(spec, table, x, dc, live)
        scale = grid_encode_bwd_plain(spec, table.float(), x, dc.float().abs(), live)
    abs_err = compare_table_grad(got, want, scale)
    bf16 = table.dtype == torch.bfloat16
    print(f"{label} table={str(table.dtype)[6:]}: max abs err {abs_err:.3e} "
          f"(2^-11·S{' + one bf16 ulp' if bf16 else ''})")
    return abs_err


def counters():
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_fwd
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd, grid_encode_fwd

    return {"G": grid_encode_fwd, "M": fused_mlp_fwd, "GB": grid_encode_bwd,
            "MB": fused_mlp_bwd}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in counters().items()}


def slice_times(label, model, x, target, loop):
    """Times at the model's shapes on the batch (x, target): kernels G, M,
    MB and GB on the tensors the model hands them (device time in a CUDA
    graph, per call with the host's work, plain versions eager, cuBLAS
    yardsticks), a request, the step's parts, the step and ``loop()``;
    and each kernel's bound.  Prints them and returns them by name."""
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd,
                                                     grid_encode_bwd_plain,
                                                     grid_encode_fwd,
                                                     grid_encode_plain)
    from tcnn_tpu_torch.tools.plain_path import grid_parts

    phase(f"{label} times at B={MAIN_BATCH}: kernels, library calls and whole steps as "
          f"device time in a CUDA graph of {N_TIMED} calls; plain versions eager")
    (_, grid, xg, col), = grid_parts(model, x)
    enc, net, spec = model.network.encoding, model.network.network, grid.spec
    soa = enc is grid   # a grid alone hands the MLP SoA features
    others = [e for e in getattr(enc, "nested", ()) if e is not grid]
    live = list(range(spec.n_levels))
    bf16, relu, out_act = torch.bfloat16, net.activation, net.output_activation
    table = grid.grid.detach().to(bf16)
    ws = [w.detach().to(bf16) for w in net.layers]
    t = {}
    with torch.inference_mode():
        feats = enc(x, soa=True) if soa else enc(x)   # the MLP's input
        gfeats = grid_encode_fwd(spec, table, xg, live, soa=soa)
        mlp_args = (ws, feats, relu, out_act, bf16, torch.float32, soa, False)
        f_in = feats.t() if soa else feats

        def g_call():
            return grid_encode_fwd(spec, table, xg, live, soa=soa)

        def m_call():
            return fused_mlp_fwd(*mlp_args)

        def library_chain():   # cuBLAS products, timed only as a yardstick
            h = f_in
            for w in ws[:-1]:
                h = torch.relu(h @ w)
            return h @ ws[-1]

        def request():
            return model.trainer.inference(x)

        t["G"], t["G call"] = graph_ms(g_call), time_ms(g_call)
        t["G plain"] = eager_ms(lambda: grid_encode_plain(spec, table, xg, live, soa=soa))
        t["M"], t["M call"] = graph_ms(m_call), time_ms(m_call)
        t["M plain"] = eager_ms(lambda: fused_mlp_plain(*mlp_args))
        t["M library"] = graph_ms(library_chain)
        t["request device"], t["request"] = graph_ms(request), time_ms(request)
        t["table copy"] = graph_ms(lambda: grid.grid.detach().to(bf16))
        t["other encodings"] = sum(graph_ms(lambda e=e, b=b, nd=nd: e(x[:, b:b + nd]))
                                   for e, (b, nd) in zip(getattr(enc, "nested", ()),
                                                         getattr(enc, "slices", ()))
                                   if e is not grid)
        # the table rows this batch touches: the table bytes G must read
        idx, _ = grid_ops.build_indices_weights(spec, xg, live)
        touched = torch.zeros(spec.n_entries, dtype=torch.bool, device=x.device)
        touched[idx.reshape(-1)] = True
        g_table_bytes = int(touched.sum()) * spec.n_features_per_level * table.element_size()
        del idx, touched

    # The training step's parts on the same batch: the loss and its
    # gradient, MB on that gradient, GB on MB's input gradient, Adam.
    with torch.no_grad():
        pred = fused_mlp_fwd(*mlp_args)

    def loss_call():
        p = pred.detach().requires_grad_()
        return torch.autograd.grad(model.loss(p, target), p)[0]

    dy = loss_call()
    with torch.inference_mode():
        mb_args = (ws, feats, dy, relu, out_act, bf16, soa, False)
        dfeats = fused_mlp_bwd(*mb_args)[1]
        cols = slice(col, col + spec.n_output_dims)
        dcols = dfeats[cols] if soa else dfeats[:, cols].t()
        hs, zs = [f_in], []
        for w in ws[:-1]:
            zs.append(hs[-1] @ w)
            hs.append(torch.relu(zs[-1]))

        def mb_call():
            return fused_mlp_bwd(*mb_args)

        def gb_call():
            return grid_encode_bwd(spec, table, xg, dcols, live)

        def library_bwd():   # the chain's backward on its saved activations (cuBLAS)
            dz, dws = dy.to(bf16), []
            for i in range(len(ws) - 1, -1, -1):
                dws.append(hs[i].t() @ dz)
                dz = dz @ ws[i].t()
                if i:
                    dz = dz * (zs[i - 1] > 0)
            return dws, dz

        t["MB"], t["MB call"] = graph_ms(mb_call), time_ms(mb_call)
        t["MB plain"] = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
        t["MB library"] = graph_ms(library_bwd)
        t["GB"], t["GB call"] = graph_ms(gb_call), time_ms(gb_call)
        t["GB plain"] = eager_ms(lambda: grid_encode_bwd_plain(spec, table, xg, dcols, live))

    trainer = model.trainer
    _, step_grads = trainer.loss_value_and_grads(x, target)
    t["loss"] = graph_ms(loss_call)
    t["Adam"] = graph_ms(lambda: model.optimizer.step(trainer.opt_state, step_grads,
                                                      trainer.params()))
    t["step"] = time_ms(lambda: trainer.training_step(x, target))
    t["step device"] = graph_ms(lambda: trainer.training_step(x, target))
    loop_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop_losses = loop()
        torch.cuda.synchronize()
        loop_times.append((time.perf_counter() - t0) * 1e3 / LOOP_STEPS)
    check(bool(torch.isfinite(loop_losses).all()), "non-finite loss in the timed loop")
    t["loop step"] = float(np.median(loop_times))

    # Least time for the same work: each input read once (the x columns
    # the grid reads, the table rows this batch touches), each output
    # written once, over HBM; operations over the peak of their type.
    consts_bytes = spec.n_levels * grid_ops.LEVEL_FIELDS * 4
    b = {"G": (nbytes(xg, gfeats) + g_table_bytes + consts_bytes,
               grid_flops(spec, MAIN_BATCH), PEAK_FP32)}
    m_flops = 2 * MAIN_BATCH * sum(w.numel() for w in ws)
    b["M"] = (nbytes(feats, *ws) + MAIN_BATCH * net.n_output_dims * 4, m_flops, PEAK_BF16)
    # GB: x, dcols and the level constants in, the bf16 table gradient out.
    b["GB"] = (nbytes(xg, dcols, table) + consts_bytes, b["G"][1], PEAK_FP32)
    # MB: input, output gradient and weights in; input gradient and fp32 dW
    # out.  Products: the recomputed forward, the dgrad and the wgrad chains.
    b["MB"] = (nbytes(feats, dy, *ws, dfeats) + sum(w.numel() for w in ws) * 4,
               3 * m_flops, PEAK_BF16)
    for k, (n_bytes, flops, peak) in b.items():
        t[f"{k} bound"] = bound_ms(n_bytes, flops, peak)
        t[f"{k} bound by"] = bound_by(n_bytes, flops, peak)
        kind = "bf16" if peak == PEAK_BF16 else "fp32"
        lib = (f", cuBLAS {'chain' if k == 'M' else 'chain backward'} {t[k + ' library']:.4f} ms"
               if k + " library" in t else "")
        extra = (f" with {g_table_bytes / 1e6:.2f} MB of touched table rows" if k == "G"
                 else "")
        print(f"{k}: {t[k]:.4f} ms on the device, {t[k + ' call']:.4f} ms per call with "
              f"the host's work (plain {t[k + ' plain']:.4f} ms{lib}, bound "
              f"{t[k + ' bound']:.4f} ms: {n_bytes / 1e6:.2f} MB{extra}, "
              f"{flops / 1e9:.3f} GFLOP {kind})")
    parts = {k: t[k] for k in ("G", "M", "table copy")}
    if others:
        parts["other encodings"] = t["other encodings"]
    print(f"inference at B={MAIN_BATCH}: {t['request']:.4f} ms per request, "
          f"{MAIN_BATCH / t['request'] * 1e3:.4e} samples/s; {t['request device']:.4f} ms "
          f"of device work (idle share {1 - t['request device'] / t['request']:.3f}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f", the rest {t['request device'] - sum(parts.values()):.4f} ms")
    parts.update({k: t[k] for k in ("loss", "MB", "GB", "Adam")})
    parts["casts, gaps and the rest"] = t["step device"] - sum(parts.values())
    print(f"training step at B={MAIN_BATCH}: {t['step']:.4f} ms eager with the host's "
          f"work, {t['step device']:.4f} ms of device work (idle share "
          f"{1 - t['step device'] / t['step']:.3f}); split: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    print(f"make_training_loop at B={MAIN_BATCH}: {t['loop step']:.4f} ms per step "
          f"(median of 3 calls of {LOOP_STEPS} steps), "
          f"{MAIN_BATCH / t['loop step'] * 1e3:.4e} training samples/s, idle share "
          f"{1 - t['step device'] / t['loop step']:.3f}")
    return t


KERNELS = {   # report name: (source, timing key)
    "grid_encode_fwd": ("tcnn_tpu_torch/csrc/grid_encode.cu", "G"),
    "fused_mlp_fwd": ("tcnn_tpu_torch/csrc/fused_mlp.cu", "M"),
    "grid_encode_bwd": ("tcnn_tpu_torch/csrc/grid_encode_bwd.cu", "GB"),
    "fused_mlp_bwd": ("tcnn_tpu_torch/csrc/fused_mlp_bwd.cu", "MB"),
}


def report_entries(suffix, t, replaces, launches, errors, inference_launches):
    """The {"kernels": [...]} entries of one path: launches from its main
    path's run, numbers from ``slice_times``."""
    out = []
    for name, (source, k) in KERNELS.items():
        entry = {"name": name + suffix, "route": "cuda", "source": source,
                 "replaces": replaces[k], "launches": launches[k],
                 "max_abs_err": errors[k], "ms": t[k], "plain_ms": t[k + " plain"],
                 "bound_ms": t[k + " bound"], "bound_by": t[k + " bound by"],
                 "library_ms": t.get(k + " library")}
        if k in inference_launches:
            entry["launches_inference"] = inference_launches[k]
        out.append(entry)
    return out


def config_hash_slices(gen, dev):
    """Slices 1 and 2 on config_hash; returns the kernels' report entries."""
    from tcnn_tpu_torch import BF16_POLICY, DEFAULT_POLICY, create_from_config
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_fwd
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_fwd, grid_encode_plain
    from tcnn_tpu_torch.tools.plain_path import plain_inference, plain_training_step
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
    from tcnn_tpu_torch.utils.metrics import psnr

    # The main path's model: config_hash at full width.  A trained table
    # holds O(1) features; the U(±1e-4) init would put every error below
    # any tolerance, so the table is redrawn U(±1) from the seed.
    model = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    enc = model.network.encoding
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
    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        for dtype in (torch.bfloat16, torch.float32):
            err = mlp_case(gen, dev, mlp_dims(32, 64, 2), batch, dtype)
            if dtype == torch.bfloat16:
                m_err = max(m_err, err)
    for width in (16, 32, 128):
        for dtype in (torch.bfloat16, torch.float32):
            mlp_case(gen, dev, mlp_dims(32, width, 2), 4133, dtype, soa_in=False,
                     soa_out=True)

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
    inf_launches = {"G": grid_encode_fwd.launches, "M": fused_mlp_fwd.launches}
    for x, y in zip(xs, answers):
        check(y.shape == (x.shape[0], 3) and y.dtype == torch.float32,
              f"answer {tuple(y.shape)} {y.dtype}")
        with torch.inference_mode():
            abs_err, rel_err = compare(y, plain_inference(model, x), "model")
        print(f"request B={x.shape[0]}: ({x.shape[0]}, 3) float32, max abs err "
              f"{abs_err:.3e} vs plain path (rtol 2e-2, atol 2e-3)")
    print(f"inference-path launches: G {inf_launches['G']}, M {inf_launches['M']}")

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

    phase("grid backward (GB) vs plain, config_hash geometry")
    gb_err = 0.0
    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        x = torch.rand((batch, 2), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            table = enc.grid.detach().to(dtype)
            dcols = torch.randn((spec.n_output_dims, batch), generator=gen,
                                device=dev).to(dtype)
            for layout, dc in (("SoA", dcols), ("AoS", dcols.t().contiguous().t())):
                abs_err = grid_bwd_case(spec, table, x, dc, f"B={batch} dcols {layout}")
                if dtype == torch.bfloat16:
                    gb_err = max(gb_err, abs_err)

    phase("fused-MLP backward (MB) vs plain")
    mb_err = 0.0
    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        for dtype in (torch.bfloat16, torch.float32):
            err = mlp_bwd_case(gen, dev, mlp_dims(32, 64, 2), batch, dtype)
            if dtype == torch.bfloat16:
                mb_err = max(mb_err, err)
    for width in (16, 32, 128):
        for dtype in (torch.bfloat16, torch.float32):
            mlp_bwd_case(gen, dev, mlp_dims(32, width, 2), 4133, dtype, soa_in=False,
                         soa_out=True)

    phase("slice 2: one training step through model.trainer (BF16_POLICY), "
          "gradients vs the plain path")
    tmodel = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    with torch.no_grad():
        tmodel.network.encoding.grid.uniform_(-1, 1, generator=gen)
    x = torch.rand((MAIN_BATCH, 2), generator=gen, device=dev)
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    check_step_gradients(tmodel, x, target)

    # The training path: counts set to 0 here, read after the fit loop.
    torch.cuda.synchronize()
    reset_counts()
    step_loss = tmodel.trainer.training_step(x, target)
    torch.cuda.synchronize()
    check(counts() == {"G": 1, "M": 1, "GB": 1, "MB": 1},
          f"training step launches {counts()}, expected one of each kernel")
    check(bool(torch.isfinite(step_loss)), "training step loss is not finite")
    print(f"training_step: loss {step_loss.item():.6f}; launches {counts()}")

    phase(f"slice 2: {FIT_STEPS} steps of make_training_loop at B={MAIN_BATCH} "
          "on synthetic_image(1024, 1024), CUDA graph replay")
    image = synthetic_image(1024, 1024)
    fit = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    sampler = ImageSampler(image, seed=0)
    fit_loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                              FIT_STEPS)
    t0 = time.time()
    fit_losses = fit_loop()
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    # Graph replays run the kernels without calling their wrappers: the
    # counts hold the training step, the loop's eager warm-up step and its
    # captured step, one launch of each kernel apiece.
    train_launches = counts()
    check(train_launches == {"G": 3, "M": 3, "GB": 3, "MB": 3},
          f"training path launches {train_launches}, expected 3 of each kernel")
    fit_losses = fit_losses.cpu()
    check(bool(torch.isfinite(fit_losses).all()), "non-finite training loss")
    first, last10 = float(fit_losses[0]), float(fit_losses[-10:].mean())
    coords = sampler.full_grid_coords()
    fit_psnr = psnr(fit.trainer.inference(coords), sampler.image.reshape(-1, 3))
    print(f"kernels: {FIT_STEPS} steps in {fit_s:.2f} s (capture included); loss "
          f"{first:.4f} -> {last10:.4f} (mean of the last 10, "
          f"{last10 / first:.4f}x); PSNR {fit_psnr:.2f} dB; "
          f"training-path launches {train_launches}")

    plain = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    plain_sampler = ImageSampler(image, seed=0)
    t0 = time.time()
    plain_losses = torch.stack([plain_training_step(plain, *plain_sampler.sample_batch(MAIN_BATCH))
                                for _ in range(FIT_STEPS)]).cpu()
    plain_s = time.time() - t0
    with torch.inference_mode():
        plain_psnr = psnr(plain_inference(plain, coords), plain_sampler.image.reshape(-1, 3))
    p_first, p_last10 = float(plain_losses[0]), float(plain_losses[-10:].mean())
    print(f"plain versions: {FIT_STEPS} steps in {plain_s:.2f} s; loss {p_first:.4f} -> "
          f"{p_last10:.4f} ({p_last10 / p_first:.4f}x); PSNR {plain_psnr:.2f} dB")
    check(last10 < 0.2 * first, f"loss floor missed: {last10} >= 0.2 x {first}")
    check(fit_psnr > 20.0, f"PSNR floor missed: {fit_psnr:.2f} dB")

    loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                          LOOP_STEPS)   # replays fit's captured step
    t = slice_times("config_hash", tmodel, x, target, loop)
    replaces = {
        "G": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel); "
             "tcnn_tpu/ops/pallas/grid_matmul.py:734 (_gather_kernel_xor)",
        "M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
        "GB": "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel); "
              "tcnn_tpu/ops/pallas/grid_matmul.py:602 (_scatter_kernel_xor)",
        "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    # launches: the training path's counts (slice 2's main path); G and M
    # also ran in the inference path, whose counts are kept beside them.
    return report_entries("", t, replaces, train_launches,
                          {"G": g_err, "M": m_err, "GB": gb_err, "MB": mb_err}, inf_launches)


def config_btf_slice(gen, dev):
    """Slice 3 on config_btf: kernel checks at its shapes, its serving and
    training paths, the fit and the times; returns the report entries."""
    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.common import HashType
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_fwd,
                                                     grid_encode_plain)
    from tcnn_tpu_torch.samples.fit_btf import batch_sampler, evaluate
    from tcnn_tpu_torch.tools.plain_path import plain_inference, plain_training_step

    btf = create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY)
    benc, net = btf.network.encoding, btf.network.network
    grid = benc.nested[0]
    spec = grid.spec
    live = list(range(spec.n_levels))
    check(spec.n_params == BTF_GRID_PARAMS and spec.n_dims == 4
          and spec.hash_type == HashType.COHERENT_ADD,
          f"config_btf grid: {spec.n_params} parameters, {spec.n_dims}-D, {spec.hash_type}")
    check([tuple(w.shape) for w in net.layers] == mlp_dims(40, 64, 3),
          f"config_btf MLP {[tuple(w.shape) for w in net.layers]}")
    with torch.no_grad():
        grid.grid.uniform_(-1, 1, generator=gen)
    print(f"config_btf: {btf.trainer.n_params()} parameters, grid of "
          f"{spec.n_entries} rows (levels 0-1 dense, {spec.levels[0].size} and "
          f"{spec.levels[1].size} rows; levels 2-15 hashed, {spec.levels[2].size} rows)")
    # x of the BTF path: the grid reads columns 0-3 of a (B, 6) tensor.
    x6 = torch.rand((MAIN_BATCH, 6), generator=gen, device=dev)
    xg = x6[:, :4]
    check(not xg.is_contiguous(), "the grid's input is expected to be a strided view")

    phase("config_btf: grid encode (G) vs plain on a strided (B, 6) slice")
    g_err = 0.0
    sum_atol = ((1 << spec.n_dims) + 2 * spec.n_dims) * 2.0 ** -24   # see the docstring
    for dtype in (torch.float32, torch.bfloat16):
        table = grid.grid.detach().to(dtype)
        for soa in (False, True):
            with torch.inference_mode():
                got = grid_encode_fwd(spec, table, xg, live, soa=soa)
                torch.cuda.synchronize()
                want = grid_encode_plain(spec, table, xg, live, soa=soa)
            abs_err, rel_err = compare(got, want, "grid-bf16" if dtype == torch.bfloat16
                                       else "grid-f32", atol=sum_atol)
            g_err = max(g_err, abs_err)
            print(f"B={MAIN_BATCH} table={str(dtype)[6:]} {'SoA' if soa else 'AoS'}: "
                  f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
                  f"({f'one bf16 ulp + {sum_atol:.3e}' if dtype == torch.bfloat16 else 'rtol 1e-5, atol 1e-6'})")

    phase("config_btf: grid backward (GB) vs plain on the strided slice; the "
          "CoherentPrime grid of the same geometry (row 11's configuration)")
    gb_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        table = grid.grid.detach().to(dtype)
        # the model's layout: columns 0-31 of MB's (B, 40) input gradient
        dfull = torch.randn((MAIN_BATCH, 40), generator=gen, device=dev).to(dtype)
        dc = dfull[:, :spec.n_output_dims].t()
        err = grid_bwd_case(spec, table, xg, dc, f"B={MAIN_BATCH} dcols (B, 40)[:, :32].t()")
        gb_err = max(gb_err, err) if dtype == torch.bfloat16 else gb_err
    prime = grid_ops.make_grid_spec(4, 16, 2, 19, 16, 1.5, hash_type=HashType.COHERENT_PRIME)
    check(sum(lv.use_hash for lv in prime.levels) == 14 and prime.n_params == BTF_GRID_PARAMS,
          "CoherentPrime grid geometry")
    prime_table = torch.zeros(prime.n_params, dtype=torch.bfloat16, device=dev)
    prime_dc = torch.randn((prime.n_output_dims, MAIN_BATCH), generator=gen,
                           device=dev).to(torch.bfloat16)
    gb_prime_err = grid_bwd_case(prime, prime_table, xg, prime_dc,
                                 f"CoherentPrime 4-D, 2^19-row levels, B={MAIN_BATCH}")
    with torch.inference_mode():
        gb_prime_ms = graph_ms(lambda: grid_encode_bwd(prime, prime_table, xg, prime_dc, live))
    print(f"GB on the CoherentPrime grid: {gb_prime_ms:.4f} ms on the device")

    phase("config_btf: fused MLP (M) and its backward (MB) vs plain, 40 -> 64 x 3 -> 3")
    m_err = mb_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        err = mlp_case(gen, dev, mlp_dims(40, 64, 3), MAIN_BATCH, dtype, soa_in=False)
        m_err = max(m_err, err) if dtype == torch.bfloat16 else m_err
        err = mlp_bwd_case(gen, dev, mlp_dims(40, 64, 3), MAIN_BATCH, dtype, soa_in=False,
                           flips=True)
        mb_err = max(mb_err, err) if dtype == torch.bfloat16 else mb_err

    phase(f"slice 3: one config_btf request of {MAIN_BATCH} through "
          "model.trainer.inference (BF16_POLICY)")
    torch.cuda.synchronize()
    reset_counts()
    y = btf.trainer.inference(x6)
    torch.cuda.synchronize()
    inf_launches = counts()
    check(inf_launches == {"G": 1, "M": 1, "GB": 0, "MB": 0},
          f"config_btf request launches {inf_launches}, expected G and M once")
    check(y.shape == (MAIN_BATCH, 3) and y.dtype == torch.float32, f"answer {tuple(y.shape)}")
    with torch.inference_mode():
        abs_err, _ = compare(y, plain_inference(btf, x6), "model")
    print(f"request: ({MAIN_BATCH}, 3) float32, max abs err {abs_err:.3e} vs plain path "
          f"(rtol 2e-2, atol 2e-3); launches {inf_launches}")

    phase("slice 3: one config_btf training step, gradients vs the plain path")
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    check_step_gradients(btf, x6, target, flips=True)
    # The training path: counts set to 0 here, read after the fit loop.
    torch.cuda.synchronize()
    reset_counts()
    step_loss = btf.trainer.training_step(x6, target)
    torch.cuda.synchronize()
    check(counts() == {"G": 1, "M": 1, "GB": 1, "MB": 1},
          f"training step launches {counts()}, expected one of each kernel")
    check(bool(torch.isfinite(step_loss)), "training step loss is not finite")
    print(f"training_step: loss {step_loss.item():.6f}; launches {counts()}")

    phase(f"slice 3: {FIT_STEPS} steps of make_training_loop at B={MAIN_BATCH} "
          "on synthetic_btf, CUDA graph replay")
    fit = create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY)
    fit_loop = fit.trainer.make_training_loop(batch_sampler(MAIN_BATCH, dev), FIT_STEPS)
    t0 = time.time()
    fit_losses = fit_loop()
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    train_launches = counts()   # the step, the loop's warm-up and its capture
    check(train_launches == {"G": 3, "M": 3, "GB": 3, "MB": 3},
          f"training path launches {train_launches}, expected 3 of each kernel")
    fit_losses = fit_losses.cpu()
    check(bool(torch.isfinite(fit_losses).all()), "non-finite training loss")
    first, last10 = float(fit_losses[0]), float(fit_losses[-10:].mean())
    mse, rel = evaluate(fit.trainer.inference, dev)
    _, rel_zero = evaluate(lambda x: x.new_zeros((x.shape[0], 3)), dev)
    print(f"kernels: {FIT_STEPS} steps in {fit_s:.2f} s (capture included); loss "
          f"{first:.4f} -> {last10:.4f} (mean of the last 10, {last10 / first:.4f}x); "
          f"held-out MSE {mse:.6f}, relL2 {rel:.6f} (zero prediction {rel_zero:.6f}); "
          f"training-path launches {train_launches}")
    plain = create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY)
    plain_batches = batch_sampler(MAIN_BATCH, dev)
    t0 = time.time()
    plain_losses = torch.stack([plain_training_step(plain, *plain_batches(i))
                                for i in range(PLAIN_BTF_STEPS)]).cpu()
    plain_s = time.time() - t0
    with torch.inference_mode():
        p_mse, p_rel = evaluate(lambda x: plain_inference(plain, x), dev)
    p_first, p_last10 = float(plain_losses[0]), float(plain_losses[-10:].mean())
    print(f"plain versions: {PLAIN_BTF_STEPS} steps in {plain_s:.2f} s; loss {p_first:.4f} -> "
          f"{p_last10:.4f} ({p_last10 / p_first:.4f}x); held-out MSE {p_mse:.6f}, "
          f"relL2 {p_rel:.6f}")
    for who, f, l10, r in (("kernels", first, last10, rel), ("plain", p_first, p_last10, p_rel)):
        check(l10 < BTF_LOSS_RATIO * f, f"{who}: BTF loss floor missed: {l10} >= "
              f"{BTF_LOSS_RATIO} x {f}")
        check(r < BTF_REL_FLOOR, f"{who}: BTF relL2 floor missed: {r} >= {BTF_REL_FLOOR}")

    loop = fit.trainer.make_training_loop(batch_sampler(MAIN_BATCH, dev, seed=1),
                                          LOOP_STEPS)   # replays fit's captured step
    t = slice_times("config_btf", btf, x6, target, loop)
    replaces = {
        "G": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel)",
        "M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
        "GB": "tcnn_tpu/ops/pallas/scatter.py:576 (_pair_kernel); "
              "tcnn_tpu/ops/pallas/scatter.py:392 (_weighted_kernel); "
              "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel)",
        "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    return report_entries(" (config_btf)", t, replaces, train_launches,
                          {"G": g_err, "M": m_err, "GB": max(gb_err, gb_prime_err),
                           "MB": mb_err}, {k: inf_launches[k] for k in ("G", "M")})


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from tcnn_tpu_torch.ops.cuda import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    t_start = time.time()
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

    report = {"kernels": config_hash_slices(gen, dev) + config_btf_slice(gen, dev)}
    phase("kernels")
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tcnn_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, and drives the port's two
paths on config_hash at full width: serving requests through
``model.trainer.inference`` (slice 1) and training through
``model.trainer.training_step`` and ``make_training_loop`` (slice 2),
each with the launch counts set to 0 just before it and read just after.
It times the kernels, a request and a training step, and prints:

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
  * grid backward (table gradient): per table entry, with S = Σ|w·dy|
    over its updates, |d| <= 2^-11·S, plus one bf16 ulp of ref for bf16
    tables.  Both sides sum in fp32 in an arbitrary order (atomics); n
    terms in two orders differ by at most (n − 1)·2^-24·S, and 2^-11
    covers n up to 8192, twice what a level-0 row takes at 2^18.
  * fused-MLP backward: every dW and dx within 1e-4 (fp32) or 2e-2
    (bf16) of its largest magnitude: sums over the batch in another order,
    and in bf16 a dz may round to the other neighbour.
  * training step: the gradients of the step within the MLP-backward
    tolerance of the plain path's on the same tensors.
  * image fit (200 steps at 2^18 on synthetic_image(1024, 1024)): mean
    loss of the last 10 steps below 0.2x the first step's, and PSNR of the
    whole image above 20 dB, the floors of tests/test_trainer.py.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = "configs/config_hash.json"
MAIN_BATCH = 1 << 18
FIT_STEPS = 200
LOOP_STEPS = 100     # the timed make_training_loop call
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


def plain_loss_and_grads(model, x, target):
    """The training loss and its gradients, by the trainer's parameter
    names, through the plain versions of G, M, MB and GB on the same
    tensors (the plain path of one training step)."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd_plain, fused_mlp_plain
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd_plain,
                                                     grid_encode_plain)

    enc, net, pol = model.network.encoding, model.network.network, model.network.policy
    live = list(range(enc.spec.n_levels))
    table = enc.grid.detach().to(pol.compute_dtype)
    ws = [w.detach() for w in net.layers]
    feats = grid_encode_plain(enc.spec, table, x, live, soa=True).to(pol.compute_dtype)
    pred = fused_mlp_plain(ws, feats, net.activation, net.output_activation,
                           pol.compute_dtype, pol.output_dtype, True, False)
    pred = pred.float().requires_grad_()
    loss = model.loss(pred, target)
    (dy,) = torch.autograd.grad(loss, pred)
    dws, dfeats = fused_mlp_bwd_plain(ws, feats, dy, net.activation,
                                      net.output_activation, pol.compute_dtype,
                                      True, False)
    grads = {"encoding.grid": grid_encode_bwd_plain(enc.spec, table, x, dfeats,
                                                    live).float()}
    grads.update({f"network.layers.{i}": d for i, d in enumerate(dws)})
    return loss.detach(), grads


def plain_training_step(model, x, target):
    """One training step through the plain versions (and the port's Adam)."""
    loss, grads = plain_loss_and_grads(model, x, target)
    model.optimizer.step(model.trainer.opt_state, grads, model.trainer.params())
    return loss


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from tcnn_tpu_torch import BF16_POLICY, DEFAULT_POLICY, create_from_config
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda import kernels
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd,
                                                     grid_encode_bwd_plain,
                                                     grid_encode_fwd,
                                                     grid_encode_plain)
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
    from tcnn_tpu_torch.utils.metrics import psnr

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
                with torch.inference_mode():
                    got = grid_encode_bwd(spec, table, x, dc, live)
                    torch.cuda.synchronize()
                    want = grid_encode_bwd_plain(spec, table, x, dc, live)
                    scale = grid_encode_bwd_plain(spec, table.float(), x,
                                                  dc.float().abs(), live)
                abs_err = compare_table_grad(got, want, scale)
                if dtype == torch.bfloat16:
                    gb_err = max(gb_err, abs_err)
                print(f"B={batch} table={str(dtype)[6:]} dcols {layout}: max abs err "
                      f"{abs_err:.3e} (2^-11·S{' + one bf16 ulp' if dtype == torch.bfloat16 else ''})")

    phase("fused-MLP backward (MB) vs plain")
    mb_err = 0.0

    def mlp_bwd_case(width, batch, dtype, soa_in=True, soa_out=False):
        dims = [(32, width), (width, width), (width, 3)]
        ws = [(torch.rand(d, generator=gen, device=dev) * 2 - 1)
              * float(np.sqrt(6.0 / sum(d))) for d in dims]
        x = torch.rand((32, batch) if soa_in else (batch, 32), generator=gen,
                       device=dev) * 2 - 1
        g = torch.randn((3, batch) if soa_out else (batch, 3), generator=gen, device=dev)
        args = (ws, x.to(dtype), g, Activation.RELU, Activation.NONE, dtype, soa_in, soa_out)
        with torch.inference_mode():
            got_dws, got_dx = fused_mlp_bwd(*args)
            torch.cuda.synchronize()
            want_dws, want_dx = fused_mlp_bwd_plain(*args)
        check(got_dx.dtype == dtype, f"MB: dx dtype {got_dx.dtype}")
        err = compare_mlp_grads([*got_dws, got_dx], [*want_dws, want_dx], dtype, "MB")
        print(f"W={width} B={batch} {str(dtype)[6:]} in={'SoA' if soa_in else 'AoS'} "
              f"out={'SoA' if soa_out else 'AoS'}: max abs err {err:.3e} over dW and dx "
              f"({'2e-2' if dtype == torch.bfloat16 else '1e-4'} of each max)")
        return err

    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        for dtype in (torch.bfloat16, torch.float32):
            err = mlp_bwd_case(64, batch, dtype)
            if dtype == torch.bfloat16:
                mb_err = max(mb_err, err)
    for width in (16, 32, 128):
        for dtype in (torch.bfloat16, torch.float32):
            mlp_bwd_case(width, 4133, dtype, soa_in=False, soa_out=True)

    counters = {"G": grid_encode_fwd, "M": fused_mlp_fwd, "GB": grid_encode_bwd,
                "MB": fused_mlp_bwd}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    phase("slice 2: one training step through model.trainer (BF16_POLICY), "
          "gradients vs the plain path")
    tmodel = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    with torch.no_grad():
        tmodel.network.encoding.grid.uniform_(-1, 1, generator=gen)
    x = torch.rand((MAIN_BATCH, 2), generator=gen, device=dev)
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    loss, grads = tmodel.trainer.loss_value_and_grads(x, target)
    want_loss, want_grads = plain_loss_and_grads(tmodel, x, target)
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

    phase(f"times at B={MAIN_BATCH}: kernels, library calls and whole steps as device "
          f"time in a CUDA graph of {N_TIMED} calls; plain versions eager")
    x = xs[0]
    bf16, relu, out_act = torch.bfloat16, net.activation, net.output_activation
    table = enc.grid.detach().to(bf16)
    ws = [w.detach().to(bf16) for w in net.layers]
    with torch.inference_mode():
        feats = grid_encode_fwd(spec, table, x, live, soa=True)
        mlp_args = (ws, feats, relu, out_act, bf16, torch.float32, True, False)

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

    # The training step's parts on the same batch: the loss and its
    # gradient, MB on that gradient, GB on MB's input gradient, Adam.
    with torch.no_grad():
        pred = fused_mlp_fwd(*mlp_args)

    def loss_call():
        p = pred.detach().requires_grad_()
        return torch.autograd.grad(tmodel.loss(p, target), p)[0]

    dy = loss_call()
    with torch.inference_mode():
        mb_args = (ws, feats, dy, relu, out_act, bf16, True, False)
        dfeats = fused_mlp_bwd(*mb_args)[1]
        f_in = feats.t()
        z0 = f_in @ ws[0]
        h0 = torch.relu(z0)
        z1 = h0 @ ws[1]
        h1 = torch.relu(z1)

        def mb_call():
            return fused_mlp_bwd(*mb_args)

        def gb_call():
            return grid_encode_bwd(spec, table, x, dfeats, live)

        def library_bwd():   # the chain's backward on its saved activations (cuBLAS)
            dz = dy.to(bf16)
            dw2, dh = h1.t() @ dz, dz @ ws[2].t()
            dz = dh * (z1 > 0)
            dw1, dh = h0.t() @ dz, dz @ ws[1].t()
            dz = dh * (z0 > 0)
            return dw2, dw1, f_in.t() @ dz, dz @ ws[0].t()

        mb_ms, mb_call_ms = graph_ms(mb_call), time_ms(mb_call)
        mb_plain_ms = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
        mb_lib_ms = graph_ms(library_bwd)
        gb_ms, gb_call_ms = graph_ms(gb_call), time_ms(gb_call)
        gb_plain_ms = eager_ms(lambda: grid_encode_bwd_plain(spec, table, x, dfeats, live))

    trainer = tmodel.trainer
    _, step_grads = trainer.loss_value_and_grads(x, target)
    loss_ms = graph_ms(loss_call)
    adam_ms = graph_ms(lambda: tmodel.optimizer.step(trainer.opt_state, step_grads,
                                                     trainer.params()))
    step_ms = time_ms(lambda: trainer.training_step(x, target))
    step_device_ms = graph_ms(lambda: trainer.training_step(x, target))
    loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                          LOOP_STEPS)   # replays fit's captured step
    loop_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop_losses = loop()
        torch.cuda.synchronize()
        loop_times.append((time.perf_counter() - t0) * 1e3 / LOOP_STEPS)
    check(bool(torch.isfinite(loop_losses).all()), "non-finite loss in the timed loop")
    loop_step_ms = float(np.median(loop_times))

    # Least time for the same work: each input read once, each output
    # written once, over HBM; operations over the peak of their type.
    L, F, D, C = spec.n_levels, spec.n_features_per_level, spec.n_dims, 1 << spec.n_dims
    consts_bytes = L * grid_ops.LEVEL_FIELDS * 4
    g_bytes = nbytes(x, table, feats) + consts_bytes
    # per (sample, level): x·scale + 0.5 and fract (3D), 1 − w (D), corner
    # weights C(D − 1), weighted sum 2CF (GB: w·dy and the add, also 2CF)
    g_flops = MAIN_BATCH * L * (4 * D + C * (D - 1) + 2 * C * F)
    g_bound = max(g_bytes / PEAK_BYTES, g_flops / PEAK_FP32) * 1e3
    y_bytes = MAIN_BATCH * net.n_output_dims * 4
    m_bytes = nbytes(feats, *ws) + y_bytes
    m_flops = 2 * MAIN_BATCH * sum(w.numel() for w in ws)
    m_bound = max(m_bytes / PEAK_BYTES, m_flops / PEAK_BF16) * 1e3
    # GB: x, dcols and the level constants in, the bf16 table gradient out.
    gb_bytes = nbytes(x, dfeats, table) + consts_bytes
    gb_bound = max(gb_bytes / PEAK_BYTES, g_flops / PEAK_FP32) * 1e3
    # MB: input, output gradient and weights in; input gradient and fp32 dW
    # out.  Products: the recomputed forward, the dgrad and the wgrad chains.
    mb_bytes = nbytes(feats, dy, *ws, dfeats) + sum(w.numel() for w in ws) * 4
    mb_flops = 3 * m_flops
    mb_bound = max(mb_bytes / PEAK_BYTES, mb_flops / PEAK_BF16) * 1e3
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
    print(f"GB: {gb_ms:.4f} ms on the device, {gb_call_ms:.4f} ms per call with the "
          f"host's work (plain {gb_plain_ms:.4f} ms, bound {gb_bound:.4f} ms: "
          f"{gb_bytes / 1e6:.2f} MB, {g_flops / 1e9:.3f} GFLOP fp32)")
    print(f"MB: {mb_ms:.4f} ms on the device, {mb_call_ms:.4f} ms per call with the "
          f"host's work (plain {mb_plain_ms:.4f} ms, cuBLAS chain backward "
          f"{mb_lib_ms:.4f} ms, bound {mb_bound:.4f} ms: {mb_bytes / 1e6:.2f} MB, "
          f"{mb_flops / 1e9:.3f} GFLOP bf16)")
    parts = {"G": g_ms, "M": m_ms, "loss and its gradient": loss_ms, "MB": mb_ms,
             "GB": gb_ms, "Adam": adam_ms}
    parts["casts, gaps and the rest"] = step_device_ms - sum(parts.values())
    print(f"training step at B={MAIN_BATCH}: {step_ms:.4f} ms eager with the host's "
          f"work, {step_device_ms:.4f} ms of device work (idle share "
          f"{1 - step_device_ms / step_ms:.3f}); split: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    print(f"make_training_loop at B={MAIN_BATCH}: {loop_step_ms:.4f} ms per step "
          f"(median of 3 calls of {LOOP_STEPS} steps), "
          f"{MAIN_BATCH / loop_step_ms * 1e3:.4e} training samples/s, idle share "
          f"{1 - step_device_ms / loop_step_ms:.3f}")

    def bound_by(n_bytes, flops, peak):
        return "bytes" if n_bytes / PEAK_BYTES >= flops / peak else "operations"

    phase("kernels")
    report = {"kernels": [
        {"name": "grid_encode_fwd", "route": "cuda",
         "source": "tcnn_tpu_torch/csrc/grid_encode.cu",
         "replaces": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel); "
                     "tcnn_tpu/ops/pallas/grid_matmul.py:734 (_gather_kernel_xor)",
         "launches": train_launches["G"], "max_abs_err": g_err, "ms": g_ms,
         "plain_ms": g_plain_ms, "bound_ms": g_bound,
         "bound_by": bound_by(g_bytes, g_flops, PEAK_FP32), "library_ms": None},
        {"name": "fused_mlp_fwd", "route": "cuda",
         "source": "tcnn_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
         "launches": train_launches["M"], "max_abs_err": m_err, "ms": m_ms,
         "plain_ms": m_plain_ms, "bound_ms": m_bound,
         "bound_by": bound_by(m_bytes, m_flops, PEAK_BF16), "library_ms": m_lib_ms},
        {"name": "grid_encode_bwd", "route": "cuda",
         "source": "tcnn_tpu_torch/csrc/grid_encode_bwd.cu",
         "replaces": "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel); "
                     "tcnn_tpu/ops/pallas/grid_matmul.py:602 (_scatter_kernel_xor)",
         "launches": train_launches["GB"], "max_abs_err": gb_err, "ms": gb_ms,
         "plain_ms": gb_plain_ms, "bound_ms": gb_bound,
         "bound_by": bound_by(gb_bytes, g_flops, PEAK_FP32), "library_ms": None},
        {"name": "fused_mlp_bwd", "route": "cuda",
         "source": "tcnn_tpu_torch/csrc/fused_mlp_bwd.cu",
         "replaces": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)",
         "launches": train_launches["MB"], "max_abs_err": mb_err, "ms": mb_ms,
         "plain_ms": mb_plain_ms, "bound_ms": mb_bound,
         "bound_by": bound_by(mb_bytes, mb_flops, PEAK_BF16), "library_ms": mb_lib_ms},
    ]}
    # launches: the training path's counts (this slice's main path); G and M
    # also ran in the inference path, whose counts are kept beside them.
    for k in report["kernels"][:2]:
        k["launches_inference"] = inf_launches["G" if k["name"] == "grid_encode_fwd" else "M"]
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

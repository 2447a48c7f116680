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
    of 2^18 and training, the same entry points (slice 3);
  * config_oneblob (OneBlob of 64 bins into a FullyFusedMLP 128 x 5, the
    shape kernel MB takes at half tiles): M and MB against their plain
    versions at B = 2^18, one training step's gradients against the plain
    path, and 300 steps of ``make_training_loop`` on the image, with a
    loss floor from the JAX package's run of the same fit (slice 6);
  * the SDF sample (3-D Smoothstep hash grid 8 x 2, 2^15-row tables,
    FullyFusedMLP 64 x 2, 16 -> 1, fp32): kernels GI, GG and RS against
    their plain versions at B = 2^18 (f32 and bf16 tables; RS also at
    F in {1, 2, 4, 8} and as row 10's column streams), one eikonal step's
    gradients against the plain eikonal step, and the sample's fit,
    ``samples/fit_sdf_eikonal.main``, 500 steps at 2^14 through
    ``create_from_config``, ``model.network`` and ``model.optimizer``: the
    second-order main path, whose per-step launch counts of G, M, MB, GB,
    GI, GG and RS it checks (slice 4; GB once a step, and none in
    ``Module.input_gradient``: a table gradient the engine would drop is
    not computed).  RS is also held on the eikonal step's own (rows, g);
  * the NeRF field sample (slice 8: a 3-D HashGrid of 12 levels x 2,
    2^17-row tables, into a FullyFusedMLP 64 x 1, 24 -> 16; a Composite of
    Identity and SphericalHarmonics into a FullyFusedMLP 64 x 2, 31 -> 3,
    Sigmoid; BF16_POLICY): G and GB under per-sample level masks, and M
    and MB at the two nets' shapes, against their plain versions at the
    sample's 2^12 rays x 48 samples = 196,608 points; one training step's
    gradients of both nets against the plain path's; a step's launches (G
    1, M 2, GB 1, MB 2); the sample's fit, ``samples/fit_nerf_field.main``
    at its defaults (400 steps, coarse-to-fine over the first 100), the
    main path, with a PSNR floor; then the image sample,
    ``samples/mlp_learning_an_image.main``, 100 steps into a temporary
    directory.
It times the kernels, a request and a training step of both, the eikonal
step (eager, and on the device from a captured CUDA graph) and its
kernels, checks that two launches of kernel MB on the same inputs give
the same dW bits (SDF and config_btf shapes, both compute dtypes), and
prints:

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
    ulps of it.  config_hash keeps the bound of one ulp, which it meets;
    the NeRF grid (3-D) takes config_btf's with D = 3, 8.3e-7.
  * fused MLP, float32: rtol 1e-5, atol 1e-5; bfloat16: rtol 2e-2,
    atol 2e-3 (a hidden activation may round to the other bf16
    neighbour when the sum is taken in another order).  At config_oneblob's
    six layers such roundings compound: there, and only in bf16, an
    output row beyond the bound passes when
    ``tools.plain_path.rounding_flip_rows`` explains it (the plain version
    with one or two hidden values that lie within 2^-16 of Σ|h·w| of a
    bf16 rounding midpoint rounded the other way lies within the bound of
    that row); each such row is printed.
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
  * grid input gradient (GI) and second order (GG): each output within
    1e-5 of its largest magnitude (fp32 sums over corners and levels in
    another order; GG's corner rows equal); row scatter-add (RS): per
    entry within 2^-11·S, S = Σ|g| over its updates, plus one bf16 ulp
    for a bf16 result (fp32 atomics in any order, as GB).
  * eikonal step: the table gradient per entry within 2^-11·S (S the
    magnitudes of the GB and RS terms it sums), the weights' gradients
    within 1e-4 of their largest magnitude, of the plain eikonal step's.
    A sample whose fp32 pre-activation lies within rounding of 0 may
    switch its ReLU in kernel MB and not in the plain version: its MB dx
    row passes where ``relu_flip_rows`` explains it at 2^-16 of Σ|h·w|,
    and the plain step takes the flipped row (as config_btf in bf16).
  * config_oneblob fit (300 steps at 2^18): mean loss of the last 100
    steps below 0.1, and PSNR above 20 dB; the JAX package's run of the
    same fit (``ONEBLOB_LOSS_FLOOR`` says which) read 0.009874 at step 200
    and 0.006309 at step 300, PSNR 29.68 dB.
  * SDF fit (500 steps at 2^14, the JAX sample's run): mean loss of the
    last 10 steps below 0.05 and mean |sdf error| on 2^14 points in
    [0.2, 0.8]^3 below 0.1.  The JAX sample on the CPU ends at loss
    0.017435 and error 0.0675; an untrained model's loss is about 0.0997,
    and a zero prediction's error 0.0667, so the error floor only guards
    against divergence.

  * NeRF: masked G and GB at the grid bounds above (the plain version
    multiplies the masked pairs' weights by 0, as the JAX package does;
    the kernels skip them: a masked pair's output is an exact 0, and a row
    only masked pairs touch gets no update); M and MB at the MLP bounds,
    bf16 dx rows as config_btf's; the step's gradients within 2e-2 of each
    one's largest magnitude of the plain path's (``plain_nerf_loss_and_grads``).
    The fit: eval PSNR above ``NERF_PSNR_FLOOR``, the JAX sample's CPU run
    at the same settings (fp32) less 3 dB.  The image sample: PSNR above
    20 dB after 100 steps.

The whole run takes about four minutes on an H100, against the 1200 s a
run may take: the build of the seven kernels took 93 to 155 s, the
plain versions' BTF fit, 150 eager steps (the kernels' fit runs 200), 30
to 45 s, the NeRF fit 4 to 5 s.  It prints its own time before the
kernels' line.
"""

import json
import os
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
# FLOP/s, fp32 FLOP/s outside the tensor cores (the FMA units).
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
UNIT = {PEAK_BF16: "bf16 tensor cores", PEAK_FP32: "fp32 FMA"}


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


def touched_bytes(spec, x, elem):
    """The bytes of the table rows that the batch x touches (all levels)."""
    from tcnn_tpu_torch.ops import grid_ops

    idx, _ = grid_ops.build_indices_weights(spec, x, list(range(spec.n_levels)))
    touched = torch.zeros(spec.n_entries, dtype=torch.bool, device=x.device)
    touched[idx.reshape(-1)] = True
    return int(touched.sum()) * spec.n_features_per_level * elem


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


def compare_table_grad(got, want, scale, what="table grad"):
    """Max abs error of a table gradient or a row scatter-add (fp32 sums in
    any order); raises beyond 2^-11·S (+ one bf16 ulp for bf16 tables),
    S per entry the sum of the magnitudes of its terms (Σ|w·dy|, Σ|g|)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values")
    err = (g - w).abs()
    tol = 2.0 ** -11 * scale + 1e-30
    if want.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(w)
    bad = err > tol
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} entries beyond "
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
                       what="dx", dtype=torch.bfloat16):
    """An MLP input gradient in bf16 (or fp32) against the plain version's,
    one row per sample: within 2e-2 (1e-4) of its largest magnitude, but
    for rows that ``relu_flip_rows`` explains (a pre-activation lies within
    rounding of 0: 2^-7 (2^-16) of Σ|h·w|, and the plain version recomputed
    for these rows, with one or two ReLUs nearest 0 flipped or none, lies
    within that bound).  x and g are the plain version's MLP input and
    output gradient.  Returns (max abs err over the other rows, the
    explained rows' sample indices, their flipped variants in the rows'
    layout)."""
    from tcnn_tpu_torch.tools.plain_path import relu_flip_rows

    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    check(got.shape == want.shape, f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values")
    a, b = (got.t(), want.t()) if soa_in else (got, want)
    err = (a.float() - b.float()).abs()
    tol = rel * b.float().abs().max().item()
    rows = (err > tol).any(dim=1).nonzero().flatten()
    check(rows.numel() <= MAX_FLIP_ROWS, f"{what}: {rows.numel()} rows beyond {tol:.3e}")
    other = err.max(dim=1).values
    other[rows] = 0
    if not rows.numel():
        return other.max().item(), rows, a[rows].float()
    explained, variants, flipped, nearest = relu_flip_rows(
        ws, x, g, out_act, dtype, rows, a[rows], tol, soa_in, soa_out)
    for r, s, e, f, z in zip(range(10), rows.tolist(), err[rows].max(dim=1).values.tolist(),
                             flipped.tolist(), nearest.tolist()):
        fs = [f"{v:.3e}" for v in f if v == v]
        how = ("no flipped ReLU explains it" if not bool(explained[r]) else
               f"the plain row with the ReLU(s) at {', '.join(fs)} flipped matches it" if fs
               else "the plain row recomputed for these samples alone matches it")
        print(f"{what}: sample {s} off by {e / tol * rel:.3e} of the largest magnitude; "
              f"its pre-activation nearest 0 at |z| / Σ|h·w| = {z:.3e}; {how}")
    check(bool(explained.all()), f"{what}: {int((~explained).sum())} of {rows.numel()} "
          f"rows beyond {tol:.3e} not explained by a switched ReLU")
    print(f"{what}: {rows.numel()} of {a.shape[0]} rows beyond {rel:g} of the largest "
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


def compare_mlp_rows(got, want, ws, x, soa_in, what):
    """A bf16 MLP output against the plain version's, at the mlp-bf16
    bound, but for rows that another correct rounding explains: over five
    or more bf16 layers a hidden value that lies on a rounding boundary
    rounds either way in two correct sums, and the whole row moves.  Such
    a row passes when ``tools.plain_path.rounding_flip_rows`` finds the
    plain version, with one or two hidden values within 2^-16 of Σ|h·w| of
    a rounding midpoint rounded the other way, within the bound of that
    row in every entry; each is printed.  Returns (max abs err, max rel
    err) over the other rows."""
    from tcnn_tpu_torch.tools.plain_path import rounding_flip_rows

    check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shapes")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    tol = 2e-2 * w.abs() + 2e-3
    rows = (err > tol).any(dim=1).nonzero().flatten()
    check(rows.numel() <= MAX_FLIP_ROWS, f"{what}: {rows.numel()} rows beyond the bound")
    if rows.numel():
        explained, nearest = rounding_flip_rows(ws, x, rows, g[rows], tol[rows], soa_in)
        for s, r in enumerate(rows.tolist()[:10]):
            print(f"{what}: sample {r} off by {(err[r] / tol[r]).max().item():.3f} of its bound; "
                  f"its hidden value nearest a bf16 rounding midpoint at {nearest[s].item():.3e} "
                  f"of Σ|h·w|; {'explained' if bool(explained[s]) else 'not explained'} by "
                  f"another rounding")
        check(bool(explained.all()), f"{what}: {int((~explained).sum())} of {rows.numel()} "
              f"rows beyond the bound not explained by another rounding")
        print(f"{what}: {rows.numel()} of {g.shape[0]} rows beyond the bound, each explained "
              f"by another rounding")
        err[rows] = 0
    return err.max().item(), (err / w.abs().clamp_min(1e-6)).max().item()


def mlp_case(gen, dev, dims, batch, dtype, soa_in=True, soa_out=False, rounding=False,
             out_act=None):
    """Kernel M against its plain version; returns the max abs error.  With
    ``rounding`` (config_oneblob's six layers) a bf16 row beyond the bound
    passes where the plain version's rounding explains it
    (``compare_mlp_rows``).  ``out_act``: the output activation (None)."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_fwd, fused_mlp_plain

    ws = random_mlp(gen, dev, dims)
    d_in = dims[0][0]
    x = torch.rand((d_in, batch) if soa_in else (batch, d_in), generator=gen,
                   device=dev) * 2 - 1
    args = (ws, x.to(dtype), Activation.RELU, out_act or Activation.NONE, dtype,
            torch.float32, soa_in, soa_out)
    with torch.inference_mode():
        got = fused_mlp_fwd(*args)
        torch.cuda.synchronize()
        want = fused_mlp_plain(*args)
    if rounding and dtype == torch.bfloat16 and not soa_out:
        abs_err, rel_err = compare_mlp_rows(got, want, ws, args[1], soa_in, "M")
    else:
        abs_err, rel_err = compare(got, want,
                                   "mlp-bf16" if dtype == torch.bfloat16 else "mlp-f32")
    print(f"{d_in} -> {dims[0][1]} x {len(dims) - 1} -> {dims[-1][1]} B={batch} "
          f"{str(dtype)[6:]} in={'SoA' if soa_in else 'AoS'} "
          f"out={'SoA' if soa_out else 'AoS'}: max abs err {abs_err:.3e}, "
          f"max rel err {rel_err:.3e}")
    return abs_err


def mlp_bwd_case(gen, dev, dims, batch, dtype, soa_in=True, soa_out=False, flips=False,
                 out_act=None):
    """Kernel MB against its plain version; returns the max abs error.
    With ``flips`` (config_btf) a bf16 dx row beyond the bound passes where
    a switched ReLU explains it (``compare_input_grad``)."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_bwd_plain

    ws = random_mlp(gen, dev, dims)
    d_in, d_out = dims[0][0], dims[-1][1]
    out_act = out_act or Activation.NONE
    x = torch.rand((d_in, batch) if soa_in else (batch, d_in), generator=gen,
                   device=dev) * 2 - 1
    g = torch.randn((d_out, batch) if soa_out else (batch, d_out), generator=gen, device=dev)
    args = (ws, x.to(dtype), g, Activation.RELU, out_act, dtype, soa_in, soa_out)
    with torch.inference_mode():
        got_dws, got_dx = fused_mlp_bwd(*args)
        torch.cuda.synchronize()
        want_dws, want_dx = fused_mlp_bwd_plain(*args)
    check(got_dx.dtype == dtype, f"MB: dx dtype {got_dx.dtype}")
    if flips and dtype == torch.bfloat16:
        err = max(compare_mlp_grads(got_dws, want_dws, dtype, "MB"),
                  compare_input_grad(got_dx, want_dx, ws, args[1], g, out_act,
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
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_bwd_bwd,
                                                     grid_encode_bwd_input, grid_encode_fwd)
    from tcnn_tpu_torch.ops.cuda.scatter import row_scatter_add

    return {"G": grid_encode_fwd, "M": fused_mlp_fwd, "GB": grid_encode_bwd,
            "MB": fused_mlp_bwd, "GI": grid_encode_bwd_input, "GG": grid_encode_bwd_bwd,
            "RS": row_scatter_add}


FIRST_ORDER = ("G", "M", "GB", "MB")


def first_order_counts():
    """The counts of the first-order kernels, with a check that the
    second-order kernels GI, GG and RS were not launched."""
    c = counts()
    check(all(c[k] == 0 for k in ("GI", "GG", "RS")),
          f"a first-order path launched a second-order kernel: {c}")
    return {k: c[k] for k in FIRST_ORDER}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in counters().items()}


def chain_activations(ws, h):
    """The inputs of each layer of a ReLU MLP chain, from its input h."""
    hs = [h]
    for w in ws[:-1]:
        hs.append(torch.relu(hs[-1] @ w))
    return hs


def library_chain(ws, h, out=None):
    """The MLP's forward as cuBLAS products (and ``out``, the output
    activation), timed only as a yardstick."""
    for w in ws[:-1]:
        h = torch.relu(h @ w)
    return h @ ws[-1] if out is None else out(h @ ws[-1])


def library_bwd(ws, hs, dy):
    """The chain's backward on its saved activations ``hs``, as cuBLAS
    products, timed only as a yardstick."""
    dz, dws = dy.to(ws[0].dtype), []
    for i in range(len(ws) - 1, -1, -1):
        dws.append(hs[i].t() @ dz)
        dz = dz @ ws[i].t()
        if i:
            dz = dz * (hs[i] > 0)
    return dws, dz


LIBRARY = {"M": "cuBLAS chain", "MB": "cuBLAS chain backward", "RS": "index_add_"}


def record_bounds(t, b, notes=None):
    """Each kernel's bound from ``b`` (name: bytes moved, operations, peak
    of their type) into ``t``, printed beside the kernel's times in ``t``:
    device time, with the host's work where measured, plain version and
    library call."""
    for k, (n_bytes, flops, peak) in b.items():
        t[f"{k} bound"] = bound_ms(n_bytes, flops, peak)
        t[f"{k} bound by"] = bound_by(n_bytes, flops, peak)
        call = (f", {t[k + ' call']:.4f} ms per call with the host's work"
                if k + " call" in t else "")
        lib = f", {LIBRARY[k]} {t[k + ' library']:.4f} ms" if k + " library" in t else ""
        print(f"{k}: {t[k]:.4f} ms on the device{call} (plain {t[k + ' plain']:.4f} ms{lib}, "
              f"bound {t[k + ' bound']:.4f} ms: {n_bytes / 1e6:.2f} MB"
              f"{(notes or {}).get(k, '')}, {flops / 1e9:.3f} GFLOP on the {UNIT[peak]})")


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

        def request():
            return model.trainer.inference(x)

        t["G"], t["G call"] = graph_ms(g_call), time_ms(g_call)
        t["G plain"] = eager_ms(lambda: grid_encode_plain(spec, table, xg, live, soa=soa))
        t["M"], t["M call"] = graph_ms(m_call), time_ms(m_call)
        t["M plain"] = eager_ms(lambda: fused_mlp_plain(*mlp_args))
        t["M library"] = graph_ms(lambda: library_chain(ws, f_in))
        t["request device"], t["request"] = graph_ms(request), time_ms(request)
        t["table copy"] = graph_ms(lambda: grid.grid.detach().to(bf16))
        t["other encodings"] = sum(graph_ms(lambda e=e, b=b, nd=nd: e(x[:, b:b + nd]))
                                   for e, (b, nd) in zip(getattr(enc, "nested", ()),
                                                         getattr(enc, "slices", ()))
                                   if e is not grid)
        # the table rows this batch touches: the table bytes G must read
        g_table_bytes = touched_bytes(spec, xg, table.element_size())

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
        hs = chain_activations(ws, f_in)

        def mb_call():
            return fused_mlp_bwd(*mb_args)

        def gb_call():
            return grid_encode_bwd(spec, table, xg, dcols, live)

        t["MB"], t["MB call"] = graph_ms(mb_call), time_ms(mb_call)
        t["MB plain"] = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
        t["MB library"] = graph_ms(lambda: library_bwd(ws, hs, dy))
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
    record_bounds(t, b, {"G": f" with {g_table_bytes / 1e6:.2f} MB of touched table rows"})
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


KERNELS = {   # timing key: (report name, source)
    "G": ("grid_encode_fwd", "tcnn_tpu_torch/csrc/grid_encode.cu"),
    "M": ("fused_mlp_fwd", "tcnn_tpu_torch/csrc/fused_mlp.cu"),
    "GB": ("grid_encode_bwd", "tcnn_tpu_torch/csrc/grid_encode_bwd.cu"),
    "MB": ("fused_mlp_bwd", "tcnn_tpu_torch/csrc/fused_mlp_bwd.cu"),
    "GI": ("grid_encode_bwd_input", "tcnn_tpu_torch/csrc/grid_encode_bwd_input.cu"),
    "GG": ("grid_encode_bwd_bwd", "tcnn_tpu_torch/csrc/grid_encode_bwd_bwd.cu"),
    "RS": ("row_scatter", "tcnn_tpu_torch/csrc/row_scatter.cu"),
}


def report_entries(suffix, t, replaces, launches, errors, extra=None):
    """The {"kernels": [...]} entries of one path, one per kernel in
    ``replaces`` (timing key: the TPU kernel it replaces): launches from
    its main path's run, numbers from its timing (``slice_times``,
    ``sdf_slice``), and each field of ``extra`` (field: {key: value})."""
    out = []
    for k, replaced in replaces.items():
        name, source = KERNELS[k]
        entry = {"name": name + suffix, "route": "cuda", "source": source,
                 "replaces": replaced, "launches": launches[k],
                 "max_abs_err": errors[k], "ms": t[k], "plain_ms": t[k + " plain"],
                 "bound_ms": t[k + " bound"], "bound_by": t[k + " bound by"],
                 "library_ms": t.get(k + " library")}
        entry.update({field: v[k] for field, v in (extra or {}).items() if k in v})
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
    reset_counts()
    answers = []
    for i, x in enumerate(xs):
        y = model.trainer.inference(x)
        torch.cuda.synchronize()
        check(grid_encode_fwd.launches == i + 1 and fused_mlp_fwd.launches == i + 1,
              f"request {i}: launch counts G={grid_encode_fwd.launches} "
              f"M={fused_mlp_fwd.launches}, expected {i + 1} each")
        answers.append(y)
    inf_launches = first_order_counts()
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
    check(first_order_counts() == {"G": 1, "M": 1, "GB": 1, "MB": 1},
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
    train_launches = first_order_counts()
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
                          {"G": g_err, "M": m_err, "GB": gb_err, "MB": mb_err},
                          {"launches_inference": {k: inf_launches[k] for k in ("G", "M")}})


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
    inf_launches = first_order_counts()
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
    check(first_order_counts() == {"G": 1, "M": 1, "GB": 1, "MB": 1},
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
    train_launches = first_order_counts()   # the step, the loop's warm-up and its capture
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
                           "MB": mb_err},
                          {"launches_inference": {k: inf_launches[k] for k in ("G", "M")}})


ONEBLOB_CONFIG = "configs/config_oneblob.json"
ONEBLOB_STEPS = 300
# The JAX package's run of the same fit, `python samples/mlp_learning_an_image.py
# none configs/config_oneblob.json 300` on the CPU (BF16_POLICY, 2^18 samples a
# step, synthetic_image(1024, 1024)): loss 0.134945 at step 100, 0.009874 at
# 200, 0.006309 at 300, final PSNR 29.68 dB.  Adam at lr 1e-2 makes this MLP's
# loss spike now and then, so the floor on the mean of the last 100 steps is
# 10x the JAX run's loss at step 200; the PSNR floor is config_hash's, 20 dB.
ONEBLOB_LOSS_FLOOR = 0.1
ONEBLOB_PSNR_FLOOR = 20.0


def config_oneblob_slice(gen, dev):
    """configs/config_oneblob.json (OneBlob of 64 bins -> FullyFusedMLP 128
    x 5 -> 3, ReLU; BF16_POLICY), the MLP kernel MB takes at half tiles: M
    and MB against their plain versions at its shape in both dtypes, one
    training step's gradients against the plain path's, the fit through
    make_training_loop with the JAX package's loss as its floor, and the
    times.  Returns the report entries of M and MB at this shape."""
    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
    from tcnn_tpu_torch.utils.metrics import psnr

    model = create_from_config(2, 3, ONEBLOB_CONFIG, policy=BF16_POLICY)
    net = model.network.network
    dims = mlp_dims(128, 128, 5)
    check([tuple(w.shape) for w in net.layers] == dims,
          f"config_oneblob MLP {[tuple(w.shape) for w in net.layers]}")

    phase(f"config_oneblob: M and MB vs plain at 128 -> 128 x 5 -> 3, B={MAIN_BATCH}")
    err = {"M": 0.0, "MB": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        e_m = mlp_case(gen, dev, dims, MAIN_BATCH, dtype, soa_in=False, rounding=True)
        e_mb = mlp_bwd_case(gen, dev, dims, MAIN_BATCH, dtype, soa_in=False, flips=True)
        if dtype == torch.bfloat16:
            err = {"M": e_m, "MB": e_mb}

    phase("config_oneblob: one training step through model.trainer (BF16_POLICY), "
          "gradients vs the plain path")
    x = torch.rand((MAIN_BATCH, 2), generator=gen, device=dev)
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    check_step_gradients(model, x, target, flips=True)
    torch.cuda.synchronize()
    reset_counts()
    step_loss = model.trainer.training_step(x, target)
    torch.cuda.synchronize()
    check(first_order_counts() == {"G": 0, "M": 1, "GB": 0, "MB": 1},
          f"config_oneblob step launches {counts()}, expected M and MB once")
    check(bool(torch.isfinite(step_loss)), "config_oneblob step loss is not finite")

    phase(f"config_oneblob: {ONEBLOB_STEPS} steps of make_training_loop at B={MAIN_BATCH} "
          f"on synthetic_image(1024, 1024), CUDA graph replay")
    fit = create_from_config(2, 3, ONEBLOB_CONFIG, policy=BF16_POLICY)
    sampler = ImageSampler(synthetic_image(1024, 1024), seed=0)
    fit_loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                              ONEBLOB_STEPS)
    reset_counts()
    t0 = time.time()
    losses = fit_loop()
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = first_order_counts()   # the loop's eager warm-up step and its capture
    check(launches == {"G": 0, "M": 2, "GB": 0, "MB": 2},
          f"config_oneblob loop launches {launches}, expected M and MB twice")
    losses = losses.cpu()
    check(bool(torch.isfinite(losses).all()), "non-finite config_oneblob loss")
    first, last100 = float(losses[0]), float(losses[-100:].mean())
    coords = sampler.full_grid_coords()
    fit_psnr = psnr(fit.trainer.inference(coords), sampler.image.reshape(-1, 3))
    print(f"fit: {ONEBLOB_STEPS} steps in {fit_s:.2f} s (capture included); loss {first:.4f} "
          f"-> {last100:.6f} (mean of the last 100; floor {ONEBLOB_LOSS_FLOOR}, from the JAX "
          f"package's run); PSNR {fit_psnr:.2f} dB; launches {launches}")
    check(last100 < ONEBLOB_LOSS_FLOOR,
          f"config_oneblob loss floor missed: {last100} >= {ONEBLOB_LOSS_FLOOR}")
    check(fit_psnr > ONEBLOB_PSNR_FLOOR, f"config_oneblob PSNR floor missed: {fit_psnr:.2f} dB")

    phase(f"config_oneblob times at B={MAIN_BATCH}: M, MB, the step and the loop")
    bf16, relu, none = torch.bfloat16, net.activation, net.output_activation
    ws = [w.detach().to(bf16) for w in net.layers]
    t = {}
    with torch.no_grad():
        feats = model.network.encoding(x).to(bf16)
        m_args = (ws, feats, relu, none, bf16, torch.float32, False, False)
        pred = fused_mlp_fwd(*m_args)
    p = pred.detach().requires_grad_()
    (dy,) = torch.autograd.grad(model.loss(p, target), p)
    with torch.inference_mode():
        mb_args = (ws, feats, dy, relu, none, bf16, False, False)
        dfeats = fused_mlp_bwd(*mb_args)[1]
        hs = chain_activations(ws, feats)
        t["M"] = graph_ms(lambda: fused_mlp_fwd(*m_args))
        t["M plain"] = eager_ms(lambda: fused_mlp_plain(*m_args))
        t["M library"] = graph_ms(lambda: library_chain(ws, feats))
        t["MB"] = graph_ms(lambda: fused_mlp_bwd(*mb_args))
        t["MB plain"] = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
        t["MB library"] = graph_ms(lambda: library_bwd(ws, hs, dy))
        t["OneBlob"] = graph_ms(lambda: model.network.encoding(x))
    trainer = model.trainer
    t["step"] = time_ms(lambda: trainer.training_step(x, target))
    t["step device"] = graph_ms(lambda: trainer.training_step(x, target))
    loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                          LOOP_STEPS)   # replays fit's captured step
    loop_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        loop_times.append((time.perf_counter() - t0) * 1e3 / LOOP_STEPS)
    t["loop step"] = float(np.median(loop_times))
    m_flops = 2 * MAIN_BATCH * sum(w.numel() for w in ws)
    record_bounds(t, {
        "M": (nbytes(feats, *ws) + MAIN_BATCH * 3 * 4, m_flops, PEAK_BF16),
        "MB": (nbytes(feats, dy, *ws, dfeats) + sum(w.numel() for w in ws) * 4, 3 * m_flops,
               PEAK_BF16)})
    rest = t["step device"] - t["M"] - t["MB"] - t["OneBlob"]
    print(f"training step at B={MAIN_BATCH}: {t['step']:.4f} ms eager with the host's work, "
          f"{t['step device']:.4f} ms of device work (idle share "
          f"{1 - t['step device'] / t['step']:.3f}); split: M {t['M']:.4f} ms, MB "
          f"{t['MB']:.4f} ms, OneBlob {t['OneBlob']:.4f} ms, loss, Adam and the rest "
          f"{rest:.4f} ms")
    print(f"make_training_loop at B={MAIN_BATCH}: {t['loop step']:.4f} ms per step "
          f"(median of 3 calls of {LOOP_STEPS} steps), "
          f"{MAIN_BATCH / t['loop step'] * 1e3:.4e} training samples/s, idle share "
          f"{1 - t['step device'] / t['loop step']:.3f}")
    replaces = {"M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
                "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    return report_entries(" (config_oneblob)", t, replaces, launches, err)


SDF_FIT_STEPS = 500          # the JAX sample's default run: 500 steps at 2^14
SDF_FIT_BATCH_POW = 14
SDF_LOSS_FLOOR = 0.05        # see the docstring: JAX 0.017435, a zero model 0.1
SDF_ERROR_FLOOR = 0.1        # JAX 0.0675, a zero prediction 0.0667


def compare_rel(got, want, rel, what):
    """Max abs error; raises beyond ``rel`` of want's largest magnitude (a
    zero ``want`` needs a zero ``got``)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    lim = rel * want.float().abs().max().item()
    check(err <= lim, f"{what}: max abs err {err:.3e} beyond {lim:.3e}")
    return err


def sdf_flip_explained_bwd(net, xs, xv):
    """MB's plain version for the plain eikonal step, its two calls (the
    surface term, then x_vol) held row by row against kernel MB's input
    gradients in the kernel step (G, M and MB on the same x, as the step
    computes them), and each row that a switched fp32 ReLU explains
    (``compare_input_grad``) replaced by its flipped variant: at 2^18
    samples a pre-activation may lie within fp32 rounding of 0, and the
    switch moves that sample's whole share of the table gradient."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd)
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_fwd

    enc, mlp = net.encoding, net.network
    spec, ws = enc.spec, [w.detach() for w in mlp.layers]
    args = (mlp.activation, mlp.output_activation, torch.float32)
    live = list(range(spec.n_levels))
    kernel_dx = []
    with torch.no_grad():
        for x, surface in ((xs, True), (xv, False)):
            feats = grid_encode_fwd(spec, enc.grid.detach(), x, live, soa=True)
            y = fused_mlp_fwd(ws, feats, *args, torch.float32, True, False)
            dy = y * (2.0 / x.shape[0]) if surface else torch.ones_like(y)
            kernel_dx.append(fused_mlp_bwd(ws, feats, dy, *args, True, False)[1])

    def bwd(weights, x, g, act, out_act, cdt, soa_in, soa_out):
        dws, dx = fused_mlp_bwd_plain(weights, x, g, act, out_act, cdt, soa_in, soa_out)
        got = kernel_dx.pop(0)
        _, rows, variants = compare_input_grad(got, dx, weights, x, g, out_act, soa_in,
                                               soa_out, "eikonal step MB dx", cdt)
        dx = dx.clone()
        dx.t()[rows] = variants.to(dx.dtype)
        return dws, dx

    return bwd


def sdf_slice(gen, dev):
    """Slice 4, second order: kernels GI, GG and RS against their plain
    versions at the SDF sample's geometry, one eikonal step's gradients
    against the plain eikonal step, the sample's fit (the main path), and
    the times of the step and its kernels.  Returns the report entries."""
    from tcnn_tpu_torch import Policy, create_from_config
    from tcnn_tpu_torch.common import HashType, InterpolationType
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_bwd_plain,
                                                   fused_mlp_bwd_plain, fused_mlp_fwd,
                                                   fused_mlp_plain)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (
        grid_encode_bwd, grid_encode_bwd_bwd, grid_encode_bwd_bwd_plain,
        grid_encode_bwd_input, grid_encode_bwd_input_plain, grid_encode_bwd_plain,
        grid_encode_fwd, grid_encode_plain)
    from tcnn_tpu_torch.ops.cuda.scatter import (row_scatter_add, row_scatter_add_plain,
                                                 scatter_add_cols)
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.tools.plain_path import plain_sdf_loss_and_grads

    model = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
    net, opt = model.network, model.optimizer
    enc, mlp = net.encoding, net.network
    spec = enc.spec
    live = list(range(spec.n_levels))
    check(spec.n_dims == 3 and spec.n_levels == 8 and spec.n_features_per_level == 2
          and spec.interpolation == InterpolationType.SMOOTHSTEP
          and spec.hash_type == HashType.COHERENT_PRIME,
          f"SDF grid: {spec.n_dims}-D, {spec.n_levels} levels, {spec.interpolation}")
    check([tuple(w.shape) for w in mlp.layers] == mlp_dims(16, 64, 2, d_out=1),
          f"SDF MLP {[tuple(w.shape) for w in mlp.layers]}")
    print(f"SDF model: {net.n_params()} parameters, grid of {spec.n_entries} rows "
          f"({sum(not lv.use_hash for lv in spec.levels)} dense levels), fp32 policy")
    with torch.no_grad():   # O(1) features, as in the other slices' checks
        enc.grid.uniform_(-1, 1, generator=gen)
    B = MAIN_BATCH
    F, D = spec.n_features_per_level, spec.n_dims

    phase(f"SDF geometry: GI, GG and RS vs plain at B={B}, f32 and bf16 tables")
    x = torch.rand((B, D), generator=gen, device=dev) * 0.9 + 0.05
    ddx = torch.randn((B, D), generator=gen, device=dev)
    err = {"GI": 0.0, "GG": 0.0, "RS": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        table = enc.grid.detach().to(dtype)
        dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev).to(dtype)
        with torch.inference_mode():
            got = grid_encode_bwd_input(spec, table, x, dcols, live)
            torch.cuda.synchronize()
            e_gi = compare_rel(got, grid_encode_bwd_input_plain(spec, table, x, dcols, live),
                               1e-5, "GI dx")
            got = grid_encode_bwd_bwd(spec, table, x, dcols, ddx, live)
            torch.cuda.synchronize()
            want = grid_encode_bwd_bwd_plain(spec, table, x, dcols, ddx, live)
            check(torch.equal(got.rows, want.rows), "GG: corner rows differ from plain")
            e_gg = max(compare_rel(a, b, 1e-5, f"GG {n}") for n, a, b in
                       zip(("d_dcols", "d_x", "g"), got[:2] + got[3:], want[:2] + want[3:]))
            rs = row_scatter_add(got.rows, got.g, spec.n_entries, dtype)
            torch.cuda.synchronize()
            scale = row_scatter_add_plain(want.rows, want.g.abs(), spec.n_entries)
            e_rs = compare_table_grad(rs, row_scatter_add_plain(want.rows, want.g,
                                                                spec.n_entries, dtype),
                                      scale, "RS")
        if dtype == torch.float32:
            err = {"GI": e_gi, "GG": e_gg, "RS": e_rs}
        print(f"table={str(dtype)[6:]}: GI max abs err {e_gi:.3e}, GG {e_gg:.3e} (1e-5 of "
              f"each output's max; corner rows equal), RS on GG's {got.rows.numel()} "
              f"updates {e_rs:.3e} (2^-11·S{' + one bf16 ulp' if dtype == torch.bfloat16 else ''})")

    phase("RS vs plain: F in {1, 2, 4, 8} on random rows; row 10's column streams")
    for f in (1, 2, 4, 8):
        m, n_rows = 1 << 22, 1 << 16
        idx = torch.randint(0, n_rows, (m,), generator=gen, device=dev, dtype=torch.int32)
        g = torch.randn((m, f), generator=gen, device=dev)
        with torch.inference_mode():
            scale = row_scatter_add_plain(idx, g.abs(), n_rows)
            want = row_scatter_add_plain(idx, g, n_rows)
            e_rows = compare_table_grad(row_scatter_add(idx, g, n_rows), want, scale,
                                        f"RS F={f}")
            streams = g.t().contiguous()   # F separate (M,) streams, read with strides (1, M)
            e_cols = compare_table_grad(scatter_add_cols(idx, streams, n_rows), want, scale,
                                        f"RS cols F={f}")
        print(f"F={f}, {m} updates into {n_rows} rows: max abs err {e_rows:.3e}, as column "
              f"streams {e_cols:.3e} (2^-11·S)")

    phase(f"slice 4: one eikonal step at B={B}, gradients vs the plain eikonal step")
    xs, xv = sdf.sample_points(gen, B, dev)
    reset_counts()
    loss, grads = sdf.loss_and_grads(net, xs, xv)
    torch.cuda.synchronize()
    step_launches = counts()
    want_loss, want, scale = plain_sdf_loss_and_grads(
        net, xs, xv, table_scale=True, mlp_bwd=sdf_flip_explained_bwd(net, xs, xv))
    check(abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item()),
          f"eikonal loss {loss.item()} vs plain {want_loss.item()}")
    check(set(grads) == set(want), f"gradient names {sorted(grads)}")
    for name in grads:
        if name == "encoding.grid":   # GB's and RS's atomics: per entry 2^-11·S
            ratio = (grads[name] - want[name]).abs() / (2.0 ** -11 * scale + 1e-30)
            for i in ratio.topk(3).indices.tolist():   # the entries nearest their bound
                level = max(l for l, lv in enumerate(spec.levels) if lv.offset * F <= i)
                print(f"table entry {i} (level {level}): {grads[name][i].item():.6e} vs "
                      f"{want[name][i].item():.6e}, S {scale[i].item():.3e}, "
                      f"{ratio[i].item():.3e} of its bound")
            e, how = compare_table_grad(grads[name], want[name], scale), "2^-11·S per entry"
        else:
            e, how = compare_rel(grads[name], want[name], 1e-4, name), "1e-4 of its max"
        print(f"gradient {name}: max abs err {e:.3e} vs the plain step (max |g| "
              f"{want[name].abs().max().item():.3e}; {how})")
    print(f"loss {loss.item():.6f}, plain {want_loss.item():.6f}; launches {step_launches}")
    # GB once: the first-order call's table gradient, which the step would
    # discard, is not computed (ops/grid_ops.py: _engine_will_use)
    per_step = {"G": 2, "M": 2, "MB": 2, "GB": 1, "GI": 1, "GG": 1, "RS": 1}
    check(step_launches == per_step, f"eikonal step launches {step_launches}, "
          f"expected {per_step}")

    reset_counts()
    dx = net.input_gradient(xv, 0)
    torch.cuda.synchronize()
    ig_launches = counts()
    check(ig_launches == {"G": 1, "M": 1, "GB": 0, "MB": 1, "GI": 1, "GG": 0, "RS": 0},
          f"input_gradient launches {ig_launches}: expected no GB (its table gradient "
          f"would be thrown away)")
    check(dx.shape == (B, D) and bool(torch.isfinite(dx).all()), "input_gradient output")
    print(f"input_gradient at B={B}: launches {ig_launches}")

    phase(f"slice 4: the SDF sample's fit through create_from_config, model.network and "
          f"model.optimizer, {SDF_FIT_STEPS} steps at 2^{SDF_FIT_BATCH_POW}")
    torch.cuda.synchronize()
    reset_counts()
    fit = sdf.main(["fit_sdf_eikonal", str(SDF_FIT_STEPS), str(SDF_FIT_BATCH_POW)])
    torch.cuda.synchronize()
    fit_launches = counts()
    expect = {k: v * SDF_FIT_STEPS for k, v in per_step.items()}
    expect["G"] += 1   # the evaluation's request
    expect["M"] += 1
    check(fit_launches == expect, f"SDF fit launches {fit_launches}, expected {expect}")
    losses = fit["losses"]
    check(bool(torch.isfinite(losses).all()), "non-finite SDF loss")
    last10 = float(losses[-10:].mean())
    print(f"fit: loss {float(losses[0]):.6f} -> {last10:.6f} (mean of the last 10), mean "
          f"|sdf error| {fit['sdf_error']:.4f}, {fit['seconds']:.2f} s; launches {fit_launches} "
          f"(per step {per_step}, and G and M once for the evaluation)")
    check(last10 < SDF_LOSS_FLOOR, f"SDF loss floor missed: {last10} >= {SDF_LOSS_FLOOR}")
    check(fit["sdf_error"] < SDF_ERROR_FLOOR,
          f"SDF error floor missed: {fit['sdf_error']} >= {SDF_ERROR_FLOOR}")

    phase(f"slice 4 times at B={B}: the eikonal step and its kernels, device time in a "
          f"CUDA graph of {N_TIMED} calls; plain versions eager")
    opt_state = opt.init(dict(net.named_parameters()), net.param_layout())
    t = {}

    def step_call():
        return sdf.step(net, opt, opt_state, xs, xv)

    t["step"] = time_ms(step_call)
    t["step device"] = graph_ms(step_call)
    relu, none, f32 = mlp.activation, mlp.output_activation, torch.float32
    table = enc.grid.detach()
    ws = [w.detach() for w in mlp.layers]
    with torch.no_grad():   # tensors the MLP's second order can differentiate
        fs = grid_encode_fwd(spec, table, xs, live, soa=True)
        fv = grid_encode_fwd(spec, table, xv, live, soa=True)
        ys = fused_mlp_fwd(ws, fs, relu, none, f32, f32, True, False)
        dys = ys * (2.0 / B)
        ones = torch.ones_like(ys)
        dfs = fused_mlp_bwd(ws, fs, dys, relu, none, f32, True, False)[1]
        dfv = fused_mlp_bwd(ws, fv, ones, relu, none, f32, True, False)[1]
        gx = grid_encode_bwd_input(spec, table, xv, dfv, live)
    gxr = gx.clone().requires_grad_()
    (dgx,) = torch.autograd.grad(sdf.EIKONAL_WEIGHT * sdf.eikonal_loss(gxr), gxr)
    with torch.no_grad():   # tensors the MLP's second order can differentiate
        bb = grid_encode_bwd_bwd(spec, table, xv, dfv, dgx, live)
    calls = {
        "G": (lambda: grid_encode_fwd(spec, table, xs, live, soa=True),
              lambda: grid_encode_plain(spec, table, xs, live, soa=True)),
        "M": (lambda: fused_mlp_fwd(ws, fs, relu, none, f32, f32, True, False),
              lambda: fused_mlp_plain(ws, fs, relu, none, f32, f32, True, False)),
        "MB": (lambda: fused_mlp_bwd(ws, fs, dys, relu, none, f32, True, False),
               lambda: fused_mlp_bwd_plain(ws, fs, dys, relu, none, f32, True, False)),
        "GB": (lambda: grid_encode_bwd(spec, table, xs, dfs, live),
               lambda: grid_encode_bwd_plain(spec, table, xs, dfs, live)),
        "GI": (lambda: grid_encode_bwd_input(spec, table, xv, dfv, live),
               lambda: grid_encode_bwd_input_plain(spec, table, xv, dfv, live)),
        "GG": (lambda: grid_encode_bwd_bwd(spec, table, xv, dfv, dgx, live),
               lambda: grid_encode_bwd_bwd_plain(spec, table, xv, dfv, dgx, live)),
        "RS": (lambda: row_scatter_add(bb.rows, bb.g, spec.n_entries),
               lambda: row_scatter_add_plain(bb.rows, bb.g, spec.n_entries)),
    }
    rs_acc = torch.zeros((spec.n_entries, F), device=dev)
    hs = chain_activations(ws, fs.t())
    library = {"M": lambda: library_chain(ws, fs.t()),
               "MB": lambda: library_bwd(ws, hs, dys),
               # one PyTorch call computing RS's function: index_add_ into zeros
               "RS": lambda: rs_acc.zero_().index_add_(0, bb.rows, bb.g)}
    with torch.no_grad():   # tensors the MLP's second order can differentiate
        # the first-order kernels at the SDF shapes (fp32, one output)
        err["G"] = compare(calls["G"][0](), calls["G"][1](), "grid-f32")[0]
        err["M"] = compare(calls["M"][0](), calls["M"][1](), "mlp-f32")[0]
        (got_dws, got_dx), (want_dws, want_dx) = calls["MB"][0](), calls["MB"][1]()
        err["MB"] = compare_mlp_grads([*got_dws, got_dx], [*want_dws, want_dx], f32, "MB")
        err["GB"] = compare_table_grad(calls["GB"][0](), calls["GB"][1](),
                                       grid_encode_bwd_plain(spec, table, xs, dfs.abs(), live))
        # RS on the step's own (rows, g): GG's level-major updates
        e_rs = compare_table_grad(calls["RS"][0](), calls["RS"][1](),
                                  row_scatter_add_plain(bb.rows, bb.g.abs(), spec.n_entries),
                                  "RS (step)")
        err["RS"] = max(err["RS"], e_rs)
        print("at the step's tensors: " + ", ".join(f"{k} max abs err {err[k]:.3e}"
                                                    for k in ("G", "M", "MB", "GB"))
              + f" (fp32 bounds of the config_hash checks); RS on GG's {bb.rows.numel()} "
              f"updates {e_rs:.3e} (2^-11·S)")
        for k, (kernel, plain) in calls.items():
            t[k] = graph_ms(kernel)
            t[k + " plain"] = eager_ms(plain)
            if k in library:
                t[k + " library"] = graph_ms(library[k])
        t["MLP second order"] = graph_ms(lambda: fused_mlp_bwd_bwd_plain(
            ws, fv, ones, bb.d_dcols, [None] * len(ws), relu, none, f32, f32, True, False))
    grads = sdf.loss_and_grads(net, xs, xv)[1]
    t["Adam"] = graph_ms(lambda: opt.step(opt_state, grads, dict(net.named_parameters())))

    consts = spec.n_levels * grid_ops.LEVEL_FIELDS * 4
    tb = touched_bytes(spec, xs, 4)
    tbv = touched_bytes(spec, xv, 4)
    L, C = spec.n_levels, 1 << D
    m_flops = 2 * B * sum(w.numel() for w in ws)
    corner = 4 * D + C * (D - 1)      # per (sample, level): positions and weights
    # M and MB in fp32 run plain fp32 FMA (csrc/fused_mlp.cu, fused_mlp_bwd.cu):
    # their products are bounded at the FMA units' peak.
    b = {
        "G": (nbytes(xs, fs) + tb + consts, grid_flops(spec, B), PEAK_FP32),
        "M": (nbytes(fs, *ws, ys), m_flops, PEAK_FP32),
        "MB": (nbytes(fs, dys, *ws, dfs) + sum(w.numel() for w in ws) * 4, 3 * m_flops,
               PEAK_FP32),
        "GB": (nbytes(xs, dfs, table) + consts, grid_flops(spec, B), PEAK_FP32),
        # GI: per corner the row's dot with dcols (2F), d w / dx (D·D), dx += (2D)
        "GI": (nbytes(xv, dfv, gx) + tbv + consts,
               B * L * (corner + C * (2 * F + D * D + 2 * D)), PEAK_FP32),
        # GG: per corner d w / dx (D·D), w' (2D), d dcols (2F), the Hessian
        # times ddx (D·D·D + D·D), the row's dot (2F), dx (2D), g (F)
        "GG": (nbytes(xv, dgx, dfv, *[u for u in bb]) + tbv + consts,
               B * L * (corner + C * (D * D + 2 * D + 2 * F + D ** 3 + D * D + 2 * F + 2 * D
                                      + F)), PEAK_FP32),
        "RS": (nbytes(bb.rows, bb.g) + spec.n_params * 4, bb.g.numel(), PEAK_FP32),
    }
    record_bounds(t, b)
    parts = {k + (" x2" if per_step[k] == 2 else ""): per_step[k] * t[k] for k in calls}
    parts["MLP second order (torch ops)"] = t["MLP second order"]
    parts["Adam"] = t["Adam"]
    parts["loss, casts, gaps and the rest"] = t["step device"] - sum(parts.values())
    print(f"eikonal step at B={B}: {t['step']:.4f} ms eager with the host's work, "
          f"{t['step device']:.4f} ms of device work (idle share "
          f"{1 - t['step device'] / t['step']:.3f}); split: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    print(f"(rows, g) round trip of GG and RS: {nbytes(bb.rows, bb.g) / 1e6:.1f} MB each way")

    replaces = {
        "G": "tcnn_tpu/ops/pallas/grid_matmul.py:734 (_gather_kernel_xor); "
             "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel)",
        "M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
        "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)",
        "GB": "tcnn_tpu/ops/pallas/grid_matmul.py:602 (_scatter_kernel_xor); "
              "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel)",
        "GI": "none (jnp): tcnn_tpu/ops/grid_ops.py:1104 (_finish_interp_bwd) and "
              "autodiff of tcnn_tpu/ops/grid_ops.py:476 (_build_indices_weights)",
        "GG": "none (jnp): autodiff of tcnn_tpu/ops/grid_ops.py:1094 "
              "(_finish_interp_bwd) and of tcnn_tpu/ops/grid_ops.py:476",
        "RS": "tcnn_tpu/ops/pallas/scatter.py:106 (_scatter_kernel); "
              "tcnn_tpu/ops/pallas/scatter.py:187 (_scatter_cols_kernel)"}
    # launches: the fit's counts (the main path); per step, the eikonal
    # step's counts measured above
    return report_entries(" (sdf)", t, replaces, fit_launches, err,
                          {"launches_per_step": step_launches})


# The NeRF sample (slice 8): samples/fit_nerf_field.py at its defaults.  The
# JAX sample's run at those settings (`python samples/fit_nerf_field.py` on
# the CPU, fp32 policy: 400 steps of 2^12 rays x 48 samples, 128^2 render)
# read eval PSNR 36.89 dB (mse 0.000205); the floor is 3 dB below it.
NERF_PSNR_JAX = 36.89
NERF_PSNR_FLOOR = NERF_PSNR_JAX - 3.0
NERF_RAYS, NERF_SAMPLES = 1 << 12, 48
NERF_BATCH = NERF_RAYS * NERF_SAMPLES   # 196,608 field points a step
NERF_STEPS = 400
IMAGE_STEPS = 100
IMAGE_PSNR_FLOOR = 20.0


def live_pairs(spec, frac):
    """The (sample, level) pairs that the per-sample fractions ``frac`` keep."""
    from tcnn_tpu_torch.ops import grid_ops

    return int(grid_ops.level_mask(spec, list(range(spec.n_levels)), frac).sum())


def touched_rows_live(spec, x, frac):
    """The table rows that the live (sample, level) pairs touch: the rows G
    must read."""
    from tcnn_tpu_torch.ops import grid_ops

    L, C = spec.n_levels, 1 << spec.n_dims
    idx, _ = grid_ops.build_indices_weights(spec, x, list(range(L)))
    keep = grid_ops.level_mask(spec, list(range(L)), frac).bool()          # (L, B)
    rows = idx.reshape(L, C, -1)[keep[:, None, :].expand(-1, C, -1)]
    touched = torch.zeros(spec.n_entries, dtype=torch.bool, device=x.device)
    touched[rows] = True
    return int(touched.sum())


def nerf_slice(gen, dev):
    """Slice 8, the instant-ngp NeRF field (samples/fit_nerf_field.py,
    BF16_POLICY): masked G and GB, and M and MB at the two nets' shapes,
    against their plain versions at the sample's 196,608 points; one
    training step's gradients (both nets) against the plain path's; the
    launches of a step; the sample's fit at its defaults (the main path)
    with its PSNR floor; and the times.  Returns the report entries."""
    from tcnn_tpu_torch import BF16_POLICY, create_optimizer
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_bwd_plain,
                                                     grid_encode_fwd, grid_encode_plain)
    from tcnn_tpu_torch.samples import fit_nerf_field as nf
    from tcnn_tpu_torch.tools.plain_path import plain_nerf_loss_and_grads

    d_net, c_net = nf.build_model(BF16_POLICY, torch.Generator().manual_seed(0), dev)
    spec = d_net.encoding.spec
    d_dims, c_dims = mlp_dims(24, 64, 1, d_out=16), mlp_dims(31, 64, 2)
    check([tuple(w.shape) for w in d_net.network.layers] == d_dims
          and [tuple(w.shape) for w in c_net.network.layers] == c_dims
          and spec.n_dims == 3 and spec.n_levels == 12,
          f"NeRF nets {[tuple(w.shape) for w in d_net.network.layers]}, "
          f"{[tuple(w.shape) for w in c_net.network.layers]}")
    B, L, F = NERF_BATCH, spec.n_levels, spec.n_features_per_level
    live = list(range(L))
    print(f"NeRF density net: {d_net.n_params()} parameters, grid of {spec.n_entries} rows "
          f"({sum(not lv.use_hash for lv in spec.levels)} dense levels); colour net "
          f"{c_net.n_params()}; B = {NERF_RAYS} rays x {NERF_SAMPLES} samples = {B}")

    phase(f"NeRF: masked G and GB vs plain at B={B}, per-sample fractions over [0, 1]")
    x = torch.rand((B, 3), generator=gen, device=dev)
    frac = torch.rand(B, generator=gen, device=dev)
    on = torch.rand(B, generator=gen, device=dev) < 1 / 3   # a third on the level boundaries
    frac[on] = torch.randint(0, L + 1, (int(on.sum()),), generator=gen, device=dev).float() / L
    keep = grid_ops.level_mask(spec, live, frac).bool()
    sum_atol = ((1 << spec.n_dims) + 2 * spec.n_dims) * 2.0 ** -24   # as at config_btf
    err = {}
    for dtype in (torch.bfloat16, torch.float32):
        table = (torch.rand(spec.n_params, generator=gen, device=dev) * 2 - 1).to(dtype)
        dcols = torch.randn((L * F, B), generator=gen, device=dev).to(dtype)
        with torch.inference_mode():
            e_g = 0.0
            for soa in (True, False):
                got = grid_encode_fwd(spec, table, x, live, soa=soa, level_frac=frac)
                torch.cuda.synchronize()
                want = grid_encode_plain(spec, table, x, live, soa=soa, level_frac=frac)
                e_g = max(e_g, compare(got, want, "grid-bf16" if dtype == torch.bfloat16
                                       else "grid-f32", atol=sum_atol)[0])
                cols = (got if soa else got.t()).reshape(L, F, B)
                check(not bool(cols[~keep[:, None, :].expand(-1, F, -1)].any()),
                      "G wrote a nonzero value for a masked (sample, level)")
            got = grid_encode_bwd(spec, table, x, dcols, live, level_frac=frac)
            torch.cuda.synchronize()
            want = grid_encode_bwd_plain(spec, table, x, dcols, live, level_frac=frac)
            scale = grid_encode_bwd_plain(spec, table.float(), x, dcols.float().abs(), live,
                                          level_frac=frac)
            e_gb = compare_table_grad(got, want, scale, "GB masked")
            check(not bool(got[scale == 0].any()), "GB updated a row only masked pairs touch")
        if dtype == torch.bfloat16:
            err.update({"G": e_g, "GB": e_gb})
        bound = f"one bf16 ulp + {sum_atol:.3e}" if dtype == torch.bfloat16 else "rtol 1e-5"
        print(f"table={str(dtype)[6:]}: G max abs err {e_g:.3e} ({bound}; SoA and AoS; masked "
              f"pairs exact zeros), GB {e_gb:.3e} (2^-11·S); {int(keep.sum())} of {L * B} "
              f"(sample, level) pairs live")

    phase(f"NeRF: M and MB vs plain at 24 -> 64 -> 16 (SoA in) and 31 -> 64 x 2 -> 3 "
          f"(Sigmoid, AoS in), B={B}")
    sig = Activation.SIGMOID
    err_d, err_c = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        e = (mlp_case(gen, dev, d_dims, B, dtype, soa_in=True),
             mlp_bwd_case(gen, dev, d_dims, B, dtype, soa_in=True, flips=True),
             mlp_case(gen, dev, c_dims, B, dtype, soa_in=False, out_act=sig),
             mlp_bwd_case(gen, dev, c_dims, B, dtype, soa_in=False, flips=True, out_act=sig))
        if dtype == torch.bfloat16:
            err_d, err_c = {"M": e[0], "MB": e[1]}, {"M": e[2], "MB": e[3]}

    phase("NeRF: one training step (BF16_POLICY, frac 0.5: six of twelve levels live), "
          "gradients of both nets vs the plain path; launches per step")
    rays_o, rays_d = nf.sample_rays(gen, NERF_RAYS, dev)
    jitter = torch.rand((NERF_RAYS, NERF_SAMPLES), generator=gen, device=dev)
    loss, grads = nf.loss_and_grads(d_net, c_net, rays_o, rays_d, NERF_SAMPLES, jitter, 0.5)
    want_loss, want = plain_nerf_loss_and_grads(d_net, c_net, rays_o, rays_d, NERF_SAMPLES,
                                                jitter, 0.5)
    torch.cuda.synchronize()
    check(abs(loss.item() - want_loss.item()) <= 2e-2 * abs(want_loss.item()),
          f"NeRF step loss {loss.item()} vs plain {want_loss.item()}")
    check(set(grads) == set(want), f"NeRF gradient names {sorted(grads)}")
    for name in grads:
        e = compare_mlp_grads([grads[name]], [want[name]], torch.bfloat16, name)
        print(f"gradient {name}: max abs err {e:.3e} vs plain path (max |g| "
              f"{want[name].abs().max().item():.3e}, 2e-2 of it)")
    print(f"loss {loss.item():.6f}, plain path {want_loss.item():.6f}")
    opt = create_optimizer(nf.OPTIMIZER)
    opt_state = opt.init(*nf.params_and_layout(d_net, c_net))
    torch.cuda.synchronize()
    reset_counts()
    step_loss = nf.step(d_net, c_net, opt, opt_state, rays_o, rays_d, NERF_SAMPLES, jitter, 0.5)
    torch.cuda.synchronize()
    per_step = first_order_counts()
    check(per_step == {"G": 1, "M": 2, "GB": 1, "MB": 2},
          f"NeRF step launches {per_step}, expected G 1, M 2, GB 1, MB 2")
    check(bool(torch.isfinite(step_loss)), "NeRF step loss is not finite")
    print(f"launches per step: {per_step}")

    phase(f"NeRF: the sample's fit, fit_nerf_field.main at its defaults ({NERF_STEPS} steps "
          f"of {NERF_RAYS} rays x {NERF_SAMPLES} samples, 128^2 render), the main path")
    reset_counts()
    fit = nf.main(["fit_nerf_field"])
    torch.cuda.synchronize()
    fit_launches = first_order_counts()
    # each step G, GB once and M, MB twice; the evaluation render (one chunk
    # of 2^14 rays) G once and M twice
    want_launches = {"G": NERF_STEPS + 1, "M": 2 * NERF_STEPS + 2, "GB": NERF_STEPS,
                     "MB": 2 * NERF_STEPS}
    check(fit_launches == want_launches, f"NeRF fit launches {fit_launches}, expected "
          f"{want_launches}")
    losses = fit["losses"]
    check(bool(torch.isfinite(losses).all()), "non-finite NeRF loss")
    print(f"fit: {NERF_STEPS} steps in {fit['seconds']:.2f} s ({fit['seconds'] / NERF_STEPS * 1e3:.3f} "
          f"ms a step, eager); loss {float(losses[:10].mean()):.6f} (first 10) -> "
          f"{float(losses[-10:].mean()):.6f} (last 10); eval PSNR {fit['psnr']:.2f} dB "
          f"(floor {NERF_PSNR_FLOOR:.2f}: the JAX sample's {NERF_PSNR_JAX} dB on the CPU, "
          f"fp32, less 3 dB); launches {fit_launches}")
    check(fit["psnr"] > NERF_PSNR_FLOOR,
          f"NeRF PSNR floor missed: {fit['psnr']:.2f} dB <= {NERF_PSNR_FLOOR:.2f}")

    phase(f"NeRF times at B={B}: G and GB at the fractions the fit issues (1.0, and 0.5 "
          f"while it warms up), M and MB of both nets (device time in a CUDA graph of "
          f"{N_TIMED} calls), the step eager")
    bf16, relu = torch.bfloat16, Activation.RELU
    table = d_net.encoding.grid.detach().to(bf16)
    wd = [w.detach().to(bf16) for w in d_net.network.layers]
    wc = [w.detach().to(bf16) for w in c_net.network.layers]
    pts = torch.rand((B, 3), generator=gen, device=dev)
    dirs = torch.randn((B, 3), generator=gen, device=dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    # fit_nerf_field gives every sample of a step one fraction (coarse_to_fine):
    # (i + 1) / 100 at step i < 100, 1.0 for the other 300 steps
    fracs = {f: nf.per_sample_frac(f, B, dev) for f in (1.0, 0.5)}
    t_g = {f: {} for f in fracs}
    t_d, t_c = {}, {}
    consts = L * grid_ops.LEVEL_FIELDS * 4
    pair_flops = grid_flops(spec, 1) // L   # per (sample, level)
    with torch.inference_mode():
        feats = grid_encode_fwd(spec, table, pts, live, soa=True, level_frac=fracs[1.0])
        h = fused_mlp_fwd(wd, feats, relu, Activation.NONE, bf16, torch.float32, True, False)
        cfeat = c_net.encoding(nf.density_heads(h, dirs)[1])
        dh = torch.randn((B, 16), generator=gen, device=dev)   # a gradient into h
        dy_c = torch.randn((B, 3), generator=gen, device=dev)
        dcols = fused_mlp_bwd(wd, feats, dh, relu, Activation.NONE, bf16, True, False)[1]
        g_args, gb_args = (spec, table, pts, live), (spec, table, pts, dcols, live)
        for f, fv in fracs.items():
            t = t_g[f]
            t["G"] = graph_ms(lambda: grid_encode_fwd(*g_args, soa=True, level_frac=fv))
            t["G plain"] = eager_ms(lambda: grid_encode_plain(*g_args, soa=True, level_frac=fv))
            t["GB"] = graph_ms(lambda: grid_encode_bwd(*gb_args, level_frac=fv))
            t["GB plain"] = eager_ms(lambda: grid_encode_bwd_plain(*gb_args, level_frac=fv))
            # Only the live (sample, level) pairs read table rows (G) or
            # output gradients (GB) and compute; G still writes its whole
            # output, GB its whole bf16 table gradient.
            n_live, rows = live_pairs(spec, fv), touched_rows_live(spec, pts, fv)
            print(f"frac {f}:")
            record_bounds(t, {
                "G": (nbytes(pts, fv, feats) + rows * F * 2 + consts, n_live * pair_flops,
                      PEAK_FP32),
                "GB": (nbytes(pts, fv, table) + n_live * F * 2 + consts, n_live * pair_flops,
                       PEAK_FP32)},
                {"G": f" with {rows * F * 2 / 1e6:.2f} MB of table rows the {n_live} live "
                      f"pairs touch",
                 "GB": f", {n_live} of {L * B} (sample, level) pairs live"})
        no_mask = {"G": graph_ms(lambda: grid_encode_fwd(*g_args, soa=True)),
                   "GB": graph_ms(lambda: grid_encode_bwd(*gb_args))}
        for t, ws, x_in, soa, out_act, dy in (
                (t_d, wd, feats, True, Activation.NONE, dh),
                (t_c, wc, cfeat, False, sig, dy_c)):
            m_args = (ws, x_in, relu, out_act, bf16, torch.float32, soa, False)
            mb_args = (ws, x_in, dy, relu, out_act, bf16, soa, False)
            f_in = x_in.t() if soa else x_in
            out = torch.sigmoid if out_act == sig else None
            t["M"] = graph_ms(lambda: fused_mlp_fwd(*m_args))
            t["M plain"] = eager_ms(lambda: fused_mlp_plain(*m_args))
            t["M library"] = graph_ms(lambda: library_chain(ws, f_in, out))
            t["MB"] = graph_ms(lambda: fused_mlp_bwd(*mb_args))
            t["MB plain"] = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
            hs = chain_activations(ws, f_in)
            t["MB library"] = graph_ms(lambda: library_bwd(ws, hs, dy))
            dx = fused_mlp_bwd(*mb_args)[1]
            m_flops = 2 * B * sum(w.numel() for w in ws)
            record_bounds(t, {
                "M": (nbytes(x_in, *ws) + B * ws[-1].shape[1] * 4, m_flops, PEAK_BF16),
                "MB": (nbytes(x_in, dy, *ws, dx) + sum(w.numel() for w in ws) * 4,
                       3 * m_flops, PEAK_BF16)})
    print(f"without a mask: G {no_mask['G']:.4f} ms, GB {no_mask['GB']:.4f} ms (frac 1.0: "
          f"{t_g[1.0]['G']:.4f}, {t_g[1.0]['GB']:.4f})")
    opt = create_optimizer(nf.OPTIMIZER)
    opt_state = opt.init(*nf.params_and_layout(d_net, c_net))
    t_step = time_ms(lambda: nf.step(d_net, c_net, opt, opt_state, rays_o, rays_d, NERF_SAMPLES,
                                     jitter, 0.5), n=20)
    t_step_full = time_ms(lambda: nf.step(d_net, c_net, opt, opt_state, rays_o, rays_d,
                                          NERF_SAMPLES, jitter, 1.0), n=20)
    # Not timed in a CUDA graph: autograd's backward of torch.cumprod (the
    # render's transmittance) reads a value back from the device, which
    # capture refuses; the eager step waits for the device there too.
    kernels_ms = {f: t_g[f]["G"] + t_g[f]["GB"] + t_d["M"] + t_d["MB"] + t_c["M"] + t_c["MB"]
                  for f in fracs}
    print(f"NeRF step at B={B}, frac 1.0 (300 of the fit's 400 steps): {t_step_full:.4f} ms "
          f"eager with the host's work ({B / t_step_full * 1e3:.4e} field points/s), the six "
          f"kernels alone {kernels_ms[1.0]:.4f} ms of it: G {t_g[1.0]['G']:.4f}, GB "
          f"{t_g[1.0]['GB']:.4f}, M {t_d['M']:.4f} + {t_c['M']:.4f}, MB {t_d['MB']:.4f} + "
          f"{t_c['MB']:.4f}; frac 0.5: {t_step:.4f} ms, kernels {kernels_ms[0.5]:.4f} ms")
    mlp = {"M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
           "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    grid = {"G": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel)",
            "GB": "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel)"}
    per = {"launches_per_step": per_step}
    return (report_entries(" (nerf, frac 1.0)", t_g[1.0], grid, fit_launches, err, per)
            + report_entries(" (nerf, frac 0.5)", t_g[0.5], grid, fit_launches, err, per)
            + report_entries(" (nerf density 24-64-16)", t_d, mlp, fit_launches, err_d, per)
            + report_entries(" (nerf colour 31-64x2-3 sigmoid)", t_c, mlp, fit_launches,
                             err_c, per))


def image_sample_slice():
    """The image sample, samples/mlp_learning_an_image.py's loop on
    make_training_loop (config_hash, BF16_POLICY, 2^18 samples a step,
    synthetic_image(1024, 1024)), 100 steps into a temporary directory,
    with a PSNR floor."""
    import tempfile

    from tcnn_tpu_torch.samples import mlp_learning_an_image as img

    phase(f"image sample: mlp_learning_an_image.main, {IMAGE_STEPS} steps into a temporary "
          f"directory")
    with tempfile.TemporaryDirectory() as out_dir:
        reset_counts()
        out = img.main(["mlp_learning_an_image", "none", CONFIG, str(IMAGE_STEPS)],
                       out_dir=out_dir)
        torch.cuda.synchronize()
        launches = first_order_counts()
        dumps = sorted(os.listdir(out_dir))
    # the loop's eager warm-up step and its capture; three inferences of the
    # whole 1024^2 image (steps 10, 100 and the end) in chunks of 2^18
    want = {"G": 2 + 3 * 4, "M": 2 + 3 * 4, "GB": 2, "MB": 2}
    check(launches == want, f"image sample launches {launches}, expected {want}")
    check(bool(torch.isfinite(out["losses"]).all()), "non-finite image sample loss")
    check(len(dumps) == 2, f"image sample dumps {dumps}")
    print(f"image sample: {IMAGE_STEPS} steps in {out['seconds']:.2f} s; PSNR at "
          f"{', '.join(f'{k}: {v:.2f}' for k, v in out['psnr_at'].items())} dB, final "
          f"{out['psnr']:.2f} dB (floor {IMAGE_PSNR_FLOOR}); dumps {dumps}; launches {launches}")
    check(out["psnr"] > IMAGE_PSNR_FLOOR, f"image sample PSNR floor missed: {out['psnr']:.2f}")


def mb_determinism(gen, dev):
    """Kernel MB twice on the same inputs at the SDF shape (16 -> 64 x 2 ->
    1, SoA input) and at config_btf's (40 -> 64 x 3 -> 3, AoS), B = 2^18,
    in both compute dtypes: dW and dx must be equal bit for bit (each dW
    element has one owner thread, every sum a fixed order)."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd

    phase(f"MB determinism: two launches at B={MAIN_BATCH}, dW compared bit for bit")
    for label, dims, soa in (("sdf", mlp_dims(16, 64, 2, d_out=1), True),
                             ("config_btf", mlp_dims(40, 64, 3), False)):
        ws = random_mlp(gen, dev, dims)
        x = torch.rand((dims[0][0], MAIN_BATCH) if soa else (MAIN_BATCH, dims[0][0]),
                       generator=gen, device=dev) * 2 - 1
        g = torch.randn((MAIN_BATCH, dims[-1][1]), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            args = (ws, x.to(dtype), g, Activation.RELU, Activation.NONE, dtype, soa, False)
            with torch.inference_mode():
                first_dws, first_dx = fused_mlp_bwd(*args)
                again_dws, again_dx = fused_mlp_bwd(*args)
                torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(first_dws, again_dws)]
            check(all(same) and torch.equal(first_dx, again_dx),
                  f"MB determinism {label} {dtype}: dW layers equal {same}, dx equal "
                  f"{torch.equal(first_dx, again_dx)}")
            print(f"MB determinism: {label} {str(dtype)[6:]}: {len(same)} dW layers and dx "
                  f"bit-identical across two launches")


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

    report = {"kernels": config_hash_slices(gen, dev) + config_btf_slice(gen, dev)
              + config_oneblob_slice(gen, dev) + sdf_slice(gen, dev) + nerf_slice(gen, dev)}
    image_sample_slice()
    mb_determinism(gen, dev)
    phase("kernels")
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

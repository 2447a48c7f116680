"""The on-chip accumulation of kernels GB, GG, GT and RS, emulated on the CPU.

Kernels GB, GG and GT sum each level's updates in shared-memory windows,
following the work plan GB's wrapper builds
(``ops/cuda/grid_encode.py::gb_plan``; GG and GT with GG's chunks);
kernel RS sums each chunk of updates in a window of the chunk's row range
where that fits (``csrc/row_scatter.cu``).  The kernels run only on the
card, but their plans and decisions are plain arithmetic: these tests
check that ``gb_plan`` covers every (live level, sample) once per part of
its level and every row of a windowed level in exactly one part, at the
repo's three grid geometries, and they replay the kernels' algorithms
(window, skip of rows outside it, flush of the nonzero groups, direct
path) in PyTorch: GB's against ``grid_encode_bwd_plain``, GG's and GT's
against ``grid_encode_bwd_bwd_plain``'s and ``grid_encode_third_plain``'s
d_flat (within 2^-11 of S over the terms of its updates,
``tools/plain_path.py::gg_table_scale``, ``gt_table_scale``), RS's against the
JAX package's ``scatter_add_rows`` in interpret mode (tests/conftest.py).
Tolerances: the fp32 sums run in another order, rtol 1e-5 and atol 1e-6
(1e-4 for RS, tests/test_scatter.py's; at the SDF layout, whose level-0
rows sum 2^15 updates, 2^-11 of S = Σ|g| per entry, as on the card); rows
that no update reaches are exact zeros.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tcnn
from tcnn_tpu.ops.pallas import scatter as jscatter
from tcnn_tpu_torch.common import InterpolationType
from tcnn_tpu_torch.ops import grid_ops
from tcnn_tpu_torch.ops.cuda import grid_encode as ge
from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
from tcnn_tpu_torch.tools import plain_path

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _spec(name):
    if name == "config_hash":
        return tcnn.create_from_config(2, 3, str(CONFIGS / "config_hash.json"),
                                       device="cpu").network.encoding.spec
    if name == "sdf":
        return tcnn.create_from_config(3, 1, sdf.CONFIG, policy=tcnn.Policy(),
                                       device="cpu").network.encoding.spec
    # config_btf's grid: the Composite's first part
    return tcnn.create_from_config(6, 3, str(CONFIGS / "config_btf.json"),
                                   device="cpu").network.encoding.nested[0].spec


def _check_plan(spec, live, batch):
    """Every (live level, sample) in one item per part of its level, every
    row of a windowed level in one part; windows within their launch's
    bytes and one CTA's; pairs adjacent.  Returns {level: parts} (0 for a
    direct level)."""
    plan = ge.gb_plan(spec, live, batch)
    F = spec.n_features_per_level
    items = plan.items
    assert items.dtype == np.int32 and items.shape[1] == 5
    first = 0
    for start, n, window, parts in plan.groups:
        assert start == first and n > 0 and n % parts == 0
        first += n
        group = items[start:start + n]
        # window and direct (n_rows 0) items share a launch
        assert (group[:, 2] * F * 4 <= window).all() and window <= ge.GB_WINDOW_BYTES
        if parts == 2:   # 2-CTA clusters: the halves of a level and chunk, adjacent
            a, b = group[0::2], group[1::2]
            assert (a[:, 0] == b[:, 0]).all() and (a[:, 3:] == b[:, 3:]).all()
            assert (a[:, 1] == 0).all() and (b[:, 1] == a[:, 2]).all()
    assert first == len(items)
    found = {}
    for level in set(items[:, 0].tolist()):
        its = items[items[:, 0] == level]
        size = spec.levels[level].size
        parts = sorted({(lo, n) for _, lo, n, _, _ in its.tolist()})
        direct = parts == [(0, 0)]
        if not direct:
            assert parts[0][0] == 0 and sum(n for _, n in parts) == size
            assert all(a[0] + a[1] == b[0] for a, b in zip(parts, parts[1:]))
        for lo, n in parts:
            chunks = sorted((b0, b1) for _, l2, n2, b0, b1 in its.tolist() if (l2, n2) == (lo, n))
            assert chunks[0][0] == 0 and chunks[-1][1] == batch
            assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(chunks, chunks[1:]))
        found[level] = 0 if direct else len(parts)
    assert sorted(found) == sorted(live)
    return found


@pytest.mark.parametrize("name,windowed", [("config_hash", 16), ("sdf", 8), ("config_btf", 0)])
@pytest.mark.parametrize("batch", [1 << 18, 4133])
def test_gb_plan_covers_every_level_and_sample(name, windowed, batch, monkeypatch):
    """config_hash and the SDF grid: every level on chip (the 32,768-row
    levels in two parts); config_btf: every level on direct atomics.  With
    GB_MIN_HITS, only levels whose rows take that many updates."""
    spec = _spec(name)
    monkeypatch.setattr(ge, "GB_MIN_HITS", 0)
    live = list(range(spec.n_levels))
    found = _check_plan(spec, live, batch)
    assert sum(1 for p in found.values() if p) == windowed
    assert all(p == 2 for l, p in found.items() if spec.levels[l].size == 32768) or not windowed
    dead = _check_plan(spec, live[:3], batch)   # static max_level: no item beyond it
    assert sorted(dead) == [0, 1, 2]
    monkeypatch.setattr(ge, "GB_MIN_HITS", 64)
    C = 1 << spec.n_dims
    found = _check_plan(spec, live, batch)
    assert all(p == 0 for l, p in found.items() if batch * C < 64 * spec.levels[l].size)


def _emulate_gb(spec, flat, x, dcols, live):
    """Kernel GB's algorithm over ``gb_plan``, in PyTorch."""
    F, B = spec.n_features_per_level, x.shape[0]
    C = 1 << spec.n_dims
    idx, ws = grid_ops.build_indices_weights(spec, x, live)
    idx = idx.reshape(len(live), C, B)
    ws = ws.reshape(len(live), C, B)
    out = torch.zeros(spec.n_entries, F)
    for level, row_lo, n_rows, b0, b1 in ge.gb_plan(spec, live, B).items.tolist():
        li, offset = live.index(level), spec.levels[level].offset
        rows = idx[li, :, b0:b1].reshape(-1) - offset
        w = ws[li, :, b0:b1].reshape(-1)
        dy = dcols[level * F:(level + 1) * F, b0:b1].float().t()    # (b, F)
        vals = w[:, None] * dy.repeat(C, 1)
        keep = w != 0
        if n_rows == 0:   # direct atomics
            out.index_add_(0, rows[keep] + offset, vals[keep])
            continue
        keep &= (rows >= row_lo) & (rows < row_lo + n_rows)
        win = torch.zeros(n_rows, F).index_add_(0, rows[keep] - row_lo, vals[keep])
        v = 4 if F % 4 == 0 else 2 if F % 2 == 0 else 1
        groups = win.reshape(-1, v)
        nonzero = (groups != 0).any(1)
        flat_out = out[offset + row_lo:offset + row_lo + n_rows].reshape(-1, v)
        flat_out[nonzero] += groups[nonzero]
    return out.reshape(-1)


@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("batch", [1 << 18, 4133])
def test_gb_plan_with_cluster_parts(cluster, batch, monkeypatch):
    """With GB_CLUSTER_PARTS, config_hash's two-part levels come as adjacent
    halves in a launch of their own (2-CTA clusters); without, every
    window item is in one launch, the longest first."""
    monkeypatch.setattr(ge, "GB_CLUSTER_PARTS", cluster)
    monkeypatch.setattr(ge, "GB_MIN_HITS", 0)
    spec = _spec("config_hash")
    live = list(range(spec.n_levels))
    _check_plan(spec, live, batch)
    plan = ge.gb_plan(spec, live, batch)
    assert [g[3] for g in plan.groups] == ([2, 1] if cluster else [1])
    lengths = [b1 - b0 for _, _, _, b0, b1 in plan.items[plan.groups[-1][0]:].tolist()]
    assert lengths == sorted(lengths, reverse=True)


@pytest.mark.parametrize("D,F", [(2, 2), (3, 2), (3, 4), (2, 1)])
def test_gb_windows_emulated_equal_plain(D, F, monkeypatch):
    """GB's windows, two-part levels, direct levels and chunks at a small
    scale (the plan's constants shrunk so that one grid takes all four),
    against the plain table gradient; dead levels and untouched rows stay
    exact zeros."""
    spec = grid_ops.make_grid_spec(D, 6, F, 10, 4, 2.0,
                                   interpolation=InterpolationType.SMOOTHSTEP)
    sizes = sorted({lv.size for lv in spec.levels})
    cap = sizes[len(sizes) // 2]   # the middle size fits one window
    monkeypatch.setattr(ge, "GB_WINDOW_BYTES", cap * F * 4)
    monkeypatch.setattr(ge, "GB_MIN_CHUNK", 64)
    monkeypatch.setattr(ge, "GB_DIRECT_CHUNK", 100)
    monkeypatch.setattr(ge, "GB_MIN_HITS", 0)
    rng = np.random.default_rng(D * 10 + F)
    B = 1000
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, D)).astype(np.float32))
    dcols = torch.from_numpy(rng.normal(size=(spec.n_output_dims, B)).astype(np.float32))
    flat = torch.zeros(spec.n_params)
    for live in (list(range(spec.n_levels)), [0, 2, 3]):
        kinds = {p for p in _check_plan(spec, live, B).values()}
        got = _emulate_gb(spec, flat, x, dcols, live)
        want = ge.grid_encode_bwd_plain(spec, flat, x, dcols, live)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert torch.equal(got == 0, want == 0)
    assert kinds <= {0, 1, 2}


def _emulate_plan(spec, x, dcols, ddx, live, frac=None, shard=None, ct_dx=None):
    """Kernel GG's fused table gradient (or, given ``ct_dx``, kernel GT's)
    over ``gb_plan`` with GG's chunks, in PyTorch: per item, the w·dy of the
    corners of its samples that land in its window (summed there, flushed by
    nonzero groups, one value a group in the run-time-D instance that masks
    and shards take) or by direct atomics, w = GG's w' = Σ_d ∂w_c/∂x_d ·
    ddx_d or GT's u = βᵀ ∇²w_c ddx; a masked (sample, level), another
    shard's corner and w = 0 add nothing.  Also checks that the CTAs which
    write d_dcols and d_x's partials (direct items, and a windowed level's
    part at its first row: level_params' held row less its row base) cover
    every (live level, sample) once.  Returns the (rows, F) fp32 table
    gradient."""
    F, B, C = spec.n_features_per_level, x.shape[0], 1 << spec.n_dims
    lp = grid_ops.level_params(spec, live, shard).view(np.uint32).astype(np.int64)
    idx, _, dws, d2ws = grid_ops.build_indices_weights(spec, x, live, order=2, level_frac=frac,
                                                       shard=shard)
    idx = idx.reshape(len(live), C, B)
    if ct_dx is None:
        wp = (dws * ddx[None]).sum(-1).reshape(len(live), C, B)
    else:
        wp = torch.einsum("nbde,bd,be->nb", d2ws, ct_dx, ddx).reshape(len(live), C, B)
    keep_all = (torch.ones(len(live), B, dtype=torch.bool) if frac is None
                else grid_ops.level_mask(spec, live, frac) > 0)
    wide = frac is not None or shard is not None
    v = 1 if wide else 4 if F % 4 == 0 else 2 if F % 2 == 0 else 1
    out = torch.zeros(spec.n_entries // (shard[1] if shard else 1), F)
    owners = torch.zeros(len(live), B, dtype=torch.int64)
    plan = ge.gb_plan(spec, live, B, shard, ge.gg_chunks(B))
    for level, row_lo, n_rows, b0, b1 in plan.items.tolist():
        li = live.index(level)
        offset, first_row = int(lp[level, 2]), int(lp[level, 15])
        if n_rows == 0 or row_lo == (first_row - offset) % 2 ** 32:
            owners[li, b0:b1] += 1
        rows = idx[li, :, b0:b1].reshape(-1)
        w = wp[li, :, b0:b1].reshape(-1)
        vals = w[:, None] * dcols[level * F:(level + 1) * F, b0:b1].t().repeat(C, 1)
        keep = (rows >= 0) & (w != 0) & keep_all[li, b0:b1].repeat(C)
        if n_rows == 0:
            out.index_add_(0, rows[keep].long(), vals[keep])
            continue
        r = (rows.long() - offset - row_lo) % 2 ** 32
        keep &= r < n_rows
        groups = torch.zeros(n_rows, F).index_add_(0, r[keep], vals[keep]).reshape(-1, v)
        nonzero = (groups != 0).any(1)
        start = (offset + row_lo) % 2 ** 32
        part = out[start:start + n_rows].reshape(-1, v)
        part[nonzero] += groups[nonzero]
    assert bool((owners == 1).all())
    return out.reshape(-1)


def _check_plan_windows(kernel, case, all_windows, monkeypatch):
    """Kernel GG's or GT's (``kernel``) emulated table gradient at the SDF
    layout against its plain version's d_flat, per entry within 2^-11·S, S
    over the updates' terms (``gg_table_scale``, ``gt_table_scale``); rows
    no update reaches are exact zeros."""
    spec = _spec("sdf")
    if all_windows:
        monkeypatch.setattr(ge, "GB_MIN_HITS", 0)
    live = list(range(spec.n_levels))
    B = 1 << 12
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((B, 3), generator=gen) * 0.9 + 0.05
    dcols = torch.randn((spec.n_output_dims, B), generator=gen)
    ddx = torch.randn((B, 3), generator=gen)
    beta = torch.randn((B, 3), generator=gen)
    frac = torch.rand(B, generator=gen) if case == "masked" else None
    shard = (int(case[-1]), 2) if case.startswith("shard") else None
    plan = ge.gb_plan(spec, live, B, shard, ge.gg_chunks(B))
    parts = {}
    for level, row_lo, n_rows, _, _ in plan.items.tolist():
        parts.setdefault(level, set()).add((row_lo, n_rows))
    assert any(n == 0 for p in parts.values() for _, n in p) != all_windows
    # a shard's blocks (at most 16,384 rows) fit one window
    assert any(len(p) == 2 for p in parts.values()) == (all_windows and shard is None)
    table = torch.rand(spec.n_params // (2 if shard else 1), generator=gen) * 2 - 1
    kw = {"need_dcols": False, "need_x": False, "level_frac": frac, "shard": shard}
    if kernel == "GG":
        got = _emulate_plan(spec, x, dcols, ddx, live, frac, shard)
        want = ge.grid_encode_bwd_bwd_plain(spec, table, x, dcols, ddx, live, **kw).d_flat
        scale = plain_path.gg_table_scale(spec, x, dcols, ddx, live, frac, shard)
    else:
        got = _emulate_plan(spec, x, dcols, ddx, live, frac, shard, ct_dx=beta)
        want = ge.grid_encode_third_plain(spec, table, x, dcols, ddx, beta, live, **kw).d_flat
        scale = plain_path.gt_table_scale(spec, x, dcols, ddx, beta, live, frac, shard)
    assert bool(((got - want).abs() <= 2.0 ** -11 * scale).all())
    assert bool((got[scale == 0] == 0).all()) and bool((want[scale == 0] == 0).all())
    assert bool((scale > 0).any())


@pytest.mark.parametrize("case", ["unmasked", "masked", "shard 0", "shard 1"])
@pytest.mark.parametrize("all_windows", [False, True])
def test_gg_windows_emulated_equal_plain(case, all_windows, monkeypatch):
    """GG's table gradient over its plan at the SDF layout (3-D Smoothstep,
    8 levels of up to 32,768 rows, F = 2; B = 2^12 here), with the plan's
    windows where the kernel takes them or (GB_MIN_HITS 0) on every level,
    the 29,792- and 32,768-row levels then in two parts (a shard's halves
    in one); unmasked, under a
    per-sample mask and on each shard of two: against the plain d_flat per
    entry within 2^-11·S, S over the updates' terms (``gg_table_scale``);
    rows no update reaches stay exact zeros."""
    _check_plan_windows("GG", case, all_windows, monkeypatch)


@pytest.mark.parametrize("case", ["unmasked", "masked", "shard 0", "shard 1"])
@pytest.mark.parametrize("all_windows", [False, True])
def test_gt_windows_emulated_equal_plain(case, all_windows, monkeypatch):
    """GT's table gradient, u_c · dy with u_c = βᵀ ∇²w_c v, over the same
    plan (GT runs on GG's chunks) at the same layout and cases: against
    ``grid_encode_third_plain``'s d_flat per entry within 2^-11·S
    (``gt_table_scale``); rows no update reaches stay exact zeros."""
    _check_plan_windows("GT", case, all_windows, monkeypatch)


RS_CHUNK, RS_WINDOW_FLOATS = 8192, 96 * 1024 // 4   # csrc/row_scatter.cu


def _emulate_rs(idx, g, n_rows, chunk=RS_CHUNK, window=RS_WINDOW_FLOATS):
    """Kernel RS's algorithm in PyTorch: per chunk of updates, its row
    range [lo, hi] summed in a window where (hi - lo + 1)·F values fit
    (flushed by nonzero groups), else direct.  Returns the table and how
    many chunks took the window."""
    F = g.shape[1]
    v = 4 if F % 4 == 0 else 2 if F % 2 == 0 else 1
    out = torch.zeros(n_rows, F)
    windowed = 0
    for i0 in range(0, len(idx), chunk):
        r, gg = idx[i0:i0 + chunk].long(), g[i0:i0 + chunk]
        keep = (r >= 0) & (r < n_rows)
        r, gg = r[keep], gg[keep]
        if not len(r):
            continue
        lo, hi = int(r.min()), int(r.max())
        if (hi - lo + 1) * F > window:
            out.index_add_(0, r, gg)
            continue
        windowed += 1
        win = torch.zeros(hi - lo + 1, F).index_add_(0, r - lo, gg).reshape(-1, v)
        nonzero = (win != 0).any(1)
        part = out[lo:hi + 1].reshape(-1, v)
        part[nonzero] += win[nonzero]
    return out, windowed


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_rs_windows_emulated_equal_jax(f):
    """Chunks on one row, inside a window, one row wider than it, and over
    a wide range with out-of-range indices, against the JAX package's
    ``scatter_add_rows`` (TPU row 9, interpret mode)."""
    rng = np.random.default_rng(f)
    chunk, window = 64, 40 * f            # the kernel's geometry, scaled down
    n_rows = 300
    parts = [np.full(chunk, 7),                                   # one row
             rng.integers(100, 140, chunk),                       # within 40 rows
             np.concatenate([[10, 50], rng.integers(10, 51, chunk - 2)]),   # 41 rows
             rng.integers(-5, n_rows + 5, chunk + 13)]            # wide, some out of range
    idx = np.concatenate(parts).astype(np.int32)
    g = rng.normal(size=(len(idx), f)).astype(np.float32)
    got, windowed = _emulate_rs(torch.from_numpy(idx), torch.from_numpy(g), n_rows, chunk,
                                window)
    assert windowed == 2
    keep = (idx >= 0) & (idx < n_rows)
    want = np.asarray(jscatter.scatter_add_rows(jnp.asarray(idx[keep]), jnp.asarray(g[keep]),
                                                n_rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    touched = np.zeros(n_rows, bool)
    touched[idx[keep]] = True
    assert (got.numpy()[~touched] == 0).all()


def test_rs_windows_at_the_sdf_steps_layout():
    """GG's updates as (rows, g), level-major, at the SDF grid (B = 2^12
    here; ``plain_path.gg_rows_and_g``): with RS's own chunk and window,
    the chunks of levels 0-4 (at most 9,264 rows) take the window, those of
    levels 5-7 the direct path, and the result equals the plain scatter."""
    spec = _spec("sdf")
    live = list(range(spec.n_levels))
    B = 1 << 12
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((B, 3), generator=gen) * 0.9 + 0.05
    table = torch.rand(spec.n_params, generator=gen) * 2 - 1
    dcols = torch.randn((spec.n_output_dims, B), generator=gen)
    ddx = torch.randn((B, 3), generator=gen)
    rows, g = plain_path.gg_rows_and_g(spec, x, dcols, ddx, live)
    got, windowed = _emulate_rs(rows, g, spec.n_entries, chunk=B)
    C = 8
    assert windowed == sum(C for lv in spec.levels
                           if lv.size * 2 <= RS_WINDOW_FLOATS)
    assert windowed == 5 * C
    want = torch.zeros(spec.n_entries, 2).index_add_(0, rows.long(), g)
    scale = torch.zeros(spec.n_entries, 2).index_add_(0, rows.long(), g.abs())
    assert bool(((got - want).abs() <= 2.0 ** -11 * scale).all())
    # and their scatter is GG's own table gradient, the plain GG's d_flat
    d_flat = ge.grid_encode_bwd_bwd_plain(spec, table, x, dcols, ddx, live, need_dcols=False,
                                          need_x=False).d_flat
    assert torch.equal(d_flat, want.reshape(-1))

"""The on-chip accumulation of kernels GB and RS, emulated on the CPU.

Kernel GB sums each level's updates in shared-memory windows, following
the work plan its wrapper builds (``ops/cuda/grid_encode.py::gb_plan``);
kernel RS sums each chunk of updates in a window of the chunk's row range
where that fits (``csrc/row_scatter.cu``).  The kernels run only on the
card, but their plans and decisions are plain arithmetic: these tests
check that ``gb_plan`` covers every (live level, sample) once per part of
its level and every row of a windowed level in exactly one part, at the
repo's three grid geometries, and they replay both kernels' algorithms
(window, skip of rows outside it, flush of the nonzero groups, direct
path) in PyTorch: GB's against ``grid_encode_bwd_plain``, RS's against the
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
    """GG's level-major (rows, g) at the SDF grid (B = 2^12 here): with the
    kernel's own chunk and window, the chunks of levels 0-4 (at most 9,264
    rows) take the window, those of levels 5-7 the direct path, and the
    result equals the plain scatter."""
    spec = _spec("sdf")
    live = list(range(spec.n_levels))
    B = 1 << 12
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((B, 3), generator=gen) * 0.9 + 0.05
    table = torch.rand(spec.n_params, generator=gen) * 2 - 1
    dcols = torch.randn((spec.n_output_dims, B), generator=gen)
    ddx = torch.randn((B, 3), generator=gen)
    bb = ge.grid_encode_bwd_bwd_plain(spec, table, x, dcols, ddx, live, need_dcols=False,
                                      need_x=False)
    got, windowed = _emulate_rs(bb.rows, bb.g, spec.n_entries, chunk=B)
    C = 8
    assert windowed == sum(C for lv in spec.levels
                           if lv.size * 2 <= RS_WINDOW_FLOATS)
    assert windowed == 5 * C
    want = torch.zeros(spec.n_entries, 2).index_add_(0, bb.rows.long(), bb.g)
    scale = torch.zeros(spec.n_entries, 2).index_add_(0, bb.rows.long(), bb.g.abs())
    assert bool(((got - want).abs() <= 2.0 ** -11 * scale).all())

"""The deterministic table gradient (``ops/sort_scatter.py``, the
``TCNN_TPU_SCATTER=sortseg`` route, kernels SK and SS' plain versions)
against the JAX package, on the CPU.

Inputs come from numpy with a seed and both packages get the same ones.
Tolerances:
  * ``sort_segment_scatter`` on the shapes of tests/test_sort_scatter.py:
    rtol 1e-5, atol 1e-5 of JAX's (its own test's tolerance against the
    dense scatter); against the float64 sum per row within the plain
    version's stated bound, 2^-23·(P + n·A): P the largest |prefix sum| of
    the row's column, n the row's run length, A the sum of its values'
    magnitudes (``ops/cuda/sort_scatter.py``).
  * the grid's table gradient under ``sortseg`` on both sides (JAX through
    its custom VJP, ``fast_scatter=True``, whose backward takes the sortseg
    branch): the same fp32 products, summed as differences of cumulative
    sums in both packages.  JAX's fp32 cumsum on the CPU was measured
    within 3.1 ulps of P of the float64 prefix (2^20 values), the port's
    within half an ulp, and a total is the difference of two prefixes: per
    entry within 2^-19·(P + S), S = Σ|w·dy| over its updates (16 ulps of
    P), plus one bf16 ulp of the value for bf16 tables (an fp32 total that
    differs in its last bits may round to the other neighbour).
  * the route against kernel GB's plain version (fp32 ``index_add_``, the
    same products in update order): per entry within 2^-19·(P + S).
  * ``sort_segment_scatter`` on the key layouts at the edges of kernel SS's
    tiles (``tests/sortseg_layouts.py``): per entry within 2^-19·(P + S)
    of JAX's (JAX's cumsum as above, P over every update the port sums),
    within 2^-23·(P + n·A) of the float64 sum, and equal to both on
    small-integer values (every sum exact).  JAX gets the updates whose
    keys are not below 0: its ``.at[]`` wraps such a key to the table's
    end, where the port drops it (keys past the table both drop; they sort
    after every row, so ``jnp.nonzero(..., size=n_rows)`` keeps each row's
    run).
  * a small config_hash-structured model (4 levels, FullyFusedMLP 16 × 1,
    fp32) trained 3 steps under ``sortseg`` on both sides: each step's loss
    within rtol 1e-5, the gradients and the parameters after each step as
    the test's docstring states (JAX's state carried in before each step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
from tcnn_tpu import common as jcommon
from tcnn_tpu.ops import grid_ops as jops
from tcnn_tpu.ops.sort_scatter import sort_segment_scatter as jax_sort_segment_scatter
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch import common as tcommon
from tcnn_tpu_torch.ops import grid_ops as tops
from tcnn_tpu_torch.ops import sort_scatter as tss
from tcnn_tpu_torch.ops.cuda import sort_scatter as tcss
from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd_plain
from tcnn_tpu_torch.utils.jax_params import load_jax_opt_state, load_jax_params

import sortseg_layouts
from test_torch_slice import flat_params

EPS = 2.0 ** -23


def _specs(*args, **kw):
    jkw = {k: getattr(jcommon, type(v).__name__)(v.value) if hasattr(v, "value") else v
           for k, v in kw.items()}
    return jops.make_grid_spec(*args, **jkw), tops.make_grid_spec(*args, **kw)


def _bf16_ulp(a):
    a = np.maximum(np.abs(a.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _terms(keys, vals, n_rows):
    """(P per column, S per row, n per row) of the updates (keys, vals):
    the largest |float64 prefix sum| of each column over the stably sorted
    updates, and each row's Σ|value| and count."""
    keys, vals = np.asarray(keys).astype(np.int64), np.asarray(vals, np.float64)
    order = np.argsort(keys, kind="stable")
    p = np.abs(np.cumsum(vals[order], axis=0)).max(0) if len(keys) else np.zeros(vals.shape[1])
    keep = (keys >= 0) & (keys < n_rows)
    s = np.zeros((n_rows, vals.shape[1]))
    np.add.at(s, keys[keep], np.abs(vals[keep]))
    n = np.bincount(keys[keep], minlength=n_rows)[:, None].astype(np.float64)
    return p, s, n


def _exact(keys, vals, n_rows):
    keys, vals = np.asarray(keys).astype(np.int64), np.asarray(vals, np.float64)
    out = np.zeros((n_rows, vals.shape[1]))
    keep = (keys >= 0) & (keys < n_rows)
    np.add.at(out, keys[keep], vals[keep])
    return out


SHAPES = [(1024, 64, 2), (333, 7, 4), (64, 256, 1), "one row"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s))
                         if isinstance(s, tuple) else s.replace(" ", "_"))
def test_sort_segment_scatter_equals_jax(shape):
    rng = np.random.default_rng(7)
    if shape == "one row":   # tests/test_sort_scatter.py::test_all_updates_one_row
        m, n_rows, f = 50, 8, 2
        idx = np.full(m, 3, np.int32)
    else:
        m, n_rows, f = shape
        idx = rng.integers(0, n_rows, m).astype(np.int32)
    vals = rng.normal(size=(m, f)).astype(np.float32)
    want = np.asarray(jax_sort_segment_scatter(jnp.asarray(idx), jnp.asarray(vals), n_rows))
    got = tss.sort_segment_scatter(torch.from_numpy(idx), torch.from_numpy(vals), n_rows)
    assert got.dtype == torch.float32 and got.shape == (n_rows, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    p, s, n = _terms(idx, vals, n_rows)
    err = np.abs(got.numpy() - _exact(idx, vals, n_rows))
    assert (err <= EPS * (p[None, :] + n * s)).all()
    if shape == "one row":
        assert np.count_nonzero(got.numpy().any(1)) == 1


def test_sort_segment_scatter_is_deterministic_and_drops_rows_outside_the_table():
    """Two calls give the same bits (tests/test_sort_scatter.py::
    test_deterministic); keys below 0 or past the last row add nothing, as
    kernel SK's key of an update that adds nothing and jnp's ``.at[].add``
    past the table; int64 keys give the int32 keys' result."""
    rng = np.random.default_rng(5)
    idx = rng.integers(-2, 18, 4096).astype(np.int32)
    vals = torch.from_numpy(rng.normal(size=(4096, 2)).astype(np.float32))
    a = tss.sort_segment_scatter(torch.from_numpy(idx), vals, 16)
    b = tss.sort_segment_scatter(torch.from_numpy(idx), vals, 16)
    assert torch.equal(a, b)
    assert torch.equal(tss.sort_segment_scatter(torch.from_numpy(idx).long(), vals, 16), a)
    inside = (idx >= 0) & (idx < 16)
    want = jax_sort_segment_scatter(jnp.asarray(idx[inside]), jnp.asarray(vals.numpy()[inside]),
                                    16)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tss.sort_segment_scatter(torch.from_numpy(idx), vals, 16,
                                    torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("f", sortseg_layouts.FEATURES)
@pytest.mark.parametrize("layout", sortseg_layouts.NAMES)
def test_sort_segment_scatter_at_tile_edges_equals_jax(layout, f):
    """The layouts kernel SS meets at its tiles' edges, through the plain
    route, against JAX's ``sort_segment_scatter``; bf16 output is the fp32
    result rounded once."""
    n_rows = sortseg_layouts.N_ROWS
    idx = sortseg_layouts.layout(layout, tcss.SS_TILE)
    rng = np.random.default_rng(f)
    kept = idx >= 0
    for vals in (rng.normal(size=(len(idx), f)).astype(np.float32),
                 rng.integers(-2, 3, (len(idx), f)).astype(np.float32)):
        want = np.asarray(jax_sort_segment_scatter(jnp.asarray(idx[kept]),
                                                   jnp.asarray(vals[kept]), n_rows))
        got = tss.sort_segment_scatter(torch.from_numpy(idx), torch.from_numpy(vals), n_rows)
        assert got.dtype == torch.float32 and got.shape == (n_rows, f)
        p, s, n = _terms(idx, vals, n_rows)
        exact = _exact(idx, vals, n_rows)
        assert (np.abs(got.numpy() - want) <= 2.0 ** -19 * (p[None, :] + s)).all()
        assert (np.abs(got.numpy() - exact) <= EPS * (p[None, :] + n * s)).all()
        if np.array_equal(vals, np.round(vals)):   # small integers: every sum exact
            assert np.array_equal(got.numpy(), exact) and np.array_equal(want, exact)
        bf16 = tss.sort_segment_scatter(torch.from_numpy(idx), torch.from_numpy(vals), n_rows,
                                        torch.bfloat16)
        assert torch.equal(bf16, got.to(torch.bfloat16))
    if layout == "all-sentinels":
        assert not got.any()


def test_ss_tile_matches_the_kernel_source():
    """``SS_TILE``, which the layouts are built around, is kernel SS's tile:
    kSsThreads × kSsItems in ``csrc/sort_scatter.cu``."""
    import re
    from pathlib import Path

    src = (Path(tcss.__file__).parents[2] / "csrc" / "sort_scatter.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (kSs\w+) = (\d+);", src)}
    assert tcss.SS_TILE == consts["kSsThreads"] * consts["kSsItems"]


# (name, make_grid_spec args, kwargs)
GRID_CASES = [
    ("hash-CoherentPrime", (2, 6, 2, 8, 4, 1.6), dict(hash_type=tcommon.HashType.COHERENT_PRIME)),
    ("hash-CoherentAdd", (3, 4, 2, 9, 4, 1.5), dict(hash_type=tcommon.HashType.COHERENT_ADD)),
    ("tiled", (2, 4, 2, 9, 4, 1.6), dict(grid_type=tcommon.GridType.TILED)),
    ("dense", (2, 4, 3, 10, 4, 1.8), dict(grid_type=tcommon.GridType.DENSE)),
    ("stochastic", (2, 4, 2, 8, 4, 1.6),
     dict(stochastic_interpolation=True, interpolation=tcommon.InterpolationType.SMOOTHSTEP)),
]


@pytest.fixture
def sortseg(monkeypatch):
    monkeypatch.setenv("TCNN_TPU_SCATTER", "sortseg")


def _route_calls(monkeypatch):
    """Counts the calls of the route (``grid_table_gradient``)."""
    calls = []
    route = tss.grid_table_gradient

    def counted(*a, **k):
        calls.append(1)
        return route(*a, **k)

    monkeypatch.setattr(tss, "grid_table_gradient", counted)
    return calls


@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all-levels", "masked"])
def test_grid_table_gradient_under_sortseg_equals_jax(case, dtype, masked, sortseg,
                                                      monkeypatch):
    _, args, kw = case
    jspec, tspec = _specs(*args, **kw)
    rng = np.random.default_rng(11)
    B = 256
    table = rng.uniform(-1, 1, tspec.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (B, tspec.n_dims)).astype(np.float32)
    dy = rng.normal(size=(B, tspec.n_output_dims)).astype(np.float32)
    frac = rng.uniform(0, 1, B).astype(np.float32) if masked else None
    max_level = tspec.n_levels - 1 if masked else None

    def jloss(t):
        y = jops.grid_encode(jspec, t.astype(dtype), jnp.asarray(x), fast_scatter=True,
                             max_level=max_level,
                             max_level_per_element=None if frac is None else jnp.asarray(frac))
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(table)))

    calls = _route_calls(monkeypatch)
    tt = torch.from_numpy(table).requires_grad_()
    y = tops.grid_encode(tspec, tt.to(getattr(torch, dtype)), torch.from_numpy(x),
                         max_level=max_level,
                         max_level_per_element=None if frac is None else torch.from_numpy(frac))
    (got,) = torch.autograd.grad(y.float(), tt, torch.from_numpy(dy))
    assert calls == [1]
    live = tops.live_levels(tspec, max_level)
    tfrac = None if frac is None else torch.from_numpy(frac)
    dcols = torch.from_numpy(dy.T.copy())
    keys, vals = tcss.sort_keys_plain(tspec, torch.from_numpy(x), dcols, live, tfrac)
    p, s, _ = _terms(keys, vals, tspec.n_entries)
    tol = 2.0 ** -19 * (p[None, :] + s).reshape(-1)
    if dtype == "bfloat16":
        tol = tol + _bf16_ulp(want)
    got = got.numpy()
    assert np.abs(want).max() > 1e-2
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    # and kernel GB's plain version, the same products summed in update order
    gb = grid_encode_bwd_plain(tspec, torch.zeros(tspec.n_params), torch.from_numpy(x), dcols,
                               live, level_frac=tfrac).numpy()
    route = tss.grid_table_gradient(tspec, torch.zeros(tspec.n_params), torch.from_numpy(x),
                                    dcols, live, level_frac=tfrac).numpy()
    assert (np.abs(route - gb) <= 2.0 ** -19 * (p[None, :] + s).reshape(-1)).all()


def test_route_is_taken_by_the_first_order_gradient_only(monkeypatch):
    """Without the variable the table gradient is GB's (its plain version
    here), bit for bit as before; with it, both call sites take the route
    (``GridEncodeFunction.backward`` without a graph, and
    ``GridEncodeBackwardFunction`` under ``create_graph``, with the same
    bits), while forward mode (``jvp``'s table tangent) and the second
    order keep their kernels, as JAX's branch covers only
    ``_grid_interpolate_vjp_bwd``."""
    _, tspec = _specs(3, 4, 2, 9, 4, 1.5, interpolation=tcommon.InterpolationType.SMOOTHSTEP)
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.uniform(-1, 1, tspec.n_params).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (128, 3)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(128, tspec.n_output_dims)).astype(np.float32))
    live = list(range(tspec.n_levels))
    calls = _route_calls(monkeypatch)

    def first_order(create_graph):
        t, xx = table.clone().requires_grad_(), x.clone().requires_grad_()
        y = tops.grid_encode(tspec, t, xx)
        return torch.autograd.grad(y, [t, xx], dy, create_graph=create_graph)

    monkeypatch.delenv("TCNN_TPU_SCATTER", raising=False)
    gb_t, gb_x = first_order(False)
    assert calls == []
    assert torch.equal(gb_t, grid_encode_bwd_plain(tspec, table, x, dy.t(), live))
    monkeypatch.setenv("TCNN_TPU_SCATTER", "sortseg")
    route_t, route_x = first_order(False)
    graph_t, graph_x = first_order(True)
    assert calls == [1, 1]
    assert torch.equal(route_t, graph_t) and torch.equal(route_x, graph_x)
    assert torch.equal(route_x, gb_x)   # the input gradient is GI's either way
    assert torch.equal(route_t, tss.grid_table_gradient(tspec, table, x, dy.t(), live))
    assert calls == [1, 1, 1]   # and this direct call
    # the second order: d/dx of a loss on the input gradient, through GG
    xx = x.clone().requires_grad_()
    t = table.clone().requires_grad_()
    (gx,) = torch.autograd.grad(tops.grid_encode(tspec, t, xx), xx, dy, create_graph=True)
    torch.autograd.grad(gx.square().sum(), [t])
    # forward mode: the table tangent's term through kernel G, no scatter
    torch.func.jvp(lambda t_: tops.grid_encode(tspec, t_, x), (table,), (table,))
    assert calls == [1, 1, 1]


@pytest.mark.parametrize("n", [2, 4])
def test_route_in_shard_mode_adds_nothing_for_other_shards(n):
    """With ``shard`` (sid, n), another rank's corners get kernel SK's
    sentinel key and add nothing; each shard's route equals GB's plain
    version on that shard, and the shards together the unsharded route."""
    _, tspec = _specs(3, 4, 2, 9, 4, 1.5, hash_type=tcommon.HashType.COHERENT_ADD)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(0, 1, (200, 3)).astype(np.float32))
    dcols = torch.from_numpy(rng.normal(size=(tspec.n_output_dims, 200)).astype(np.float32))
    live = list(range(tspec.n_levels))
    perm = tops.block_cyclic_perm(tspec, n)
    whole = tss.grid_table_gradient(tspec, torch.zeros(tspec.n_params), x, dcols, live)
    keys, vals = tcss.sort_keys_plain(tspec, x, dcols, live)
    p, s, _ = _terms(keys, vals, tspec.n_entries)
    tol = 2.0 ** -19 * (p[None, :] + s).reshape(-1)
    shards = []
    for sid in range(n):
        flat = torch.zeros(tspec.n_params // n)
        got = tss.grid_table_gradient(tspec, flat, x, dcols, live, shard=(sid, n))
        k, v = tcss.sort_keys_plain(tspec, x, dcols, live, shard=(sid, n))
        idx, _ = tops.build_indices_weights(tspec, x, live, shard=(sid, n))
        assert torch.equal(k == tspec.n_entries // n, idx.reshape(-1) < 0)
        want = grid_encode_bwd_plain(tspec, flat, x, dcols, live, shard=(sid, n))
        ps, ss, _ = _terms(k, v, tspec.n_entries // n)
        assert (np.abs((got - want).numpy()) <= 2.0 ** -19 * (ps[None, :] + ss).reshape(-1)).all()
        shards.append(got)
    err = np.abs(torch.cat(shards).numpy() - whole.numpy()[perm])
    assert (err <= tol[perm] + 2.0 ** -19 * max(ps.max(), p.max())).all()


def test_route_is_bit_reproducible_and_masked_keys_sort_last():
    """Kernel SK's plain version in JAX's (level, corner, sample) order: a
    masked (sample, level) gets the key n_rows and a zero value, so it sorts
    past every row; two backward passes give the same bits."""
    _, tspec = _specs(2, 5, 2, 8, 4, 1.6)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (100, 2)).astype(np.float32))
    dcols = torch.from_numpy(rng.normal(size=(tspec.n_output_dims, 100)).astype(np.float32))
    frac = torch.from_numpy(rng.uniform(0, 1, 100).astype(np.float32))
    live = [0, 1, 2, 3]
    keys, vals = tcss.sort_keys_plain(tspec, x, dcols, live, frac)
    idx, ws = tops.build_indices_weights(tspec, x, live, level_frac=frac, scatter=True)
    masked = (tops.level_mask(tspec, live, frac) == 0)[:, None, :].expand(4, 4, 100)
    assert torch.equal(keys.reshape(4, 4, 100)[masked],
                       torch.full((int(masked.sum()),), tspec.n_entries, dtype=torch.int32))
    assert torch.equal(keys.reshape(4, 4, 100)[~masked], idx.reshape(4, 4, 100)[~masked].int())
    assert not vals.reshape(4, 4, 100, 2)[masked].any()
    want = ws.reshape(4, 4, 100, 1) * dcols[:8].reshape(4, 2, 100).permute(0, 2, 1)[:, None]
    assert torch.equal(vals, want.reshape(-1, 2))
    a = tss.grid_table_gradient(tspec, torch.zeros(tspec.n_params), x, dcols, live, frac)
    b = tss.grid_table_gradient(tspec, torch.zeros(tspec.n_params), x, dcols, live, frac)
    assert torch.equal(a, b)


def test_sort_keys_equal_jax_updates():
    """Kernel SK's plain version against the updates JAX's branch sorts
    (``idx3.reshape(-1)`` and ``vals``, tcnn_tpu/ops/grid_ops.py:974-977):
    keys exact, values within the corner weights' atol 1e-6
    (tests/test_torch_grid.py: the same float32 operations, evaluated in
    another order by the two frameworks)."""
    jspec, tspec = _specs(3, 4, 2, 9, 4, 1.5, hash_type=tcommon.HashType.COHERENT_ADD)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    dcols = rng.normal(size=(tspec.n_output_dims, 64)).astype(np.float32)
    live = list(range(tspec.n_levels))
    idx, _, ws_bwd = jops._build_indices_weights(jspec, jnp.asarray(x), live)
    L, C, F = 4, 8, 2
    dc3 = jnp.asarray(dcols).reshape(L, F, 64)
    jvals = (ws_bwd.reshape(L, C, 64)[:, :, None, :] * dc3[:, None]).transpose(0, 1, 3, 2)
    keys, vals = tcss.sort_keys_plain(tspec, torch.from_numpy(x), torch.from_numpy(dcols), live)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(idx).reshape(-1))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals).reshape(-1, F), rtol=0,
                               atol=1e-6)


def _small_hash_config():
    """config_hash's structure at a small size: a 2-D HashGrid of 4 levels
    x 2 features, 2^10-row tables, into a FullyFusedMLP 16 x 1."""
    return {
        "loss": {"otype": "RelativeL2"},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
                      "epsilon": 1e-15, "l2_reg": 1e-6},
        "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                     "log2_hashmap_size": 10, "base_resolution": 8, "per_level_scale": 2.0},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 16, "n_hidden_layers": 1},
    }


def test_slice_training_steps_under_sortseg_equal_jax(sortseg, monkeypatch):
    """Three training steps of a small config_hash-structured model under
    ``sortseg`` on both sides (JAX forced through its custom VJP,
    ``TCNN_TPU_FORCE_FAST_SCATTER=1``, whose backward takes the branch); the
    route is the one the port's steps took.  Before each step JAX's state
    (parameters and Adam's moments and counters) is carried into the port,
    since Adam moves an entry by about ±lr whatever its gradient's size and
    a gradient within rounding of 0 may change sign.  Each step: the loss;
    the gradients (the table's per entry within the route's bound plus
    1e-5·S, the MLP's output gradient being summed in another order; the
    weights' within 1e-5 relative plus 1e-5 of the leaf's largest
    magnitude: sums over 512 samples whose terms cancel, in another order); the parameters after it, rtol 1e-4 and atol 1e-6, where the
    step's gradient exceeds 1e3 times its tolerance on both sides (Adam's
    update then moves by at most a few 1e-3 of lr·|m̂/√v̂| between them)."""
    monkeypatch.setenv("TCNN_TPU_FORCE_FAST_SCATTER", "1")
    cfg = _small_hash_config()
    jmodel = jtcnn.create_from_config(2, 3, cfg)
    state = jmodel.trainer.initial_state()
    rng = np.random.default_rng(0)
    grid = state.params["encoding"]["grid"]
    state.params["encoding"]["grid"] = jnp.asarray(
        rng.uniform(-1, 1, grid.shape).astype(np.float32))
    model = tcnn.create_from_config(2, 3, cfg, device="cpu")
    spec = model.network.encoding.spec
    calls = _route_calls(monkeypatch)
    for i in range(3):
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, state.params))
        load_jax_opt_state(model.trainer, jax.tree_util.tree_map(np.asarray, state.opt_state))
        x = rng.uniform(0, 1, (512, 2)).astype(np.float32)
        t = rng.uniform(0, 1, (512, 3)).astype(np.float32)
        _, want_g = jmodel.trainer.loss_value_and_grads(state.params, jnp.asarray(x),
                                                        jnp.asarray(t))
        _, grads = model.trainer.loss_value_and_grads(torch.from_numpy(x), torch.from_numpy(t))
        p, s, _ = _terms(*_step_updates(model, x, t), spec.n_entries)
        state, want_loss = jmodel.trainer.training_step(state, jnp.asarray(x), jnp.asarray(t))
        loss = model.trainer.training_step(torch.from_numpy(x), torch.from_numpy(t))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        want_g = flat_params(want_g)
        for name, want in flat_params(state.params).items():
            g, wg = grads[name].numpy(), want_g[name]
            if name == "encoding.grid":
                tol = (2.0 ** -19 * (p[None, :] + s) + 1e-5 * s).reshape(-1)
            else:
                tol = 1e-5 * np.abs(wg) + 1e-5 * np.abs(wg).max()
            assert (np.abs(g - wg) <= tol).all(), (i, name, float(np.abs(g - wg).max()))
            sure = (np.abs(g) > 1e3 * tol) & (np.abs(wg) > 1e3 * tol)
            assert sure.sum() >= 1000 or sure.mean() > 0.5
            np.testing.assert_allclose(model.trainer.params()[name].detach().numpy()[sure],
                                       want[sure], rtol=1e-4, atol=1e-6)
    assert len(calls) == 6   # each step's gradient and each step


def _step_updates(model, x, t):
    """Kernel SK's plain updates of the table gradient at the model's
    parameters on the batch (x, t): the output gradient of the grid from
    the MLP and the loss, then ``sort_keys_plain``."""
    enc, net = model.network.encoding, model.network.network
    xt = torch.from_numpy(x)
    with torch.enable_grad():
        y = enc(xt).detach().requires_grad_()
        loss = model.loss(net(y).float(), torch.from_numpy(t))
        (dy,) = torch.autograd.grad(loss, y)
    return tcss.sort_keys_plain(enc.spec, xt, dy.t(), list(range(enc.spec.n_levels)))

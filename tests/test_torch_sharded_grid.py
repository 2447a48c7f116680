"""Row-sharded grid tables in the port against the JAX package, on the CPU.

The port's ranks are gloo processes (``torch_parallel_ranks``, which
imports no JAX); the JAX side runs ``sharded_tables`` under ``shard_map`` on
the virtual CPU devices of ``tests/conftest.py``, on the same table, x,
output gradient and level fractions.  One spawn per world size (2 and 4)
runs every case; the parametrised tests compare its results.  Each case
compares the forward, the table gradient of ⟨y, dy⟩ (the sum over ranks
of their local cotangents, JAX's convention, no division), dx, the eikonal
loss's table gradient (÷ n, the group-mean convention of
``test_second_order_through_sharded_tables``), the forward under
per-sample level fractions, and a full-size (replicated) table under the
context.

Tolerances: outputs rtol 1e-5, atol 1e-7 (fp32 corner sums in another
order; JAX's own masked-forward test takes rtol 1e-5, atol 5e-8); every
gradient rtol 1e-5 plus 1e-6 of its largest magnitude (sums over corners
and samples in another order, and for the eikonal loss the port's closed
form weight derivatives against JAX's autodiff).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tcnn_tpu.common import GridType, HashType, InterpolationType
from tcnn_tpu.ops import grid_ops as jgo
from tcnn_tpu.parallel import make_mesh
from tcnn_tpu_torch.ops import grid_ops

import torch_parallel_ranks as ranks

B_LOCAL = 64

CASES = {
    # tests/test_sharding.py's config() grid
    "hash2d": dict(n_dims=2, n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
                   base_resolution=4, per_level_scale=1.5),
    # config_btf's kind: a 4-D CoherentAdd hash grid
    "coherent4d": dict(n_dims=4, n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
                       base_resolution=4, per_level_scale=1.5, hash_type="CoherentAdd"),
    # dense levels, Smoothstep (nonzero second derivatives per dim)
    "dense3d": dict(n_dims=3, n_levels=3, n_features_per_level=4, log2_hashmap_size=12,
                    base_resolution=4, per_level_scale=1.6, grid_type="Dense",
                    interpolation="Smoothstep"),
}


def jax_spec(kw):
    kw = dict(kw)
    if "hash_type" in kw:
        kw["hash_type"] = HashType.from_string(kw["hash_type"])
    if "grid_type" in kw:
        kw["grid_type"] = GridType.from_string(kw["grid_type"])
    if "interpolation" in kw:
        kw["interpolation"] = InterpolationType.from_string(kw["interpolation"])
    return jgo.make_grid_spec(**kw)


def case_data(name, n):
    spec = jax_spec(CASES[name])
    rng = np.random.default_rng([n, len(name)])
    b = n * B_LOCAL
    return {"spec": CASES[name],
            "table": (rng.normal(size=spec.n_params) * 1e-2).astype(np.float32),
            "x": rng.uniform(0, 1, (b, spec.n_dims)).astype(np.float32),
            "dy": rng.normal(size=(b, spec.n_output_dims)).astype(np.float32),
            "frac": rng.uniform(0, 1, b).astype(np.float32)}


def jax_case(case, n):
    """JAX's sharded encode of the case on n virtual devices: the same
    quantities as the ranks compute, in the block-cyclic layout for the
    table gradients."""
    spec = jax_spec(case["spec"])
    perm = jgo.block_cyclic_perm(spec, n)
    mesh = make_mesh(jax.devices()[:n], axis_name="model")

    def per_shard(ts, xs, dys, fracs):
        def local(t, x):
            with jgo.sharded_tables("model", n):
                y = jgo.grid_encode(spec, t, x)
            return jnp.vdot(y, dys), y

        (_, y), (g, dx) = jax.value_and_grad(local, argnums=(0, 1), has_aux=True)(ts, xs)

        def eik(t):
            with jgo.sharded_tables("model", n):
                gx = jax.grad(lambda xv: jgo.grid_encode(spec, t, xv).sum())(xs)
            return jnp.mean(gx * gx)

        with jgo.sharded_tables("model", n):
            y_frac = jgo.grid_encode(spec, ts, xs, max_level_per_element=fracs)
        return y, g, dx, jax.grad(eik)(ts) / n, y_frac

    f = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=(P("model"),) * 4,
                              out_specs=(P("model"),) * 5, check_vma=False))
    y, g, dx, eik, y_frac = f(case["table"][perm], case["x"], case["dy"], case["frac"])

    def full(t, x):
        with jgo.sharded_tables("model", n):
            return jgo.grid_encode(spec, t, x)

    y_full = jax.jit(jax.shard_map(full, mesh=mesh, in_specs=(P(), P("model")),
                                   out_specs=P("model"), check_vma=False))(case["table"],
                                                                           case["x"])
    return {k: np.asarray(v) for k, v in
            dict(y=y, g=g, dx=dx, eik=eik, y_frac=y_frac, y_full=y_full).items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request, tmp_path_factory):
    """One spawn of n ranks running every case; the JAX references."""
    n = request.param
    cases = {name: case_data(name, n) for name in CASES}
    outs = ranks.run(n, tmp_path_factory.mktemp(f"encode{n}"), "encode", {"cases": cases})
    return n, cases, outs, {name: jax_case(c, n) for name, c in cases.items()}


def test_block_cyclic_perm_and_shardable_levels_equal_jax():
    for kw in list(CASES.values()) + [dict(n_dims=2, n_levels=2, n_features_per_level=1,
                                           log2_hashmap_size=8, base_resolution=3,
                                           per_level_scale=1.5, grid_type="Tiled")]:
        js = jax_spec(kw)
        ts = ranks.make_spec(kw)
        for n in (2, 3, 4, 8):
            assert grid_ops.shardable_levels(ts, n) == jgo.shardable_levels(js, n)
            if jgo.shardable_levels(js, n):
                np.testing.assert_array_equal(grid_ops.block_cyclic_perm(ts, n),
                                              jgo.block_cyclic_perm(js, n))
            else:
                with pytest.raises(ValueError, match="shardable"):
                    grid_ops.block_cyclic_perm(ts, n)


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("what", ["y", "g", "dx", "eik", "y_frac", "y_full"])
def test_sharded_encode_matches_jax(world, name, what):
    n, cases, outs, ref = world
    got = np.concatenate([o[name][what] for o in outs])
    if what in ("y", "y_frac", "y_full"):
        np.testing.assert_allclose(got, ref[name][what], rtol=1e-5, atol=1e-7)
    else:
        _grad_close(got, ref[name][what])
    if what == "g":
        # every rank's gradient is its own block: the blocks tile the table
        assert got.shape == (jax_spec(cases[name]["spec"]).n_params,)


def test_sharded_encode_refusals(world):
    n, _, outs, _ = world
    for o in outs:
        assert "stochastic_interpolation" in o["stochastic"]
        assert "torch.func" in o["func"] and "gather_state" in o["func"]


def test_replicated_table_falls_through_on_one_process():
    """Without a process group a full-size table under the context is the
    ordinary encode, as JAX's test_replicated_table_falls_through."""
    import torch

    spec = ranks.make_spec(CASES["hash2d"])
    rng = np.random.default_rng(3)
    table = torch.from_numpy((rng.normal(size=spec.n_params) * 1e-2).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (32, 2)).astype(np.float32))
    want = grid_ops.grid_encode(spec, table, x)
    with grid_ops.sharded_tables(None, 4):
        got = grid_ops.grid_encode(spec, table, x)
        with pytest.raises(ValueError, match="shard"):
            grid_ops.grid_encode(spec, table[:100], x)
    assert torch.equal(got, want)

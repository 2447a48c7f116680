"""The port's grid geometry, index math and grid encoding against the
JAX package, on the CPU.

Inputs come from numpy with a seed and both packages get the same ones.
Tolerances:
  * geometry and corner indices: exact.
  * corner weights: atol 1e-6 (the same float32 operations; only the
    order in which a framework evaluates them may differ).
  * float32 grid outputs against JAX's plain path (fast_scatter=False):
    rtol 1e-5 (the corner sum may be taken in another order).
  * against the JAX kernel routes in interpret mode (fast_scatter=True):
    rtol 2e-4 / atol 1e-5, the split-bf16 tolerance of
    tests/test_grid_matmul.py (the TPU kernel splits f32 values into two
    bf16 terms, about 2^-17 relative).
  * bfloat16 outputs: within one bf16 ulp of the JAX value (an fp32 sum
    that differs in its last bit may round to the other neighbour).
"""

import dataclasses
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnn_tpu import common as jcommon
from tcnn_tpu.models.encodings import grid as jgrid
from tcnn_tpu.ops import grid_ops as jops
from tcnn_tpu_torch import common as tcommon
from tcnn_tpu_torch.models.encodings import grid as tgrid
from tcnn_tpu_torch.ops import grid_ops as tops

CONFIGS = sorted(Path(__file__).resolve().parents[1].glob("configs/*.json"))
GRID_OTYPES = {"grid", "hashgrid", "densegrid", "tiledgrid"}


def _load(path):
    return json.loads(re.sub(r"//[^\n]*", "", path.read_text()))


def _grid_cfgs(enc, n_dims):
    """(n_dims, cfg) of every grid encoding in an encoding config."""
    otype = enc.get("otype", "").lower()
    if otype in GRID_OTYPES:
        return [(enc.get("n_dims_to_encode", n_dims), enc)]
    if otype == "composite":
        return [c for nested in enc["nested"]
                for c in _grid_cfgs(nested, nested.get("n_dims_to_encode", n_dims))]
    return []


def _default_type(cfg):
    return {"densegrid": "Dense", "tiledgrid": "Tiled"}.get(
        cfg["otype"].lower(), "Hash")


def _spec_tuple(spec):
    return (spec.n_dims, spec.n_levels, spec.n_features_per_level,
            spec.grid_type.value, spec.hash_type.value,
            spec.interpolation.value, spec.n_entries,
            spec.stochastic_interpolation,
            tuple(dataclasses.astuple(lv) for lv in spec.levels))


def _specs(*args, **kw):
    """The same grid spec built by both packages."""
    jkw = {k: getattr(jcommon, type(v).__name__)(v.value) for k, v in kw.items()}
    return jops.make_grid_spec(*args, **jkw), tops.make_grid_spec(*args, **kw)


def _bf16_ulp(a):
    a = np.maximum(np.abs(a.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        err = np.abs(got - want)
        assert (err <= _bf16_ulp(want)).all(), err.max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_every_config_in_the_repo_has_a_grid():
    names = [p.name for p in CONFIGS
             if _grid_cfgs(_load(p).get("encoding", {}), 2)]
    assert {"config_hash.json", "config_btf.json"} <= set(names)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_level_specs_equal_jax_for_every_config(path):
    for n_dims, cfg in _grid_cfgs(_load(path).get("encoding", {}), 2):
        want = jgrid._make_grid(n_dims, cfg, _default_type(cfg)).spec
        got = tgrid._make_grid(n_dims, cfg, _default_type(cfg), device="cpu").spec
        assert _spec_tuple(got) == _spec_tuple(want)


def test_config_hash_geometry_uses_float32_scale():
    cfg = _load(CONFIGS[0].parent / "config_hash.json")["encoding"]
    spec = tgrid._make_grid(2, cfg, device="cpu").spec
    # float64 math would give 55 (grid_scale runs in float32).
    assert spec.levels[3].resolution == 54
    assert [lv.resolution for lv in spec.levels[:6]] == [16, 24, 36, 54, 81, 122]
    assert [lv.use_hash for lv in spec.levels] == [False] * 6 + [True] * 10
    assert spec.n_entries == 354184 and spec.n_params == 708368


@pytest.mark.parametrize("hash_type", ["Prime", "CoherentPrime", "ReversedPrime", "CoherentAdd"])
def test_hash_factors_and_hash_equal_jax(hash_type):
    ht = tcommon.HashType(hash_type)
    rng = np.random.default_rng(1)
    coords = rng.integers(0, 2 ** 32, (3, 257), dtype=np.uint64).astype(np.uint32)
    if ht != tcommon.HashType.COHERENT_ADD:
        assert tops.hash_factors(ht, 3) == jops.hash_factors(jcommon.HashType(hash_type), 3)
    want = jops._hash_coords(jcommon.HashType(hash_type),
                             [jnp.asarray(c) for c in coords])
    got = tops._hash_coords(ht, [torch.from_numpy(c.astype(np.int64)) for c in coords])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


INDEX_CASES = [
    # (n_dims, n_levels, F, log2_hashmap, base, scale, grid_type, hash, interp)
    (2, 16, 2, 15, 16, 1.5, "Hash", "CoherentPrime", "Linear"),
    (2, 6, 2, 9, 4, 2.0, "Hash", "Prime", "Smoothstep"),
    (3, 5, 4, 10, 4, 1.7, "Hash", "ReversedPrime", "Nearest"),
    (4, 5, 2, 12, 4, 1.5, "Hash", "CoherentAdd", "Linear"),
    (1, 4, 8, 6, 8, 2.0, "Hash", "CoherentPrime", "Linear"),
    (2, 5, 3, 10, 4, 1.8, "Dense", "CoherentPrime", "Linear"),
    (3, 4, 1, 10, 3, 1.5, "Tiled", "CoherentPrime", "Smoothstep"),
]


def _case_specs(case):
    D, L, F, hm, base, scale, gt, ht, it = case
    return _specs(D, L, F, hm, base, scale,
                  grid_type=tcommon.GridType(gt), hash_type=tcommon.HashType(ht),
                  interpolation=tcommon.InterpolationType(it))


def _coords(n, d, seed):
    # Negative and out-of-[0, 1] coordinates included.
    return np.random.default_rng(seed).uniform(-0.5, 1.5, (n, d)).astype(np.float32)


@pytest.mark.parametrize("case", INDEX_CASES, ids=lambda c: f"{c[0]}d-{c[6]}-{c[7]}-{c[8]}")
def test_indices_and_weights_equal_jax(case):
    jspec, tspec = _case_specs(case)
    x = _coords(777, tspec.n_dims, 2)
    live = list(range(tspec.n_levels))
    jidx, jws, _ = jops._build_indices_weights(jspec, jnp.asarray(x), live)
    idx, ws = tops.build_indices_weights(tspec, torch.from_numpy(x), live)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx).astype(np.int64))
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=0, atol=1e-6)


def test_rng_hash_waits_for_slice_3():
    """The Rng (pcg32) hash, once refused, now runs: the encoding of an Rng
    grid equals JAX's plain path (tests/test_torch_rng_grid.py holds the
    hash, the gradients and the kernel path)."""
    jspec, tspec = _specs(2, 4, 2, 6, 8, 2.0, hash_type=tcommon.HashType.RNG)
    table = np.random.default_rng(5).uniform(-1, 1, tspec.n_params).astype(np.float32)
    x = _coords(64, 2, 6)
    want = jops.grid_encode(jspec, jnp.asarray(table), jnp.asarray(x), fast_scatter=False)
    got = tops.grid_encode(tspec, torch.from_numpy(table), torch.from_numpy(x))
    _assert_close(got.numpy(), np.asarray(want), "float32")


@pytest.mark.parametrize("case", INDEX_CASES, ids=lambda c: f"{c[0]}d-{c[6]}-{c[7]}-{c[8]}")
@pytest.mark.parametrize("dtype,soa,max_level", [
    ("float32", False, None), ("bfloat16", True, None), ("float32", True, 3)])
def test_grid_encode_equals_jax_plain_path(case, dtype, soa, max_level):
    jspec, tspec = _case_specs(case)
    rng = np.random.default_rng(3)
    table = rng.uniform(-1, 1, tspec.n_params).astype(np.float32)
    x = _coords(513, tspec.n_dims, 4)
    want = jops.grid_encode(jspec, jnp.asarray(table).astype(dtype), jnp.asarray(x),
                            max_level=max_level, fast_scatter=False, soa=soa)
    got = tops.grid_encode(tspec, torch.from_numpy(table).to(getattr(torch, dtype)),
                           torch.from_numpy(x), max_level=max_level, soa=soa)
    assert str(got.dtype) == f"torch.{dtype}"
    _assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype)


def test_table_size_is_checked():
    _, tspec = _specs(2, 4, 2, 6, 8, 2.0)
    with pytest.raises(ValueError, match="table has"):
        tops.grid_encode(tspec, torch.zeros(tspec.n_params - 2), torch.rand(8, 2))
    with pytest.raises(ValueError, match="expected"):
        tops.grid_encode(tspec, torch.zeros(tspec.n_params), torch.rand(8, 3))


def _interpret_spec():
    # The XOR test geometry of tests/test_grid_matmul.py: dense levels and
    # power-of-two CoherentPrime hash levels.
    return _specs(2, 5, 2, 9, 4, 2.0)


@pytest.mark.parametrize("dtype,route", [("bfloat16", False), ("float32", "xor")])
def test_grid_encode_equals_jax_kernel_routes(dtype, route):
    """bf16 tables run every level through _gather_kernel; f32 tables run
    the XOR-eligible levels through _gather_kernel_xor (interpret mode)."""
    jspec, tspec = _interpret_spec()
    B = 1024
    # lv_meta as grid_encode builds it (grid_ops.py:1249-1261).
    meta = tuple((not lv.use_hash, lv.size, lv.offset,
                  lv.resolution >= 64 if not lv.use_hash
                  else lv.size & (lv.size - 1) == 0)
                 for lv in jspec.levels)
    mm, serial = jops._route_levels((2, 4, meta), jnp.dtype(dtype), B)
    assert serial == [] and mm == list(range(jspec.n_levels))
    routes = {pr for _, _, _, pr in jops._mm_class_plan(
        meta, mm, "gather", 1 if dtype == "bfloat16" else 2, B)}
    assert route in routes

    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, tspec.n_params).astype(np.float32)
    x = _coords(B, 2, 6)
    want = jops.grid_encode(jspec, jnp.asarray(table).astype(dtype), jnp.asarray(x),
                            fast_scatter=True, soa=True)
    got = tops.grid_encode(tspec, torch.from_numpy(table).to(getattr(torch, dtype)),
                           torch.from_numpy(x), soa=True)
    if dtype == "bfloat16":
        _assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)


def test_grid_encoding_module_matches_jax_module():
    cfg = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
           "log2_hashmap_size": 10, "base_resolution": 8, "per_level_scale": 1.5}
    jenc = jgrid._make_grid(2, cfg, policy=jcommon.BF16_POLICY)
    tenc = tgrid._make_grid(2, cfg, policy=tcommon.BF16_POLICY, device="cpu")
    table = np.random.default_rng(7).uniform(-1, 1, tenc.spec.n_params).astype(np.float32)
    with torch.no_grad():
        tenc.grid.copy_(torch.from_numpy(table))
    x = _coords(300, 2, 8)
    want = jenc.apply({"grid": jnp.asarray(table)}, jnp.asarray(x), soa=True)
    with torch.no_grad():
        got = tenc(torch.from_numpy(x), soa=True)
    assert got.dtype == torch.bfloat16 and tenc.n_params() == table.size
    _assert_close(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


def test_grid_init_is_seeded_and_in_range():
    cfg = {"otype": "HashGrid", "n_levels": 4, "log2_hashmap_size": 8}
    a = tgrid._make_grid(2, cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = tgrid._make_grid(2, cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a.grid, b.grid)
    assert a.grid.abs().max() <= 1e-4 and a.grid.abs().max() > 5e-5
    assert a.grid.shape == (a.spec.n_params,)

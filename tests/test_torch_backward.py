"""The plain versions of the port's backward kernels against the JAX
package's Pallas kernels in interpret mode, on the CPU.

  * ``grid_encode_bwd_plain`` (kernel GB) against ``jax.vjp`` of
    ``grid_encode(..., fast_scatter=True)``: a bf16 table routes every
    level through ``_scatter_kernel``, an f32 table the XOR-eligible
    levels through ``_scatter_kernel_xor``, and with
    ``TCNN_TPU_MM_PAIRED=1`` the adjacent levels through
    ``_scatter_kernel_paired`` (and the forward through
    ``_gather_kernel_paired``, held against kernel G's plain version).
    With ``TCNN_TPU_SCATTER=binned2`` a matmul class goes through
    ``binned_scatter.py::_binned_kernel`` instead.
  * ``fused_mlp_bwd_plain`` (kernel MB) against
    ``_fused_mlp_bwd_kernel_call``, i.e. ``_bwd_kernel``.

Tolerances:
  * table gradient, per row, with S = Σ|w·dy| over the row's updates:
    bf16 tables 2^-8·S plus one bf16 ulp of the JAX value (JAX rounds
    every product w·dy to bf16, 2^-9 relative, where the port keeps it
    exact in fp32, and the final cast may fall to the other neighbour);
    f32 tables 2e-5·S (the TPU kernels split each product into two bf16
    terms, about 2^-17 relative, and sum in another order).
  * grid forward under carry pairs: as tests/test_torch_grid.py, one bf16
    ulp, or rtol 2e-4 / atol 1e-5 for f32 tables.
  * MLP backward: fp32 1e-5 of each gradient's largest magnitude (sums
    over the batch in another order); bf16 1e-2 of it (a dz summed in
    another order may round to the other bf16 neighbour).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tcnn_tpu import common as jcommon
from tcnn_tpu.ops import grid_ops as jops
from tcnn_tpu.ops.pallas import fused_mlp as jfused
from tcnn_tpu_torch.common import Activation, HashType
from tcnn_tpu_torch.ops import grid_ops as tops
from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd_plain
from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd_plain,
                                                 grid_encode_plain)


def _interpret_spec():
    # The XOR test geometry of tests/test_grid_matmul.py: dense levels 0-2
    # and power-of-two CoherentPrime hash levels 3-4.
    return (jops.make_grid_spec(2, 5, 2, 9, 4, 2.0),
            tops.make_grid_spec(2, 5, 2, 9, 4, 2.0))


def _routes(jspec, dtype, direction, b):
    """The JAX dispatch classes of a direction (grid_ops.py:1249-1261)."""
    meta = tuple((not lv.use_hash, lv.size, lv.offset,
                  lv.resolution >= 64 if not lv.use_hash
                  else lv.size & (lv.size - 1) == 0)
                 for lv in jspec.levels)
    mm, serial = jops._route_levels((2, 4, meta), jnp.dtype(dtype), b)
    assert serial == [] and mm == list(range(jspec.n_levels))
    return {pr for _, _, _, pr in jops._mm_class_plan(
        meta, mm, direction, 1 if dtype == "bfloat16" else 2, b)}


def _bf16_ulp(a):
    a = np.maximum(np.abs(a.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _grid_vjp_case(dtype, seed, specs=None):
    jspec, tspec = specs or _interpret_spec()
    B = 1024
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, tspec.n_params).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, (B, 2)).astype(np.float32)
    dcols = rng.normal(size=(tspec.n_output_dims, B)).astype(np.float32)
    jt = jnp.asarray(table).astype(dtype)
    dcols = np.array(jnp.asarray(dcols).astype(dtype).astype(jnp.float32))
    _, vjp = jax.vjp(lambda t: jops.grid_encode(jspec, t, jnp.asarray(x),
                                                fast_scatter=True, soa=True), jt)
    (want,) = vjp(jnp.asarray(dcols).astype(dtype))
    tdt = getattr(torch, dtype)
    got = grid_encode_bwd_plain(tspec, torch.from_numpy(table).to(tdt),
                                torch.from_numpy(x),
                                torch.from_numpy(dcols).to(tdt),
                                list(range(tspec.n_levels)))
    scale = grid_encode_bwd_plain(tspec, torch.from_numpy(table),
                                  torch.from_numpy(x),
                                  torch.from_numpy(np.abs(dcols)),
                                  list(range(tspec.n_levels))).numpy()
    assert got.dtype == tdt and got.shape == want.shape
    return got.float().numpy(), np.asarray(want, np.float32), scale


def _assert_table_grad_close(got, want, scale, dtype):
    err = np.abs(got - want)
    tol = 2.0 ** -8 * scale + _bf16_ulp(want) if dtype == "bfloat16" else 2e-5 * scale
    assert (err <= tol + 1e-30).all(), (err - tol).max()
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("dtype,route", [("bfloat16", False), ("float32", "xor")])
def test_grid_encode_bwd_plain_equals_jax_scatter_kernels(dtype, route):
    """bf16 tables: _scatter_kernel on every level; f32 tables:
    _scatter_kernel_xor on the XOR-eligible levels (interpret mode)."""
    jspec, _ = _interpret_spec()
    assert route in _routes(jspec, dtype, "scatter", 1024)
    _assert_table_grad_close(*_grid_vjp_case(dtype, 11), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grid_encode_paired_kernels_equal_plain_versions(dtype, monkeypatch):
    """TCNN_TPU_MM_PAIRED=1: the dense levels go through the carry-pair
    kernels _gather_kernel_paired (row 3, kernel G's function) and
    _scatter_kernel_paired (row 5, kernel GB's function)."""
    monkeypatch.setenv("TCNN_TPU_MM_PAIRED", "1")
    jspec, tspec = _interpret_spec()
    assert "carry" in _routes(jspec, dtype, "scatter", 1024)
    assert "carry" in _routes(jspec, dtype, "gather", 1024)
    _assert_table_grad_close(*_grid_vjp_case(dtype, 12), dtype)

    rng = np.random.default_rng(13)
    table = rng.uniform(-1, 1, tspec.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (1024, 2)).astype(np.float32)
    want = np.asarray(jops.grid_encode(jspec, jnp.asarray(table).astype(dtype),
                                       jnp.asarray(x), fast_scatter=True, soa=True),
                      np.float32)
    got = grid_encode_plain(tspec, torch.from_numpy(table).to(getattr(torch, dtype)),
                            torch.from_numpy(x), list(range(tspec.n_levels)),
                            soa=True).float().numpy()
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grid_encode_bwd_plain_equals_jax_binned_scatter(dtype, monkeypatch):
    """TCNN_TPU_SCATTER=binned2: the table gradient of an unmerged matmul
    class with an even number of 128-row hi blocks goes through
    binned_scatter.py::_binned_kernel (row 13, kernel GB's function;
    grid_matmul.py:1284-1291) unless a tile overflows a bucket, when it
    takes the one-hot matmul instead.  Three 1024-row Prime hash levels
    (no XOR pairing, one class of r_pad 1024) split their rows evenly
    between the two halves, so no tile overflows.  The kernel rounds its
    products as _scatter_kernel does: row 4's tolerance."""
    from tcnn_tpu.ops.pallas import binned_scatter, grid_matmul

    monkeypatch.setenv("TCNN_TPU_SCATTER", "binned2")
    args = (2, 3, 2, 10, 64, 1.5)
    specs = (jops.make_grid_spec(*args, hash_type=jcommon.HashType.PRIME),
             tops.make_grid_spec(*args, hash_type=HashType.PRIME))
    jspec, B, seed = specs[0], 1024, 14
    meta = tuple((not lv.use_hash, lv.size, lv.offset, False) for lv in jspec.levels)
    plan = list(jops._mm_class_plan(meta, list(range(3)), "scatter",
                                    1 if dtype == "bfloat16" else 2, B))
    assert plan == [([0, 1, 2], 1024, False, False)]
    # No bucket overflow (binned_scatter.py:186-192) for the inputs of
    # _grid_vjp_case: its table, then its x, from the same seed.
    rng = np.random.default_rng(seed)
    rng.uniform(-1, 1, specs[1].n_params)
    x = rng.uniform(-0.2, 1.2, (B, 2)).astype(np.float32)
    idx = np.asarray(jops._build_indices_weights(jspec, jnp.asarray(x), [0, 1, 2])[0])
    local = idx.reshape(3, 4, B) - np.array([lv.offset for lv in jspec.levels])[:, None, None]
    t = min(binned_scatter._BIN_TILE, grid_matmul.batch_tile(B))
    c1 = (local >= 512).reshape(12, B // t, t).sum(-1)
    assert np.maximum(c1, t - c1).max() <= binned_scatter._cap(t)

    names = []
    real_pallas_call = pl.pallas_call

    def spy(*args, **kwargs):
        names.append(kwargs.get("name"))
        return real_pallas_call(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    case = _grid_vjp_case(dtype, seed, specs)
    assert "binned_scatter" in names
    _assert_table_grad_close(*case, dtype)


def _weights(dims, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, d) * np.sqrt(6.0 / sum(d))).astype(np.float32)
            for d in dims]


@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("soa_in,soa_out", [(True, False), (False, True)])
def test_fused_mlp_bwd_plain_equals_jax_bwd_kernel(width, dtype, soa_in, soa_out):
    dims = [(32, width), (width, width), (width, 3)]
    ws = _weights(dims, width + 7)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (300, 32)).astype(np.float32)
    g = rng.normal(size=(300, 3)).astype(np.float32)
    xin = x.T.copy() if soa_in else x
    gin = g.T.copy() if soa_out else g
    cdt = getattr(jnp, dtype)
    want_dws, want_dx = jfused._fused_mlp_bwd_kernel_call(
        tuple(jnp.asarray(w) for w in ws), jnp.asarray(xin), jnp.asarray(gin),
        jcommon.Activation.RELU, jcommon.Activation.SIGMOID, cdt, jnp.float32,
        soa_in, soa_out)
    got_dws, got_dx = fused_mlp_bwd_plain(
        [torch.from_numpy(w) for w in ws], torch.from_numpy(xin),
        torch.from_numpy(gin), Activation.RELU, Activation.SIGMOID,
        getattr(torch, dtype), soa_in, soa_out)
    assert got_dx.dtype == torch.float32 and got_dx.shape == xin.shape
    rel = 1e-5 if dtype == "float32" else 1e-2
    for got, want in zip([*got_dws, got_dx], [*want_dws, want_dx]):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= rel * np.abs(want).max()

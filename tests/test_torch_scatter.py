"""Kernel RS's plain version (the row scatter-add) against the JAX package's
row-scatter kernels, run in interpret mode on the CPU (tests/conftest.py):

  * row 9, ``tcnn_tpu/ops/pallas/scatter.py::_scatter_kernel``, through
    ``scatter_add_rows`` and ``scatter_add_rows_flat``;
  * row 10, ``::_scatter_cols_kernel``, through ``scatter_add_cols``.

The port keeps those three names (``tcnn_tpu_torch/ops/cuda/scatter.py``),
which on the CPU run ``row_scatter_add_plain`` (``index_add_`` in fp32).
M = 777 updates, not a multiple of the TPU kernels' tile, over 300 rows,
with F in {1, 2, 4, 8}.  Tolerance rtol 1e-5, atol 1e-4 (tests/test_scatter.py's):
the same fp32 sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnn_tpu.ops.pallas import scatter as jscatter
from tcnn_tpu_torch.ops.cuda import scatter as tscatter

M, N_ROWS = 777, 300


def _case(f, seed=0):
    rng = np.random.default_rng(seed + f)
    idx = rng.integers(0, N_ROWS, M).astype(np.int32)
    g = rng.normal(size=(M, f)).astype(np.float32)
    return idx, g


def _jax(route, idx, g):
    f = g.shape[1]
    if route == "rows":
        out = jscatter.scatter_add_rows(jnp.asarray(idx), jnp.asarray(g), N_ROWS)
    elif route == "rows_flat":
        out = jscatter.scatter_add_rows_flat(jnp.asarray(idx), jnp.asarray(g), N_ROWS, f)
    else:
        out = jscatter.scatter_add_cols(jnp.asarray(idx),
                                        tuple(jnp.asarray(g[:, k]) for k in range(f)), N_ROWS)
    return np.asarray(out)


def _port(route, idx, g):
    f = g.shape[1]
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g)
    if route == "rows":
        return tscatter.scatter_add_rows(ti, tg, N_ROWS)
    if route == "rows_flat":
        return tscatter.scatter_add_rows_flat(ti, tg, N_ROWS, f)
    return tscatter.scatter_add_cols(ti, [tg[:, k] for k in range(f)], N_ROWS)


@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("route", ["rows", "rows_flat", "cols"])
def test_row_scatter_plain_equals_jax_kernels(route, f):
    """rows / rows_flat: row 9 (_scatter_kernel); cols: row 10
    (_scatter_cols_kernel); the packed Pallas path in every case (F
    divides 128 and the table fits the VMEM budget)."""
    idx, g = _case(f)
    want = _jax(route, idx, g)
    got = _port(route, idx, g)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape == ((N_ROWS, f) if route == "rows" else (N_ROWS * f,))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_row_scatter_reads_g_through_strides_and_casts_once():
    """The column streams of row 10 as one (F, M) tensor, read in place
    through strides (1, M); a bf16 result is the fp32 sum cast once."""
    idx, g = _case(4, seed=5)
    want = np.zeros((N_ROWS, 4), np.float32)
    np.add.at(want, idx, g)
    streams = torch.from_numpy(np.ascontiguousarray(g.T))            # (F, M)
    got = tscatter.scatter_add_cols(torch.from_numpy(idx), streams, N_ROWS)
    np.testing.assert_allclose(got.numpy(), want.reshape(-1), rtol=1e-5, atol=1e-4)
    bf = tscatter.row_scatter_add(torch.from_numpy(idx), streams.t(), N_ROWS,
                                  torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, got.to(torch.bfloat16))


def test_row_scatter_drops_indices_out_of_range():
    """RS and its plain version drop updates at rows outside [0, n_rows),
    as jnp's .at[].add drops those beyond the table (the JAX kernels take
    no index outside the range)."""
    idx, g = _case(2, seed=6)
    idx[:5] = [-1, N_ROWS, N_ROWS + 7, -300, 2 ** 30]
    want = np.zeros((N_ROWS, 2), np.float32)
    np.add.at(want, idx[5:], g[5:])
    got = tscatter.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), N_ROWS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

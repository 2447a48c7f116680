"""The grid options the port once refused, against the JAX package, on the CPU:
the Rng (pcg32) hash, stochastic interpolation, grids of 5 to 7 dims, and
the level constants and arguments the kernels take for them.

  * Rng rows equal ``tcnn_tpu.ops.pcg32_hash.rng_hash`` and the port's own
    host model bit for bit for D = 1 to 7, and the jump-ahead constants
    written into ``csrc/grid_common.cuh`` equal the host model's.
  * The uniforms of stochastic interpolation equal
    ``jax.random.uniform(jax.random.key(1337), shape)`` bit for bit
    (``ops/threefry.py``), at the shapes a run uses.
  * Encode, table gradient, input gradient and second order on JAX's
    ``make_grid_spec(3, 3, 2, 6, 8, 1.5, hash_type=HashType.RNG)``, and on 5-,
    6- and 7-D hash grids, against JAX's plain path: outputs rtol 1e-5, the
    table gradient elementwise rtol 1e-4 / atol 1e-6 (fp32 sums in another
    order, tests/test_scatter.py:120), the other gradients within 1e-5 of
    their largest magnitude (1e-4 for the second order).
  * Stochastic interpolation: the table gradient against JAX's at the fp32
    policy, on ``TestGridGradients::test_stochastic_interpolation``'s spec
    and on a 2^10-sample batch (JAX through its custom VJP and Pallas
    kernels in interpret mode, which split each fp32 value into two bf16
    terms, about 2^-17 relative): per entry within 2^-16·S, S the sum of
    |cotangent| over the entry's updates; each (sample, level) puts its
    whole cotangent on one corner; the forward and the input gradient are
    the ordinary ones.
  * A snapshot of an Rng model in the CUDA original's format imports and
    trains a step in the port as in JAX.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
from tcnn_tpu import common as jcommon
from tcnn_tpu.ops import grid_ops as jops
from tcnn_tpu.ops import pcg32_hash as jpcg
from tcnn_tpu.utils import cuda_export as jexport
from tcnn_tpu.utils import cuda_import as jimport
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch import common as tcommon
from tcnn_tpu_torch.ops import grid_ops as tops
from tcnn_tpu_torch.ops import pcg32_hash as tpcg
from tcnn_tpu_torch.ops import threefry
from tcnn_tpu_torch.ops.cuda import grid_encode as tgrid
from tcnn_tpu_torch.utils import cuda_import

CSRC = Path(__file__).resolve().parents[1] / "tcnn_tpu_torch" / "csrc"


def _specs(*args, **kw):
    jkw = {k: getattr(jcommon, type(v).__name__)(v.value) if hasattr(v, "value") else v
           for k, v in kw.items()}
    return jops.make_grid_spec(*args, **jkw), tops.make_grid_spec(*args, **kw)


def _coords(spec, n, seed, lo=0.05, hi=0.95):
    """n points at least 1e-3 of a cell from every level's cell borders."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (8 * n, spec.n_dims)).astype(np.float32)
    keep = np.ones(len(x), bool)
    for lv in spec.levels:
        f = (x * np.float32(lv.scale)).astype(np.float32) + np.float32(0.5)
        f = f - np.floor(f)
        keep &= ((f > 1e-3) & (f < 1 - 1e-3)).all(axis=1)
    assert keep.sum() >= n
    return x[keep][:n]


def _rel(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert scale > 0, what
    assert np.abs(got - want).max() <= rel * scale, (what, np.abs(got - want).max(), scale)


# --- the pcg32 hash ------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7])
def test_rng_rows_equal_jax_and_the_host_model(d):
    rs = np.random.RandomState(d)
    coords = rs.randint(0, 2 ** 32, size=(d, 256), dtype=np.uint64)
    coords[:, :8] = rs.randint(0, 64, size=(d, 8))   # grid-sized coordinates too
    got = tpcg.rng_hash([torch.from_numpy(coords[i].astype(np.int64)) for i in range(d)])
    want = np.asarray(jpcg.rng_hash([jnp.asarray(coords[i].astype(np.uint32))
                                     for i in range(d)]))
    host = np.array([tpcg.rng_hash_host(coords[:, j]) for j in range(256)])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), host)
    assert all(tpcg.rng_hash_host(coords[:, j]) == jpcg.rng_hash_host(coords[:, j])
               for j in range(16))


def test_known_scalar_value():
    state, _ = tpcg.pcg32_state_after_seed(1337)
    zeros = torch.zeros(1, dtype=torch.int64)
    assert int(tpcg.rng_hash([zeros, zeros])[0]) == tpcg.pcg32_output(state)


def test_kernel_constants_equal_the_host_model():
    """csrc/grid_common.cuh's kPcgMult, kPcgPlus and kPcgState0."""
    text = (CSRC / "grid_common.cuh").read_text()

    def array(name):
        body = re.search(name + r"\[64\] = \{([^}]*)\}", text).group(1)
        return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)ull", body)]

    consts = tpcg.advance_constants()
    assert array("kPcgMult") == [m for m, _ in consts]
    assert array("kPcgPlus") == [p for _, p in consts]
    state0 = int(re.search(r"kPcgState0 = 0x([0-9a-f]+)ull", text).group(1), 16)
    assert state0 == tpcg.pcg32_state_after_seed(1337)[0]


# --- JAX's uniforms -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (3, 7), (16, 1 << 10), (8, 5000)])
def test_uniforms_equal_jax_bit_for_bit(shape):
    want = np.asarray(jax.random.uniform(jax.random.key(1337), shape))
    got = threefry.uniform(1337, shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    cached = tops.stochastic_uniforms(shape[0], shape[1], "cpu")
    assert cached is tops.stochastic_uniforms(shape[0], shape[1], torch.device("cpu"))
    np.testing.assert_array_equal(cached.numpy().view(np.uint32), want.view(np.uint32))


# --- grids against JAX's plain path ---------------------------------------------

def _check_grid(jspec, tspec, n, seed, second_order=True):
    """Output, table and input gradients (and second order) of <y, g>."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, tspec.n_params).astype(np.float32)
    x = _coords(tspec, n, seed + 1)
    g = rng.normal(size=(n, tspec.n_output_dims)).astype(np.float32)
    h = rng.normal(size=x.shape).astype(np.float32)

    def jloss(t, v):
        return jnp.sum(jops.grid_encode(jspec, t, v, fast_scatter=False) * jnp.asarray(g))

    # eager JAX: compiling the Rng hash's 64 unrolled steps per corner
    # takes longer than running them
    want_y = np.asarray(jops.grid_encode(jspec, jnp.asarray(table), jnp.asarray(x),
                                         fast_scatter=False))
    want_t, want_x = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tt = torch.from_numpy(table).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = tops.grid_encode(tspec, tt, xt)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-5 * np.abs(want_y).max())
    got_t, got_x = torch.autograd.grad(y, [tt, xt], torch.from_numpy(g),
                                       create_graph=second_order)
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t), rtol=1e-4, atol=1e-6)
    _rel(got_x, want_x, 1e-5, "input gradient")
    if not second_order:
        return
    want2 = jax.grad(lambda t, v: jnp.sum(jax.grad(jloss, argnums=1)(t, v) * jnp.asarray(h)),
                     argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    got2 = torch.autograd.grad((got_x * torch.from_numpy(h)).sum(), [tt, xt])
    _rel(got2[0], want2[0], 1e-4, "second order, table")
    _rel(got2[1], want2[1], 1e-4, "second order, x")


def test_rng_grid_equals_jax():
    """tests/test_grid.py::TestRngHash's grid (3-D, 3 levels x 2, 2^6 rows),
    Smoothstep, so that the second order has every term."""
    jspec, tspec = _specs(3, 3, 2, 6, 8, 1.5, hash_type=tcommon.HashType.RNG,
                          interpolation=tcommon.InterpolationType.SMOOTHSTEP)
    assert all(lv.use_hash for lv in tspec.levels)
    _check_grid(jspec, tspec, 64, 20)


@pytest.mark.parametrize("d,hash_type", [(5, "CoherentPrime"), (6, "Prime"),
                                          (7, "CoherentAdd")])
def test_wide_hash_grids_equal_jax(d, hash_type):
    """5- to 7-D hash grids (JAX's hash primes cover 7 dims): 2 levels of
    2^8 rows, hashed from level 0 at these dims."""
    jspec, tspec = _specs(d, 2, 2, 8, 4, 1.5, hash_type=tcommon.HashType(hash_type),
                          interpolation=tcommon.InterpolationType.SMOOTHSTEP)
    assert all(lv.use_hash for lv in tspec.levels)
    _check_grid(jspec, tspec, 48, 30 + d, second_order=d == 5)


@pytest.mark.parametrize("d", [5, 7])
def test_wide_rng_grid_rows_are_the_host_models(d):
    """An Rng grid of 5 and 7 dims: every corner row of
    ``build_indices_weights`` is the host model's hash of the corner,
    mod the level size, plus its offset (the hash itself equals JAX's,
    test_rng_rows_equal_jax_and_the_host_model; JAX's whole 7-D Rng grid
    takes minutes to run eagerly here)."""
    spec = tops.make_grid_spec(d, 2, 1, 8, 4, 1.5, hash_type=tcommon.HashType.RNG)
    x = torch.from_numpy(_coords(spec, 6, 60 + d))
    idx, _ = tops.build_indices_weights(spec, x, [0, 1])
    C = 1 << d
    for p, lv in enumerate(spec.levels):
        cells = np.floor(x.numpy() * np.float32(lv.scale) + np.float32(0.5)).astype(np.int64)
        for c in range(0, C, 5):
            corner = cells + np.array([(c >> k) & 1 for k in range(d)])
            want = [tpcg.rng_hash_host(corner[b]) % lv.size + lv.offset for b in range(6)]
            assert idx[p, c * 6:(c + 1) * 6].tolist() == want


def test_level_constants_and_hash_arguments_cover_seven_dims():
    spec = tops.make_grid_spec(7, 2, 2, 8, 4, 1.5, grid_type=tcommon.GridType.DENSE)
    lp = tops.level_params(spec, [0, 1]).view(np.uint32)
    assert lp.shape == (2, tops.LEVEL_FIELDS)
    for l, lv in enumerate(spec.levels):
        assert tuple(lp[l, 6:13]) == lv.strides
        assert (int(lp[l, 14]) << 32 | int(lp[l, 13])) == ((2 ** 64 - 1) // lv.size + 1) % 2 ** 64
    with pytest.raises(ValueError, match="at most 7"):
        tops.level_params(tops.make_grid_spec(8, 1, 2, 8, 4, 1.5), [0])
    rng_spec = tops.make_grid_spec(3, 2, 2, 8, 4, 1.5, hash_type=tcommon.HashType.RNG)
    assert tgrid._hash_args(rng_spec) == ([0] * 7, 2)
    add = tops.make_grid_spec(5, 2, 2, 8, 4, 1.5, hash_type=tcommon.HashType.COHERENT_ADD)
    assert tgrid._hash_args(add) == (list(tcommon.COHERENT_PRIME_HASH_FACTORS[:5]) + [0, 0], 1)


# --- stochastic interpolation ---------------------------------------------------

STOCHASTIC = dict(n_dims=2, n_levels=2, n_features_per_level=1, log2_hashmap_size=8,
                  base_resolution=4, per_level_scale=2.0)


@pytest.mark.parametrize("batch,interp", [(1, "Linear"), (1 << 10, "Linear"),
                                          (1 << 10, "Smoothstep")])
def test_stochastic_table_gradient_equals_jax(batch, interp):
    it = tcommon.InterpolationType.from_string(interp)
    jspec, tspec = _specs(**STOCHASTIC, stochastic_interpolation=True, interpolation=it)
    _, dspec = _specs(**STOCHASTIC, interpolation=it)
    rng = np.random.default_rng(batch)
    table = rng.normal(size=tspec.n_params).astype(np.float32)
    x = rng.uniform(0.3 if batch == 1 else 0.0, 0.7 if batch == 1 else 1.0,
                    (batch, 2)).astype(np.float32)
    g = rng.normal(size=(batch, tspec.n_output_dims)).astype(np.float32)
    want = jax.jit(jax.grad(lambda t: jnp.sum(jops.grid_encode(jspec, t, jnp.asarray(x))
                                              * jnp.asarray(g))))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = tops.grid_encode(tspec, tt, xt)
    got_t, got_x = torch.autograd.grad(y, [tt, xt], torch.from_numpy(g))
    _within_split_bf16(tspec, xt.detach(), g, got_t, want)
    # the forward and the input gradient are the deterministic grid's
    td = torch.from_numpy(table).requires_grad_()
    xd = torch.from_numpy(x).requires_grad_()
    yd = tops.grid_encode(dspec, td, xd)
    torch.testing.assert_close(y, yd, rtol=0, atol=0)
    torch.testing.assert_close(got_x, torch.autograd.grad(yd, xd, torch.from_numpy(g))[0],
                               rtol=0, atol=0)
    # each (sample, level) puts its whole cotangent on one corner
    live = list(range(tspec.n_levels))
    idx, ws = tops.build_indices_weights(tspec, xt.detach(), live, scatter=True)
    C = 4
    wsl = ws.reshape(len(live), C, batch)
    assert torch.equal(wsl.sum(1), torch.ones(len(live), batch))
    assert torch.equal((wsl == 1).sum(1), torch.ones(len(live), batch, dtype=torch.int64))
    if batch == 1:   # the JAX test's own check: one entry per level, the full cotangent
        for lv in tspec.levels:
            seg = got_t.numpy()[lv.offset:lv.offset + lv.size]
            nz = np.nonzero(seg)[0]
            assert len(nz) == 1
            np.testing.assert_allclose(seg[nz[0]], g[0, 0] if lv is tspec.levels[0]
                                       else g[0, 1], rtol=1e-6)


def _within_split_bf16(spec, x, g, got, want, live=None, frac=None):
    """|got − want| <= 2^-16·S per table entry, S = Σ|g| over its updates."""
    live = list(range(spec.n_levels)) if live is None else live
    s = tgrid.grid_encode_bwd_plain(spec, torch.zeros(spec.n_params), x,
                                    torch.from_numpy(np.abs(g)).t(), live, level_frac=frac)
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= 2.0 ** -16 * s.numpy()).all(), (err.max(), s.numpy()[err.argmax()])
    assert np.abs(np.asarray(want)).max() > 0


def test_stochastic_with_a_level_mask_and_a_static_cutoff():
    """The mask and max_level compose with the stochastic scatter as in JAX
    (its ws_bwd is multiplied by the mask; u keeps level l's row)."""
    jspec, tspec = _specs(3, 4, 2, 10, 4, 1.5, stochastic_interpolation=True)
    rng = np.random.default_rng(40)
    table = rng.normal(size=tspec.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    frac = rng.uniform(0, 1, 512).astype(np.float32)
    g = rng.normal(size=(512, tspec.n_output_dims)).astype(np.float32)
    want = jax.jit(jax.grad(lambda t: jnp.sum(jops.grid_encode(
        jspec, t, jnp.asarray(x), max_level=3, max_level_per_element=jnp.asarray(frac))
        * jnp.asarray(g))))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    y = tops.grid_encode(tspec, tt, torch.from_numpy(x), max_level=3,
                         max_level_per_element=torch.from_numpy(frac))
    (got,) = torch.autograd.grad(y, tt, torch.from_numpy(g))
    _within_split_bf16(tspec, torch.from_numpy(x), g, got, want, [0, 1, 2],
                       torch.from_numpy(frac))


# --- a snapshot of an Rng model --------------------------------------------------

RNG_CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
                 "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 2.0,
                 "hash": "Rng"},
    "network": {"otype": "MLP", "n_neurons": 16, "n_hidden_layers": 2},
}


def test_rng_snapshot_imports_and_trains_as_in_jax(tmp_path):
    """The CUDA original's snapshot of an Rng grid (written by the JAX
    package) runs end to end in the port: inference within the fp32
    tolerance, then one training step's loss at rtol 1e-5."""
    jmodel = jtcnn.create_from_config(2, 3, RNG_CONFIG)
    state = jmodel.trainer.initial_state()
    rng = np.random.default_rng(50)
    for _ in range(2):
        x = rng.uniform(0, 1, (256, 2)).astype(np.float32)
        t = rng.uniform(0, 1, (256, 3)).astype(np.float32)
        state, _ = jmodel.trainer.training_step(state, jnp.asarray(x), jnp.asarray(t))
    snap = jexport.export_snapshot(jmodel.trainer, state, serialize_optimizer=True)
    jstate = jimport.import_trainer_state(jmodel.trainer, snap)
    model = tcnn.create_from_config(2, 3, RNG_CONFIG, device="cpu")
    assert model.network.encoding.spec.hash_type == tcommon.HashType.RNG
    cuda_import.import_trainer_state(model.trainer, snap)
    x = rng.uniform(0, 1, (1024, 2)).astype(np.float32)
    want = np.asarray(jmodel.trainer.inference(jstate, jnp.asarray(x)))
    got = model.trainer.inference(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    t = rng.uniform(0, 1, (1024, 3)).astype(np.float32)
    _, jloss = jmodel.trainer.training_step(jstate, jnp.asarray(x), jnp.asarray(t))
    loss = model.trainer.training_step(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

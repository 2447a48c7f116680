"""The port's parameter-free encodings and the grid's per-sample level mask
against the JAX package, on the CPU.

Inputs come from numpy with a seed; both packages get the same ones.
Tolerances:
  * Identity, Frequency, TriangleWave, SphericalHarmonics (degrees 1-8, on
    unit directions), Empty and the NRC / OneBlobFrequency alias: fp32,
    atol and rtol 1e-6 on the outputs (the same float32 operations in the
    same order; sin and cos of the two libraries may differ in the last
    bit); their input gradients (autograd against ``jax.vjp``) rtol 1e-5,
    atol 1e-5 of the largest magnitude (each sums a row's terms, up to
    2^11·4 for a triangle wave of 12 frequencies, in another order).
  * the grid encoding with ``max_level_per_element`` (level fractions on
    the level boundaries 0 and k/L, and between them), alone and composed
    with a static ``max_level``, against the JAX package's plain path (the
    way ``tests/test_grid.py`` runs it on the CPU): output and table
    gradient within 1e-5 relative, and masked (sample, level) pairs exactly
    zero in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tcnn
from tcnn_tpu.config import create_encoding as jcreate_encoding
from tcnn_tpu.ops import grid_ops as jops
from tcnn_tpu_torch.models.network_with_input_encoding import NetworkWithInputEncoding
from tcnn_tpu_torch.ops import grid_ops as tops
from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd_input_plain,
                                                 grid_encode_bwd_plain, grid_encode_plain)

ENCODINGS = {
    "identity": (4, {"otype": "Identity", "scale": 1.5, "offset": -0.25}),
    "linear_alias": (3, {"otype": "Linear"}),
    "frequency": (3, {"otype": "Frequency", "n_frequencies": 6}),
    "nerf_alias": (2, {"otype": "NeRFEncoding", "n_frequencies": 12}),
    "triangle_wave": (3, {"otype": "TriangleWave", "n_frequencies": 7}),
    "empty": (3, {"otype": "Empty"}),
    "nrc": (10, {"otype": "NRC", "n_frequencies": 5, "n_bins": 4}),
    "one_blob_frequency": (9, {"otype": "OneBlobFrequency"}),
    "composite_of_basics": (9, {"otype": "Composite", "nested": [
        {"otype": "Identity", "n_dims_to_encode": 2},
        {"otype": "Empty", "n_dims_to_encode": 1},
        {"otype": "SphericalHarmonics", "degree": 3, "n_dims_to_encode": 3},
        {"otype": "Frequency", "n_frequencies": 2}]}),
}


def _pair(n_dims, cfg):
    return (jcreate_encoding(n_dims, cfg),
            tcnn.create_encoding(n_dims, cfg, device="cpu"))


def _check_output_and_vjp(jenc, tenc, x, seed):
    """Outputs at 1e-6, then the input gradient of <y, g> for a random g."""
    params = jenc.init(jax.random.key(0))
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = tenc(xt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert tenc.n_output_dims == jenc.n_output_dims == want.shape[1]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    if want.shape[1] == 0:
        return
    g = np.random.default_rng(seed).normal(size=want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jenc.apply(params, v), jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.asarray(g))[0])
    if not got.requires_grad:   # a constant (SH of degree 1)
        assert not np.any(want_dx)
        return
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got_dx.numpy(), want_dx, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_dx).max()))


@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_encoding_equals_jax(name):
    n_dims, cfg = ENCODINGS[name]
    jenc, tenc = _pair(n_dims, cfg)
    assert tenc.hyperparams() == jenc.hyperparams()
    x = np.random.default_rng(len(name)).uniform(-0.2, 1.2, (513, n_dims)).astype(np.float32)
    _check_output_and_vjp(jenc, tenc, x, seed=len(name))


@pytest.mark.parametrize("degree", range(1, 9))
def test_spherical_harmonics_equals_jax(degree):
    """Degrees 1-8 on unit directions (SH's contract), given as the
    encoding takes them: (d + 1) / 2 in [0, 1]^3."""
    d = np.random.default_rng(degree).normal(size=(777, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = (d * 0.5 + 0.5).astype(np.float32)
    jenc, tenc = _pair(3, {"otype": "SH", "degree": degree})
    assert tenc.n_output_dims == degree ** 2
    _check_output_and_vjp(jenc, tenc, x, seed=degree)


def test_spherical_harmonics_refuses_what_jax_refuses():
    for cfg, n in (({"otype": "SphericalHarmonics", "degree": 9}, 3),
                   ({"otype": "SphericalHarmonics", "degree": 4}, 2)):
        with pytest.raises(ValueError):
            tcnn.create_encoding(n, cfg, device="cpu")


def test_basic_encodings_need_a_device_or_the_cpu_asked_for(monkeypatch):
    """No parameters, but the port's contract: the default is cuda, which
    raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n_dims, cfg in ENCODINGS.values():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tcnn.create_encoding(n_dims, cfg)


# -- the grid's per-sample level mask (coarse-to-fine) -------------------------

# (n_dims, n_levels, F, log2_hashmap, base, scale, grid type)
MASK_GRIDS = {
    "hash_2d": (2, 4, 2, 10, 4, 2.0, "Hash"),           # tests/test_grid.py's grid
    "nerf_3d": (3, 12, 2, 12, 16, 1.45, "Hash"),        # the NeRF sample's levels, small tables
    "dense_3d": (3, 5, 1, 14, 4, 1.6, "Dense"),
}


def _mask_inputs(n_dims, n_levels, seed, batch=1024):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (batch, n_dims)).astype(np.float32)
    # every level boundary k/L (0 and 1 included) and fractions between them
    choices = np.concatenate([np.arange(n_levels + 1) / n_levels, [0.37, 0.5, 0.999]])
    frac = rng.choice(choices.astype(np.float32), size=batch).astype(np.float32)
    return x, frac


def _specs(case):
    D, L, F, hm, base, scale, gtype = MASK_GRIDS[case]
    kw = dict(n_dims=D, n_levels=L, n_features_per_level=F, log2_hashmap_size=hm,
              base_resolution=base, per_level_scale=scale)
    return (jops.make_grid_spec(**kw, grid_type=jops.GridType.from_string(gtype)),
            tops.make_grid_spec(**kw, grid_type=tcnn.GridType.from_string(gtype)))


@pytest.mark.parametrize("case", sorted(MASK_GRIDS))
@pytest.mark.parametrize("max_level", [None, 3])
def test_grid_encode_with_per_sample_max_level_equals_jax(case, max_level):
    jspec, tspec = _specs(case)
    x, frac = _mask_inputs(jspec.n_dims, jspec.n_levels, seed=len(case))
    table = np.random.default_rng(5).uniform(-1, 1, jspec.n_params).astype(np.float32)
    g = np.random.default_rng(6).normal(size=(1024, jspec.n_output_dims)).astype(np.float32)

    def jloss(t):
        y = jops.grid_encode(jspec, t, jnp.asarray(x), max_level=max_level, fast_scatter=False,
                             max_level_per_element=jnp.asarray(frac))
        return jnp.sum(y * jnp.asarray(g)), y

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(table))
    want, want_grad = np.asarray(want), np.asarray(want_grad)

    tt = torch.from_numpy(table).requires_grad_()
    got = tops.grid_encode(tspec, tt, torch.from_numpy(x), max_level=max_level,
                           max_level_per_element=torch.from_numpy(frac))
    (got_grad,) = torch.autograd.grad(got, tt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-5 * np.abs(want_grad).max())

    # the rule itself: level l is live for sample b iff l < frac·L + 1e-3
    # (and below the static cutoff); dead pairs are exact zeros on both sides
    F, L = jspec.n_features_per_level, jspec.n_levels
    thr = frac.reshape(-1, 1) * np.float32(L) + np.float32(1e-3)
    live = np.arange(L)[None, :] < thr
    if max_level is not None:
        live &= np.arange(L)[None, :] < max_level
    dead = np.repeat(~live, F, axis=1)
    assert not np.any(want[dead]) and not np.any(got.detach().numpy()[dead])
    assert live.any() and (~live).any()


def test_level_boundaries_follow_jax_rounding():
    """frac = k/L exactly: the threshold k + 1e-3 (after two fp32
    roundings) keeps level k; frac just below k/L does not."""
    tspec = _specs("nerf_3d")[1]
    L = tspec.n_levels
    fr = torch.tensor([k / L for k in range(L + 1)], dtype=torch.float32)
    m = tops.level_mask(tspec, list(range(L)), fr)             # (L, L + 1)
    assert torch.equal(m.sum(0), torch.arange(1, L + 2).clamp(max=L).float())
    below = tops.level_mask(tspec, list(range(L)), torch.nextafter(fr, torch.zeros(())) - 1e-3)
    assert torch.equal(below.sum(0)[1:], torch.arange(1, L + 1).float())


def test_masked_input_gradient_equals_jax():
    """Kernel GI's plain version under the mask: JAX's input gradient of
    the masked encoding (the mask multiplies the weights, so their
    x-derivatives too)."""
    jspec, tspec = _specs("hash_2d")
    x, frac = _mask_inputs(2, jspec.n_levels, seed=9, batch=300)
    table = np.random.default_rng(10).uniform(-1, 1, jspec.n_params).astype(np.float32)
    g = np.random.default_rng(11).normal(size=(300, jspec.n_output_dims)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jops.grid_encode(
        jspec, jnp.asarray(table), v, fast_scatter=False,
        max_level_per_element=jnp.asarray(frac)) * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tops.grid_encode(tspec, torch.from_numpy(table), xt,
                         max_level_per_element=torch.from_numpy(frac))
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_masked_plain_versions_agree_with_their_unmasked_rows():
    """All ones keeps every level (the unmasked result); all zeros keeps
    level 0 alone, as the static cutoff max_level = 1 does, in G's, GB's
    and GI's plain versions."""
    tspec = _specs("nerf_3d")[1]
    x, _ = _mask_inputs(3, tspec.n_levels, seed=12, batch=200)
    x = torch.from_numpy(x)
    flat = torch.from_numpy(np.random.default_rng(13).uniform(
        -1, 1, tspec.n_params).astype(np.float32))
    dc = torch.from_numpy(np.random.default_rng(14).normal(
        size=(tspec.n_output_dims, 200)).astype(np.float32))
    live = list(range(tspec.n_levels))
    for fn, args in ((grid_encode_plain, (True,)), (grid_encode_bwd_plain, ()),
                     (grid_encode_bwd_input_plain, ())):
        pre = (dc,) if fn is not grid_encode_plain else ()
        ones = fn(tspec, flat, x, *pre, live, *args, level_frac=torch.ones(200))
        zeros = fn(tspec, flat, x, *pre, live, *args, level_frac=torch.zeros(200))
        torch.testing.assert_close(ones, fn(tspec, flat, x, *pre, live, *args), rtol=0, atol=0)
        torch.testing.assert_close(zeros, fn(tspec, flat, x, *pre, [0], *args), rtol=0, atol=0)


def test_mask_shape_is_checked():
    tspec = _specs("hash_2d")[1]
    table = torch.zeros(tspec.n_params)
    with pytest.raises(ValueError, match="max_level_per_element"):
        tops.grid_encode(tspec, table, torch.rand(10, 2), max_level_per_element=torch.ones(9))


@pytest.mark.parametrize("interp", ["Linear", "Smoothstep"])
def test_masked_second_order_raises(interp):
    """A second derivative under a per-sample level mask, once refused
    (kernel GG took no mask), now runs: the gradient of ⟨∇_x y·g, h⟩ in the
    table and in x against JAX's ``jax.grad`` of its input gradient with the
    same fractions (kernels GG and RS's plain versions; within 1e-5 of the
    largest magnitude, sums over corners and levels in another order)."""
    D, L, F, hm, base, scale, gtype = MASK_GRIDS["hash_2d"]
    kw = dict(n_dims=D, n_levels=L, n_features_per_level=F, log2_hashmap_size=hm,
              base_resolution=base, per_level_scale=scale)
    jspec = jops.make_grid_spec(**kw, interpolation=jops.InterpolationType.from_string(interp))
    tspec = tops.make_grid_spec(**kw, interpolation=tcnn.InterpolationType.from_string(interp))
    x, frac = _mask_inputs(D, L, seed=15, batch=256)
    rng = np.random.default_rng(16)
    table = rng.uniform(-1, 1, jspec.n_params).astype(np.float32)
    g = rng.normal(size=(256, jspec.n_output_dims)).astype(np.float32)
    h = rng.normal(size=(256, D)).astype(np.float32)

    def jfn(t, v):
        gx = jax.grad(lambda u: jnp.sum(jops.grid_encode(
            jspec, t, u, fast_scatter=False, max_level_per_element=jnp.asarray(frac))
            * jnp.asarray(g)))(v)
        return jnp.sum(gx * jnp.asarray(h))

    want_t, want_x = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jnp.asarray(table), jnp.asarray(x))
    tt = torch.from_numpy(table).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = tops.grid_encode(tspec, tt, xt, max_level_per_element=torch.from_numpy(frac))
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g), create_graph=True)
    got_t, got_x = torch.autograd.grad((gx * torch.from_numpy(h)).sum(), [tt, xt])
    for got, want in ((got_t, want_t), (got_x, want_x)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_network_with_input_encoding_forwards_the_mask():
    """The mask reaches the grid through the model's forward and its
    inference path (tcnn_tpu/models/network_with_input_encoding.py:75-105)."""
    model = tcnn.create_network_with_input_encoding(
        3, 4, {"otype": "HashGrid", "n_levels": 6, "log2_hashmap_size": 10},
        {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1},
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(model, NetworkWithInputEncoding)
    x = torch.rand(64, 3)
    frac = torch.full((64,), 2 / 6)
    feats = model.encoding(x, max_level_per_element=frac)
    assert not bool(feats[:, 6:].any()) and bool(feats[:, :6].any())
    want = model.network(feats)
    torch.testing.assert_close(model(x, max_level_per_element=frac), want)
    torch.testing.assert_close(model.inference(x, max_level_per_element=frac), want)
    assert not torch.equal(model(x), want)

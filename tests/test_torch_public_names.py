"""Public names of the JAX package that the port carries, against JAX, on
the CPU: ``GridEncoding``'s parameter accounting and output alignment,
``Encoding.required_output_alignment``, ``grid_ops.level_indices`` and
``init_grid_params``, ``activations.is_invertible``, ``Registry.names``,
``Policy.cast_to_compute`` / ``cast_to_output`` and ``default_policy``,
``Network.width``, ``n_hidden_layers`` and ``layer_sizes``, and
``Encoding.forward_padded`` (JAX's ``apply_padded``).
Integers and dtypes exact; ``init_grid_params`` draws from a torch
generator, so its numbers differ from JAX's: shape, dtype, range and
seeding are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
from tcnn_tpu import common as jcommon
from tcnn_tpu import registry as jregistry
from tcnn_tpu.models.encodings import grid as jgrid
from tcnn_tpu.ops import activations as jact
from tcnn_tpu.ops import grid_ops as jops
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch import common as tcommon
from tcnn_tpu_torch import registry as tregistry
from tcnn_tpu_torch.models.encodings import grid as tgrid
from tcnn_tpu_torch.ops import activations as tact
from tcnn_tpu_torch.ops import grid_ops as tops

GRIDS = [  # (n_dims, cfg)
    (2, {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
         "log2_hashmap_size": 15, "base_resolution": 16, "per_level_scale": 1.5}),
    (3, {"otype": "DenseGrid", "n_levels": 4, "n_features_per_level": 4,
         "base_resolution": 4}),
    (2, {"otype": "TiledGrid", "n_levels": 5, "n_features_per_level": 1,
         "base_resolution": 3, "per_level_scale": 1.5}),
]


@pytest.mark.parametrize("n_dims,cfg", GRIDS, ids=lambda c: c["otype"] if isinstance(c, dict)
                         else str(c))
def test_grid_encoding_parameter_accounting_equals_jax(n_dims, cfg):
    want = jgrid._make_grid(n_dims, cfg, {"densegrid": "Dense", "tiledgrid": "Tiled"}.get(
        cfg["otype"].lower(), "Hash"))
    got = tgrid._make_grid(n_dims, cfg, {"densegrid": "Dense", "tiledgrid": "Tiled"}.get(
        cfg["otype"].lower(), "Hash"), device="cpu")
    assert got.n_params() == want.n_params() == got.grid.numel()
    for level in range(got.spec.n_levels + 2):   # past the last level: the table's size
        assert got.level_params_offset(level) == want.level_params_offset(level)
    for level in range(got.spec.n_levels):
        assert got.level_n_params(level) == want.level_n_params(level)
    assert got.required_output_alignment() == want.required_output_alignment()
    # a level's slice of the flat table, tiny-cuda-nn's way to read one level
    lv = got.spec.n_levels - 1
    part = got.grid[got.level_params_offset(lv):got.level_params_offset(lv + 1)]
    assert part.numel() == got.level_n_params(lv)


def test_encoding_alignment_defaults_to_one():
    assert tcnn.IdentityEncoding(3, device="cpu").required_output_alignment() == \
        jtcnn.IdentityEncoding(3).required_output_alignment() == 1


@pytest.mark.parametrize("grid_type,hash_type", [
    ("Hash", "CoherentPrime"), ("Hash", "Prime"), ("Hash", "CoherentAdd"),
    ("Hash", "ReversedPrime"), ("Dense", "CoherentPrime"), ("Tiled", "CoherentPrime")])
def test_level_indices_equal_jax(grid_type, hash_type):
    args = (3, 6, 2, 10, 4, 1.7)
    jspec = jops.make_grid_spec(*args, grid_type=jcommon.GridType(grid_type),
                                hash_type=jcommon.HashType(hash_type))
    tspec = tops.make_grid_spec(*args, grid_type=tcommon.GridType(grid_type),
                                hash_type=tcommon.HashType(hash_type))
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 2 ** 32, (5, 7, 3), dtype=np.uint64).astype(np.uint32)
    pos[0] = rng.integers(0, 40, (7, 3))   # small coordinates: the dense levels' range
    for jl, tl in zip(jspec.levels, tspec.levels):
        want = np.asarray(jops.level_indices(jspec, jl, jnp.asarray(pos)))
        got = tops.level_indices(tspec, tl, torch.from_numpy(pos.astype(np.int64)))
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_init_grid_params_is_seeded_and_in_range():
    spec = tops.make_grid_spec(2, 4, 2, 8, 4, 1.5)
    jspec = jops.make_grid_spec(2, 4, 2, 8, 4, 1.5)
    want = jops.init_grid_params(jax.random.key(0), jspec, scale=2.0)
    a = tops.init_grid_params(torch.Generator().manual_seed(3), spec, scale=2.0)
    b = tops.init_grid_params(torch.Generator().manual_seed(3), spec, scale=2.0)
    assert a.shape == tuple(want.shape) == (spec.n_entries, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 2e-4 and float(np.abs(np.asarray(want)).max()) <= 2e-4
    assert float(a.abs().max()) > 1.5e-4   # the whole range is drawn
    # GridEncoding's table is this draw, flat
    enc = tgrid.GridEncoding(2, 4, 2, 8, 4, 1.5, generator=torch.Generator().manual_seed(3),
                             device="cpu")
    assert torch.equal(enc.grid.detach(),
                       tops.init_grid_params(torch.Generator().manual_seed(3), spec).reshape(-1))
    assert tops.init_grid_params(None, spec, dtype=torch.bfloat16).dtype == torch.bfloat16


def test_is_invertible_equals_jax():
    for act in tcommon.Activation:
        assert tact.is_invertible(act) == jact.is_invertible(jcommon.Activation(act.value)), act


def test_registry_names_equal_jax():
    for kind in ("encodings", "networks", "losses", "optimizers"):
        got = list(getattr(tregistry, kind).names())
        want = list(getattr(jregistry, kind).names())
        assert got == sorted(got)
        # the port registers every name the JAX package does (the JAX names
        # are the reference; the port may register no extra one)
        assert got == want, (kind, set(got) ^ set(want))


@pytest.mark.parametrize("policy", ["DEFAULT_POLICY", "BF16_POLICY"])
def test_policy_casts_equal_jax(policy):
    jp, tp = getattr(jcommon, policy), getattr(tcommon, policy)
    values = np.array([1.0, -2.5, 3.14159265, 1e-3], np.float32)
    for cast in ("cast_to_compute", "cast_to_output"):
        want = np.asarray(getattr(jp, cast)(jnp.asarray(values)), np.float32)
        for given in (values, torch.from_numpy(values), 3.14159265):
            got = getattr(tp, cast)(given)
            assert str(got.dtype).split(".")[-1] == str(getattr(jp, cast)(
                jnp.asarray(values)).dtype)
            if not isinstance(given, float):
                np.testing.assert_array_equal(got.float().numpy(), want)
    assert tcommon.default_policy() is tcommon.DEFAULT_POLICY
    assert jcommon.default_policy() is jcommon.DEFAULT_POLICY


NETWORKS = [{"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
            {"otype": "CutlassMLP", "n_neurons": 16, "n_hidden_layers": 3},
            {"otype": "MLP", "n_neurons": 32, "n_hidden_layers": 0}]


@pytest.mark.parametrize("cfg", NETWORKS, ids=lambda c: f"{c['otype']}-{c['n_hidden_layers']}")
def test_network_width_depth_and_layer_sizes_equal_jax(cfg):
    """``Network.width``, ``n_hidden_layers`` and ``layer_sizes()``
    (``tcnn_tpu/module.py:176-184``), exactly."""
    want = jtcnn.create_network(cfg, 5, 3)
    got = tcnn.create_network(cfg, 5, 3, device="cpu")
    assert got.width == want.width == cfg["n_neurons"]
    assert got.n_hidden_layers == want.n_hidden_layers == cfg["n_hidden_layers"]
    assert got.layer_sizes() == want.layer_sizes(want.init(jax.random.key(0)))
    assert len(got.layer_sizes()) == cfg["n_hidden_layers"] + 1


ENCODINGS = [  # (n_dims, cfg)
    (3, {"otype": "Identity"}),
    (3, {"otype": "Frequency", "n_frequencies": 2}),
    (3, {"otype": "TriangleWave", "n_frequencies": 3}),
    (2, {"otype": "OneBlob", "n_bins": 4}),
    (3, {"otype": "SphericalHarmonics", "degree": 3}),
    (3, {"otype": "Empty"}),
    (2, {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
         "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 1.5}),
    (4, {"otype": "Composite", "nested": [
        {"otype": "HashGrid", "n_dims_to_encode": 2, "n_levels": 2, "n_features_per_level": 2,
         "log2_hashmap_size": 8, "base_resolution": 4},
        {"otype": "OneBlob", "n_bins": 4}]}),
]


@pytest.mark.parametrize("n_dims,cfg", ENCODINGS, ids=[c["otype"] for _, c in ENCODINGS])
def test_forward_padded_equals_jax_apply_padded(n_dims, cfg):
    """``Encoding.forward_padded`` against JAX's ``apply_padded``
    (``tcnn_tpu/module.py:161-169``; ``tests/test_encodings.py:194`` is
    its own case): the same width, the output in place (rtol 1e-6, the
    same float32 math) and constant-1 columns after it, exactly; a width
    below the output's raises."""
    from tcnn_tpu_torch.utils.jax_params import load_jax_params

    jenc = jtcnn.create_encoding(n_dims, cfg)
    params = jenc.init(jax.random.key(1))
    enc = tcnn.create_encoding(n_dims, cfg, device="cpu")
    if params:
        load_jax_params(enc, jax.tree_util.tree_map(np.asarray, params))
    x = np.random.default_rng(3).uniform(0, 1, (16, n_dims)).astype(np.float32)
    n_out = enc.n_output_dims
    assert n_out == jenc.n_output_dims
    for width in (n_out, n_out + 5):
        want = np.asarray(jenc.apply_padded(params, jnp.asarray(x), width))
        got = enc.forward_padded(torch.from_numpy(x), width)
        assert got.shape == want.shape == (16, width)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(got[:, :n_out].detach().float().numpy(), want[:, :n_out],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[:, n_out:].detach().float().numpy(), want[:, n_out:])
        assert (want[:, n_out:] == 1).all()
    with pytest.raises(ValueError, match="padded width"):
        enc.forward_padded(torch.from_numpy(x), n_out - 1)

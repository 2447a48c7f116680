"""Slice 3: the BTF path (configs/config_btf.json) in the port against the
JAX package, on the CPU.

Inputs come from numpy with a seed; ``load_jax_params`` carries the JAX
parameters across.  Tolerances:
  * OneBlob and Composite (parameter-free nested encodings): rtol 1e-6,
    atol 1e-7 (the same float32 operations in the same order; a bin value
    is a difference of two CDF values near 1, where one ulp of either is
    6e-8).
  * table gradient against the JAX package's serial routes,
    scatter.py::_weighted_kernel (row 11 of PERF.md's kernel table) and
    ::_pair_kernel (row 12), in interpret mode: both stream fp32 and form
    each product w·dy exactly as the port does, so the two differ only in
    the order of the fp32 sum: per table entry, |d| <= 2·n·2^-24·S with n
    its number of updates and S = Σ|w·dy| over them, plus one bf16 ulp of
    the value for bf16 tables (the final cast may fall to the other
    neighbour).
  * one full-width config_btf inference, DEFAULT_POLICY, JAX's plain
    path: rtol 1e-5, atol 1e-5 on O(1) outputs (tests/test_torch_slice.py).
  * one training step of a config_btf-structured model (4-D CoherentAdd
    grid of 4 levels, OneBlob 4 bins, FullyFusedMLP 64 x 3): the
    tolerances of tests/test_torch_train.py's config_hash steps, fp32 on
    JAX's plain path and bf16 with TCNN_TPU_FORCE_FAST_SCATTER=1 (JAX runs
    _gather_kernel, _scatter_kernel, _fwd_kernel and _bwd_kernel in
    interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu import common as jcommon
from tcnn_tpu.models.encodings import basic as jbasic
from tcnn_tpu.ops import grid_ops as jops
from tcnn_tpu_torch import common as tcommon
from tcnn_tpu_torch.ops import grid_ops as tops
from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd_plain
from tcnn_tpu_torch.samples.fit_btf import synthetic_btf
from tcnn_tpu_torch.utils.jax_params import load_jax_params

from test_torch_slice import BTF_CONFIG, small_btf_config
from test_torch_train import _jax_state, _step_against_jax

# -- (a) OneBlob and Composite --------------------------------------------


@pytest.mark.parametrize("n_bins", [4, 16])
def test_oneblob_equals_jax(n_bins):
    # outside [0, 1] too: the wraparound terms carry the mass back
    x = np.random.default_rng(n_bins).uniform(-0.3, 1.3, (700, 3)).astype(np.float32)
    want = np.asarray(jbasic.OneBlobEncoding(n_bins, 3).apply({}, jnp.asarray(x)))
    enc = tcnn.create_encoding(3, {"otype": "OneBlob", "n_bins": n_bins}, device="cpu")
    got = enc(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (700, 3 * n_bins)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.numpy().reshape(700, 3, n_bins).sum(-1), 1.0, atol=1e-5)


def test_missing_otype_is_oneblob():
    enc = tcnn.create_encoding(2, {"n_bins": 8}, device="cpu")
    assert isinstance(enc, tcnn.OneBlobEncoding) and enc.n_output_dims == 16


_COMPOSITES = {
    "concatenation": (6, {"reduction": "Concatenation", "nested": [
        {"n_dims_to_encode": 2, "otype": "OneBlob", "n_bins": 4},
        {"otype": "OneBlob", "n_bins": 3}]}),
    "sum": (6, {"reduction": "Sum", "nested": [
        {"n_dims_to_encode": 2, "otype": "OneBlob", "n_bins": 4},
        {"otype": "OneBlob", "n_bins": 2}]}),
    "product": (6, {"reduction": "Product", "nested": [
        {"n_dims_to_encode": 2, "otype": "OneBlob", "n_bins": 4},
        {"otype": "OneBlob", "n_bins": 2}]}),
    "dims_to_encode_begin": (5, {"nested": [
        {"n_dims_to_encode": 2, "dims_to_encode_begin": 3, "otype": "OneBlob", "n_bins": 4},
        {"n_dims_to_encode": 3, "dims_to_encode_begin": 0, "otype": "OneBlob",
         "n_bins": 5}]}),
}


@pytest.mark.parametrize("case", sorted(_COMPOSITES))
def test_composite_equals_jax(case):
    n_dims, cfg = _COMPOSITES[case]
    cfg = {"otype": "Composite", **cfg}
    x = np.random.default_rng(5).uniform(0, 1, (600, n_dims)).astype(np.float32)
    jenc = jtcnn.create_encoding(n_dims, cfg)
    want = np.asarray(jenc.apply(jenc.init(jax.random.key(0)), jnp.asarray(x)))
    enc = tcnn.create_encoding(n_dims, cfg, device="cpu")
    assert enc.slices == jenc.slices and enc.n_output_dims == jenc.n_output_dims
    got = enc(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert enc.hyperparams() == jenc.hyperparams()


def test_composite_rejects_what_jax_rejects():
    two_open = {"otype": "Composite", "nested": [{"otype": "OneBlob"}, {"otype": "OneBlob"}]}
    with pytest.raises(ValueError, match="unspecified"):
        tcnn.create_encoding(4, two_open, device="cpu")
    too_many = {"otype": "Composite", "nested": [{"otype": "OneBlob", "n_dims_to_encode": 5}]}
    with pytest.raises(ValueError, match="more dims"):
        tcnn.create_encoding(4, too_many, device="cpu")
    widths = {"otype": "Composite", "reduction": "Sum", "nested": [
        {"otype": "OneBlob", "n_dims_to_encode": 1, "n_bins": 4},
        {"otype": "OneBlob", "n_bins": 3}]}
    with pytest.raises(ValueError, match="widths"):
        tcnn.create_encoding(3, widths, device="cpu")


def test_config_btf_model_structure():
    model = tcnn.create_from_config(6, 3, BTF_CONFIG, policy=tcnn.BF16_POLICY, device="cpu")
    enc = model.network.encoding
    assert isinstance(enc, tcnn.CompositeEncoding) and enc.slices == [(0, 4), (4, 2)]
    grid = enc.nested[0]
    assert grid.spec.n_params == 15474688 and grid.spec.n_entries == 7737344
    assert [(lv.size, lv.use_hash) for lv in grid.spec.levels[:3]] == [
        (65536, False), (331776, False), (524288, True)]
    assert grid.spec.hash_type == tcommon.HashType.COHERENT_ADD
    assert enc.n_output_dims == 40 and not getattr(enc, "prefers_soa", False)
    assert not model.network._use_soa
    assert {n: tuple(p.shape) for n, p in model.network.named_parameters()} == {
        "encoding.0.grid": (15474688,), "network.layers.0": (40, 64),
        "network.layers.1": (64, 64), "network.layers.2": (64, 64),
        "network.layers.3": (64, 3)}
    assert model.network.param_layout()["encoding.0.grid"] == "other"
    feats = enc(torch.rand(64, 6))
    assert feats.dtype == torch.bfloat16 and feats.shape == (64, 40)


def test_full_width_btf_inference_equals_jax():
    jmodel = jtcnn.create_from_config(6, 3, BTF_CONFIG)
    state = _jax_state(jmodel)
    model = tcnn.create_from_config(6, 3, BTF_CONFIG, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, state.params))
    x = np.random.default_rng(1).uniform(0, 1, (512, 6)).astype(np.float32)
    want = np.asarray(jmodel.trainer.inference(state, jnp.asarray(x)))
    got = model.trainer.inference(torch.from_numpy(x))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_synthetic_btf_equals_jax_sample():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "samples" / "fit_btf.py"
    spec = importlib.util.spec_from_file_location("jax_fit_btf", path)
    jsample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsample)
    x = np.random.default_rng(2).uniform(0, 1, (4096, 6)).astype(np.float32)
    want = np.asarray(jsample.synthetic_btf(jnp.asarray(x)))
    got = synthetic_btf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- (b) kernel GB's plain version against rows 11 and 12 ------------------

def _bf16_ulp(a):
    a = np.maximum(np.abs(a.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("hash_name,dtype,kernels", [
    ("COHERENT_ADD", "bfloat16", {"serial_scatter_pairs"}),
    ("COHERENT_PRIME", "float32", {"serial_scatter_pairs", "serial_scatter_weighted"}),
], ids=["row12_coherent_add", "row11_coherent_prime"])
def test_grid_encode_bwd_plain_equals_jax_serial_scatters(hash_name, dtype, kernels,
                                                           monkeypatch):
    """TCNN_TPU_DISABLE_MM=1 sends every level serial: dense and
    CoherentAdd levels through _pair_kernel, the others (CoherentPrime
    hashed levels) through _weighted_kernel, in interpret mode."""
    monkeypatch.setenv("TCNN_TPU_DISABLE_MM", "1")
    names = []
    real_pallas_call = pl.pallas_call

    def spy(*args, **kwargs):
        names.append(kwargs.get("name"))
        return real_pallas_call(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    args = (4, 4, 2, 12, 4, 1.5)
    jspec = jops.make_grid_spec(*args, hash_type=getattr(jcommon.HashType, hash_name))
    tspec = tops.make_grid_spec(*args, hash_type=getattr(tcommon.HashType, hash_name))
    B, L, F, C = 1024, 4, 2, 16
    rng = np.random.default_rng(21)
    table = rng.uniform(-1, 1, tspec.n_params).astype(np.float32)
    # Inside [0, 1]^4, as the BTF's inputs are.  Outside it a dense level
    # whose size does not divide 2^32 has dim-0 pairs that are not
    # table-adjacent across the uint32 wrap of a negative cell, and the
    # pair route then disagrees with JAX's own plain path, which the
    # port follows.
    x = rng.uniform(0, 1, (B, 4)).astype(np.float32)
    x[0] = 0.9   # cell (3, 3, 3, 3) of dense level 0: its last row, a wrapped pair
    dcols = rng.normal(size=(L * F, B)).astype(np.float32)
    dcols = np.array(jnp.asarray(dcols).astype(dtype).astype(jnp.float32))

    # lv_meta as grid_encode builds it (grid_ops.py:1257-1260): paired,
    # size, offset, XOR eligibility (off here: these levels are serial).
    meta = tuple(((not lv.use_hash) or hash_name == "COHERENT_ADD", lv.size, lv.offset,
                  False) for lv in jspec.levels)
    mm, serial = jops._route_levels((F, C, meta), jnp.dtype(dtype), B)
    assert mm == [] and serial == list(range(L))
    # The pair route's level wrap: some even corner on its level's last row.
    idx, _, _ = jops._build_indices_weights(jspec, jnp.asarray(x), list(range(L)))
    idx_e = np.asarray(idx).reshape(L, C, B)[:, 0::2, :]
    last = np.array([lv.offset + lv.size - 1 for lv in jspec.levels]).reshape(L, 1, 1)
    assert (idx_e == last).any()

    jt = jnp.asarray(table).astype(dtype)
    _, vjp = jax.vjp(lambda t: jops.grid_encode(jspec, t, jnp.asarray(x),
                                                fast_scatter=True, soa=True), jt)
    (want,) = vjp(jnp.asarray(dcols).astype(dtype))
    want = np.asarray(want, np.float32)
    assert kernels <= set(names) and "mm_scatter" not in names
    if hash_name == "COHERENT_ADD":
        assert "serial_scatter_weighted" not in names

    tdt = getattr(torch, dtype)
    tx, live = torch.from_numpy(x), list(range(L))
    got = grid_encode_bwd_plain(tspec, torch.from_numpy(table).to(tdt), tx,
                                torch.from_numpy(dcols).to(tdt), live)
    assert got.dtype == tdt and got.shape == want.shape
    scale = grid_encode_bwd_plain(tspec, torch.from_numpy(table), tx,
                                  torch.from_numpy(np.abs(dcols)), live).numpy()
    tidx, tws = tops.build_indices_weights(tspec, tx, live)
    hit = (tws.reshape(L, C, B) != 0).reshape(-1)
    n_upd = torch.bincount(tidx.reshape(-1)[hit], minlength=tspec.n_entries)
    n_upd = n_upd.repeat_interleave(F).numpy()
    tol = 2.0 * n_upd * 2.0 ** -24 * scale + 1e-30
    if dtype == "bfloat16":
        tol = tol + _bf16_ulp(want)
    err = np.abs(got.float().numpy() - want)
    assert (err <= tol).all(), (err - tol).max()
    assert np.abs(want).max() > 0.1


# -- (c) a training step of a config_btf-structured model ------------------

def test_btf_structured_fp32_training_step_equals_jax():
    _step_against_jax("DEFAULT_POLICY",
                      {"loss": 1e-5, "rel": 1e-5, "max": 1e-6, "sign": 1e-5},
                      small_btf_config(), 6)


def test_btf_structured_bf16_training_step_equals_jax_kernels(monkeypatch):
    monkeypatch.setenv("TCNN_TPU_FORCE_FAST_SCATTER", "1")
    _step_against_jax("BF16_POLICY",
                      {"loss": 2e-2, "rel": 0.0, "max": 2e-2, "sign": 2e-2},
                      small_btf_config(), 6)


def test_btf_sample_runs_on_the_cpu(capsys):
    from tcnn_tpu_torch.samples import fit_btf

    result = fit_btf.main(["fit_btf", "2", "8"], device="cpu")
    assert result["losses"].shape == (2,) and bool(torch.isfinite(result["losses"]).all())
    assert 0.5 < result["rel_zero"] < 0.8   # relL2 of a zero prediction
    assert "held-out MSE=" in capsys.readouterr().out

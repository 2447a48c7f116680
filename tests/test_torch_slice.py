"""Slice 1 end to end: config_hash inference in the port against the JAX
package, on the CPU, with the JAX parameters carried across by
``load_jax_params``.

The grid table is replaced in both packages by the same seeded
U(±1) values: a trained table holds O(1) features, and the U(±1e-4)
init would make every output too small for a tolerance to mean much.
Tolerances:
  * fp32 policy, JAX's plain path: rtol 1e-5, atol 1e-5 on O(1) outputs
    (the same float32 math, sums in another order).
  * BF16_POLICY with TCNN_TPU_FORCE_FAST_SCATTER=1, so that JAX runs
    _gather_kernel and _fwd_kernel in interpret mode: rtol 2e-2,
    atol 2e-3.  A grid feature may round to the other bf16 neighbour
    (one ulp, 2^-8 relative), and so may each hidden activation.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.utils.jax_params import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "config_hash.json")
BTF_CONFIG = str(ROOT / "configs" / "config_btf.json")


def small_btf_config():
    """config_btf's structure (4-D CoherentAdd grid and OneBlob 4 bins,
    FullyFusedMLP 64 x 3) with a 4-level grid of small tables."""
    cfg = tcnn.load_config(BTF_CONFIG)
    grid = {**cfg["encoding"]["nested"][0], "n_levels": 4, "log2_hashmap_size": 12,
            "base_resolution": 4}
    return {**cfg, "encoding": {**cfg["encoding"],
                                "nested": [grid, cfg["encoding"]["nested"][1]]}}


def flat_params(tree):
    """{dotted name: numpy array} of a JAX parameter tree, the port's
    parameter names ("encoding.0.grid", "network.layers.1")."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v) for path, v in leaves}


def _jax_model(policy):
    model = jtcnn.create_from_config(2, 3, CONFIG, policy=policy)
    state = model.trainer.initial_state()
    grid = state.params["encoding"]["grid"]
    table = np.random.default_rng(0).uniform(-1, 1, grid.shape).astype(np.float32)
    state.params["encoding"]["grid"] = jnp.asarray(table)
    return model, state


def _port_model(policy, state):
    model = tcnn.create_from_config(2, 3, CONFIG, policy=policy, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, state.params))
    return model


def _coords(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 2)).astype(np.float32)


def test_fp32_inference_equals_jax():
    jmodel, state = _jax_model(jtcnn.DEFAULT_POLICY)
    model = _port_model(tcnn.DEFAULT_POLICY, state)
    assert model.network.n_params() == jmodel.network.n_params(state.params) == 714704
    x = _coords(1024, 1)
    want = np.asarray(jmodel.trainer.inference(state, jnp.asarray(x)))
    got = model.trainer.inference(torch.from_numpy(x))
    assert got.dtype == torch.float32 and not got.requires_grad
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_inference_equals_jax_kernels_in_interpret_mode(monkeypatch):
    monkeypatch.setenv("TCNN_TPU_FORCE_FAST_SCATTER", "1")
    jmodel, state = _jax_model(jtcnn.BF16_POLICY)
    assert jmodel.network.network.use_pallas
    model = _port_model(tcnn.BF16_POLICY, state)
    x = _coords(2048, 2)
    want = np.asarray(jmodel.trainer.inference(state, jnp.asarray(x)))
    got = model.trainer.inference(torch.from_numpy(x))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-3)


def test_load_jax_params_rejects_mismatches():
    _, state = _jax_model(jtcnn.DEFAULT_POLICY)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    model = tcnn.create_from_config(2, 3, CONFIG, device="cpu")
    before = model.network.encoding.grid.detach().clone()
    bad = {"encoding": params["encoding"],
           "network": {"layers": [params["network"]["layers"][0].T,
                                  *params["network"]["layers"][1:]]}}
    with pytest.raises(ValueError, match="network.layers.0"):
        load_jax_params(model, bad)
    assert torch.equal(model.network.encoding.grid, before)  # nothing copied
    with pytest.raises(KeyError):
        load_jax_params(model, {"encoding": params["encoding"]})
    with pytest.raises(KeyError):
        load_jax_params(model, {**params, "extra": {"w": np.zeros(3)}})


def test_module_tree_mirrors_jax_params():
    model = tcnn.create_from_config(2, 3, CONFIG, device="cpu")
    assert {n: tuple(p.shape) for n, p in model.trainer.inference_params().items()} == {
        "encoding.grid": (708368,), "network.layers.0": (32, 64),
        "network.layers.1": (64, 64), "network.layers.2": (64, 3)}
    assert isinstance(model.loss, tcnn.RelativeL2Loss)
    assert isinstance(model.optimizer, tcnn.Adam)
    assert model.optimizer.hyperparams()["learning_rate"] == 1e-2
    assert model.trainer.loss is model.loss and model.trainer.optimizer is model.optimizer
    assert model.network.hyperparams()["network"]["otype"] == "FullyFusedMLP"


def test_same_seed_same_model_other_seed_other_model():
    a = tcnn.create_from_config(2, 3, CONFIG, seed=5, device="cpu")
    b = tcnn.create_from_config(2, 3, CONFIG, seed=5, device="cpu")
    c = tcnn.create_from_config(2, 3, CONFIG, seed=6, device="cpu")
    pa, pb, pc = (dict(m.network.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["network.layers.0"], pc["network.layers.0"])


def test_entry_point_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcnn.create_from_config(2, 3, CONFIG)


def test_load_jax_params_round_trips_the_composite_tree():
    """config_btf's tree: the grid under a tuple, beside OneBlob's empty
    entry ({"encoding": ({"grid": ...}, {}), ...})."""
    jmodel = jtcnn.create_from_config(6, 3, small_btf_config())
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.trainer.initial_state().params)
    assert isinstance(params["encoding"], tuple) and params["encoding"][1] == {}
    model = tcnn.create_from_config(6, 3, small_btf_config(), device="cpu")
    load_jax_params(model, params)
    got = {n: p.detach().numpy() for n, p in model.network.named_parameters()}
    want = flat_params(params)
    assert set(got) == set(want) == {"encoding.0.grid", "network.layers.0",
                                     "network.layers.1", "network.layers.2",
                                     "network.layers.3"}
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])

    before = model.network.encoding.nested[0].grid.detach().clone()
    grid = params["encoding"][0]["grid"]
    with pytest.raises(ValueError, match="encoding.0.grid"):
        load_jax_params(model, {**params, "encoding": ({"grid": grid[:-2]}, {})})
    with pytest.raises(KeyError):   # the grid outside its tuple
        load_jax_params(model, {**params, "encoding": {"grid": grid}})
    with pytest.raises(KeyError):   # an extra leaf where OneBlob has none
        load_jax_params(model, {**params, "encoding": ({"grid": grid}, {"w": grid[:4]})})
    assert torch.equal(model.network.encoding.nested[0].grid, before)


_GRID_CFG = {"otype": "HashGrid", "n_levels": 2, "log2_hashmap_size": 8}
_MLP_CFG = {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1}
_COMPOSITE_CFG = {"otype": "Composite", "nested": [
    {**_GRID_CFG, "n_dims_to_encode": 2}, {"otype": "OneBlob", "n_bins": 4}]}


@pytest.mark.parametrize("make", [
    lambda **kw: tcnn.create_encoding(2, _GRID_CFG, **kw),
    lambda **kw: tcnn.create_network(_MLP_CFG, 4, 3, **kw),
    lambda **kw: tcnn.create_network_with_input_encoding(2, 3, _GRID_CFG, _MLP_CFG, **kw),
    lambda **kw: tcnn.GridEncoding(2, n_levels=2, log2_hashmap_size=8, **kw),
    lambda **kw: tcnn.MLP(4, 3, n_neurons=16, n_hidden_layers=1, **kw),
    lambda **kw: tcnn.FusedMLP(4, 3, n_neurons=16, n_hidden_layers=1, **kw),
    lambda **kw: tcnn.create_encoding(3, _COMPOSITE_CFG, **kw),
    lambda **kw: tcnn.OneBlobEncoding(4, 2, **kw),
], ids=["create_encoding", "create_network", "create_network_with_input_encoding",
        "GridEncoding", "MLP", "FusedMLP", "Composite", "OneBlob"])
def test_every_constructor_defaults_to_cuda_and_raises_without_it(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert all(p.device.type == "cpu" for p in make(device="cpu").parameters())


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, tcnn_tpu_torch, tcnn_tpu_torch.ops.cuda.grid_encode, "
            "tcnn_tpu_torch.ops.cuda.fused_mlp, tcnn_tpu_torch.losses, "
            "tcnn_tpu_torch.optimizers, tcnn_tpu_torch.trainer, "
            "tcnn_tpu_torch.utils.image, tcnn_tpu_torch.utils.metrics, "
            "tcnn_tpu_torch.utils.jax_params, tcnn_tpu_torch.tools.kernel_ablation, "
            "tcnn_tpu_torch.models.encodings.basic, tcnn_tpu_torch.samples, "
            "tcnn_tpu_torch.samples.fit_btf, tcnn_tpu_torch.samples.fit_nerf_field, "
            "tcnn_tpu_torch.samples.mlp_learning_an_image, chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'tcnn_tpu' or m.startswith('tcnn_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)

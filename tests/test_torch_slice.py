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
    assert model.loss is None and model.optimizer is None
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


_GRID_CFG = {"otype": "HashGrid", "n_levels": 2, "log2_hashmap_size": 8}
_MLP_CFG = {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1}


@pytest.mark.parametrize("make", [
    lambda **kw: tcnn.create_encoding(2, _GRID_CFG, **kw),
    lambda **kw: tcnn.create_network(_MLP_CFG, 4, 3, **kw),
    lambda **kw: tcnn.create_network_with_input_encoding(2, 3, _GRID_CFG, _MLP_CFG, **kw),
    lambda **kw: tcnn.GridEncoding(2, n_levels=2, log2_hashmap_size=8, **kw),
    lambda **kw: tcnn.MLP(4, 3, n_neurons=16, n_hidden_layers=1, **kw),
    lambda **kw: tcnn.FusedMLP(4, 3, n_neurons=16, n_hidden_layers=1, **kw),
], ids=["create_encoding", "create_network", "create_network_with_input_encoding",
        "GridEncoding", "MLP", "FusedMLP"])
def test_every_constructor_defaults_to_cuda_and_raises_without_it(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert all(p.device.type == "cpu" for p in make(device="cpu").parameters())


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, tcnn_tpu_torch, tcnn_tpu_torch.ops.cuda.grid_encode, "
            "tcnn_tpu_torch.ops.cuda.fused_mlp\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'tcnn_tpu' or m.startswith('tcnn_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)

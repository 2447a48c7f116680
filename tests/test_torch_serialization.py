"""Trainer files across the two packages (utils/serialization.py), on the
CPU: a dict written by either package's ``serialize`` goes through JSON
text and loads in the other's ``deserialize``.

The parameters and optimizer state travel through the file only (no
``load_jax_params``): the loaded leaves must equal the written ones bit
for bit, and the loaded model's inference must equal the writer's within
the fp32 tolerance of tests/test_torch_slice.py (rtol 1e-5, atol 1e-5:
the same float32 math, sums in another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu.utils import serialization as jser
from tcnn_tpu_torch.optimizers.base import named_leaves

ADAM = {"otype": "Adam", "learning_rate": 1e-2, "beta2": 0.99, "epsilon": 1e-15}
EMA = {"otype": "EMA", "decay": 0.9, "nested": ADAM}


def _config(opt):
    return {"loss": {"otype": "RelativeL2"}, "optimizer": opt,
            "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                         "log2_hashmap_size": 10, "base_resolution": 8,
                         "per_level_scale": 1.5},
            "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 2}}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (512, 2)).astype(np.float32),
             rng.uniform(0, 1, (512, 3)).astype(np.float32)) for _ in range(n)]


def _via_json(data):
    return json.loads(json.dumps(data))


def _coords():
    return np.random.default_rng(9).uniform(0, 1, (1024, 2)).astype(np.float32)


@pytest.mark.parametrize("opt", [ADAM, EMA], ids=["Adam", "EMA_Adam"])
def test_jax_file_loads_in_the_port(opt):
    jmodel = jtcnn.create_from_config(2, 3, _config(opt))
    state = jmodel.trainer.initial_state()
    for x, t in _batches(3):
        state, _ = jmodel.trainer.training_step(state, jnp.asarray(x), jnp.asarray(t))
    data = _via_json(jser.serialize_trainer(jmodel.trainer, state))

    model = tcnn.create_from_config(2, 3, _config(opt), device="cpu")
    model.trainer.deserialize(data)
    assert model.trainer.step == 3
    for want, (path, got) in zip(jax.tree_util.tree_leaves(state.opt_state),
                                 named_leaves(model.trainer.opt_state)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)
    x = _coords()
    want = np.asarray(jmodel.trainer.inference(state, jnp.asarray(x)))
    got = model.trainer.inference(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if opt is EMA:   # the custom weights came through the file
        raw = np.asarray(jmodel.trainer.forward(state, jnp.asarray(x)))
        assert not np.allclose(want, raw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", [ADAM, EMA], ids=["Adam", "EMA_Adam"])
def test_port_file_loads_in_jax(opt):
    model = tcnn.create_from_config(2, 3, _config(opt), device="cpu")
    for x, t in _batches(3, seed=1):
        model.trainer.training_step(torch.from_numpy(x), torch.from_numpy(t))
    data = _via_json(model.trainer.serialize())
    assert data["otype"] == "Trainer" and data["params_type"] == "float"
    assert data["n_params"] == model.trainer.n_params() and data["step"] == 3

    jmodel = jtcnn.create_from_config(2, 3, _config(opt))
    state = jser.deserialize_trainer(jmodel.trainer, data)
    assert int(state.step) == 3
    jleaves = jax.tree_util.tree_leaves(state.opt_state)
    for want, (path, got) in zip(jleaves, named_leaves(model.trainer.opt_state)):
        assert np.asarray(want).dtype == (np.uint32 if not got.is_floating_point()
                                           else np.float32), path
        np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=path)
    x = _coords()
    want = model.trainer.inference(torch.from_numpy(x)).numpy()
    got = np.asarray(jmodel.trainer.inference(state, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the state goes on training in JAX
    state, loss = jmodel.trainer.training_step(state, jnp.asarray(x[:512]),
                                               jnp.zeros((512, 3)))
    assert np.isfinite(float(loss))


def test_port_round_trip_without_optimizer_and_mismatches_raise():
    model = tcnn.create_from_config(2, 3, _config(ADAM), device="cpu")
    model.trainer.training_step(torch.rand(256, 2), torch.rand(256, 3))
    data = model.trainer.serialize(serialize_optimizer=False)
    assert "optimizer" not in data
    fresh = tcnn.create_from_config(2, 3, _config(ADAM), device="cpu", seed=5)
    before = fresh.trainer.opt_state["mu"]["network.layers.0"].clone()
    fresh.trainer.deserialize(data)
    for n, p in model.trainer.params().items():
        torch.testing.assert_close(fresh.trainer.params()[n], p, rtol=0, atol=0)
    torch.testing.assert_close(fresh.trainer.opt_state["mu"]["network.layers.0"], before)
    other = tcnn.create_from_config(2, 3, _config(EMA), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        other.trainer.deserialize(model.trainer.serialize())
    bad = {**data, "params": {**data["params"], "leaves": data["params"]["leaves"][::-1]}}
    with pytest.raises(ValueError, match="shape"):
        fresh.trainer.deserialize(bad)

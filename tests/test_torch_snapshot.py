"""Snapshots in the CUDA original's format (utils/cuda_import.py,
utils/cuda_export.py, utils/msgpack.py), on the CPU, against the JAX
package and the ``msgpack`` package.

  * The port's msgpack codec writes the bytes ``msgpack.packb(obj,
    use_bin_type=True)`` writes, reads what it writes (float32 too, which
    nlohmann writes where a value is exact in it), and needs no
    ``msgpack`` package.
  * ``export_snapshot`` gives the JAX package's bytes for the same
    parameters and Adam state, in ``float`` and ``__half``.
  * tests/fixtures/ref_snapshot.json loads in both packages; inference
    agrees within the fp32 tolerance of tests/test_torch_slice.py (rtol
    1e-5, atol 1e-5), the loaded parameters and state bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import msgpack as msgpack_pkg
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu.utils import cuda_export as jexport
from tcnn_tpu.utils import cuda_import as jimport
from tcnn_tpu_torch.utils import cuda_export, cuda_import, msgpack
from tcnn_tpu_torch.utils.jax_params import load_jax_opt_state, load_jax_params

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ref_snapshot.json")

# tests/test_cuda_export.py's model, the fixture's.
CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
                 "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 2.0},
    "network": {"otype": "MLP", "n_neurons": 16, "n_hidden_layers": 2},
}


def _objects():
    rng = np.random.default_rng(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    return [
        None, True, False, 0.5, -1e-300, float("inf"), 3.0e38, *ints,
        "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
        b"", b"\x00" * 255, b"\x01" * 256, rng.bytes(70000),
        list(range(15)), list(range(16)), list(range(70000)), [[], {}, [None]],
        {f"k{i}": i for i in range(15)}, {f"k{i}": [i, str(i)] for i in range(16)},
        {f"k{i}": i for i in range(70000)},
        {"n_params": 1440, "params_type": "float", "params_binary": rng.bytes(5760),
         "optimizer": {"current_step": 3, "base_learning_rate": 0.01,
                       "first_moments_binary": rng.bytes(64)}},
    ]


@pytest.mark.parametrize("i", range(len(_objects())))
def test_msgpack_codec_equals_the_msgpack_package(i):
    obj = _objects()[i]
    packed = msgpack_pkg.packb(obj, use_bin_type=True)
    assert msgpack.packb(obj) == packed
    assert msgpack.unpackb(packed) == msgpack_pkg.unpackb(packed, raw=False,
                                                          strict_map_key=False)
    single = msgpack_pkg.packb(obj, use_bin_type=True, use_single_float=True)
    assert msgpack.unpackb(single) == msgpack_pkg.unpackb(single, raw=False,
                                                          strict_map_key=False)


def test_msgpack_codec_rejects_what_it_does_not_read():
    with pytest.raises(ValueError, match="unsupported"):
        msgpack.unpackb(msgpack_pkg.packb(msgpack_pkg.ExtType(1, b"x")))
    with pytest.raises(ValueError, match="trailing"):
        msgpack.unpackb(msgpack_pkg.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(msgpack_pkg.packb(b"abcdef")[:-1])
    with pytest.raises(TypeError):
        msgpack.packb({1, 2})


def _jax_trained(steps=3):
    jmodel = jtcnn.create_from_config(2, 3, CONFIG)
    state = jmodel.trainer.initial_state()
    rng = np.random.default_rng(1)
    for _ in range(steps):
        x = rng.uniform(0, 1, (256, 2)).astype(np.float32)
        t = rng.uniform(0, 1, (256, 3)).astype(np.float32)
        state, _ = jmodel.trainer.training_step(state, jnp.asarray(x), jnp.asarray(t))
    return jmodel, state


def _port_from(state):
    model = tcnn.create_from_config(2, 3, CONFIG, device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    load_jax_params(model, np_tree(state.params))
    load_jax_opt_state(model.trainer, np_tree(state.opt_state))
    return model


@pytest.mark.parametrize("params_type", ["float", "__half"])
def test_export_snapshot_bytes_equal_jax(params_type):
    jmodel, state = _jax_trained()
    model = _port_from(state)
    want = jexport.export_snapshot(jmodel.trainer, state, serialize_optimizer=True,
                                   params_type=params_type)
    got = cuda_export.export_snapshot(model.trainer, serialize_optimizer=True,
                                      params_type=params_type)
    assert got == want
    assert msgpack.packb(got) == msgpack_pkg.packb(want, use_bin_type=True)


def test_wrapped_adam_exports_its_moments_like_jax():
    cfg = {**CONFIG, "optimizer": {"otype": "EMA", "nested": CONFIG["optimizer"]}}
    jmodel = jtcnn.create_from_config(2, 3, cfg)
    state = jmodel.trainer.initial_state()
    state, _ = jmodel.trainer.training_step(state, jnp.full((64, 2), 0.3), jnp.ones((64, 3)))
    model = tcnn.create_from_config(2, 3, cfg, device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    load_jax_params(model, np_tree(state.params))
    load_jax_opt_state(model.trainer, np_tree(state.opt_state))
    assert (cuda_export.export_snapshot(model.trainer, serialize_optimizer=True)
            == jexport.export_snapshot(jmodel.trainer, state, serialize_optimizer=True))


def test_reference_fixture_imports_in_both_packages():
    jmodel = jtcnn.create_from_config(2, 3, CONFIG)
    jstate = jimport.import_trainer_state(jmodel.trainer, FIXTURE)
    model = tcnn.create_from_config(2, 3, CONFIG, device="cpu")
    cuda_import.import_trainer_state(model.trainer, FIXTURE)
    assert int(model.trainer.opt_state["step"]) == int(jstate.opt_state["step"]) == 3
    for key in ("mu", "nu", "param_steps"):
        want = jax.tree_util.tree_leaves(jstate.opt_state[key])
        got = [model.trainer.opt_state[key][n] for n in
               ("encoding.grid", "network.layers.0", "network.layers.1", "network.layers.2")]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = np.random.default_rng(2).uniform(0, 1, (1024, 2)).astype(np.float32)
    want = np.asarray(jmodel.trainer.inference(jstate, jnp.asarray(x)))
    got = model.trainer.inference(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["msgpack", "json"])
def test_snapshot_files_round_trip_without_the_msgpack_package(form, tmp_path, monkeypatch):
    jmodel, state = _jax_trained()
    model = _port_from(state)
    data = cuda_export.export_snapshot(model.trainer, serialize_optimizer=True)
    path = tmp_path / f"snap.{form}"
    monkeypatch.setitem(sys.modules, "msgpack", None)   # import msgpack raises
    cuda_export.save_snapshot(path, data, form=form)
    fresh = tcnn.create_from_config(2, 3, CONFIG, device="cpu", seed=4)
    cuda_import.import_trainer_state(fresh.trainer, str(path))
    for n, p in model.trainer.params().items():
        torch.testing.assert_close(fresh.trainer.params()[n], p, rtol=0, atol=0)
    for key in ("mu", "nu", "param_steps"):
        for n, t in model.trainer.opt_state[key].items():
            torch.testing.assert_close(fresh.trainer.opt_state[key][n], t, rtol=0, atol=0)
    assert int(fresh.trainer.opt_state["step"]) == 3
    monkeypatch.undo()
    if form == "msgpack":   # what the JAX package reads with the msgpack package
        jfresh = jimport.import_trainer_state(jmodel.trainer, str(path))
        for a, b in zip(jax.tree_util.tree_leaves(jfresh.params),
                        jax.tree_util.tree_leaves(state.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_float32_values_and_half_params_import():
    """nlohmann writes a float exact in float32 as float32; a __half
    snapshot imports within half precision."""
    jmodel, state = _jax_trained()
    model = _port_from(state)
    data = cuda_export.export_snapshot(model.trainer, params_type="__half")
    data["optimizer"] = {"base_learning_rate": 0.5}
    raw = msgpack_pkg.packb(data, use_bin_type=True, use_single_float=True)
    fresh = tcnn.create_from_config(2, 3, CONFIG, device="cpu", seed=4)
    cuda_import.import_params(fresh.network, raw)
    for n, p in model.trainer.params().items():
        torch.testing.assert_close(fresh.trainer.params()[n], p, rtol=1e-3, atol=1e-4)


def test_import_rejects_padding_weights_and_warns_on_coherent_add():
    jmodel, state = _jax_trained()
    model = _port_from(state)
    data = cuda_export.export_snapshot(model.trainer)
    flat = np.frombuffer(data["params_binary"], "<f4").copy()
    flat[10] = 1.0   # layer 0 row 0, input column 10 of 16; the grid gives 6
    with pytest.raises(ValueError, match="padded"):
        cuda_import.import_params(model.network, {**data, "params_binary": flat.tobytes()})
    with pytest.raises(ValueError, match="n_params"):
        cuda_import.import_params(model.network, {**data, "n_params": 3})
    cfg = {**CONFIG, "encoding": {**CONFIG["encoding"], "n_levels": 6, "hash": "CoherentAdd"}}
    other = tcnn.create_from_config(2, 3, cfg, device="cpu")
    with pytest.warns(UserWarning, match="CoherentAdd"):
        cuda_import.import_params(other.network, cuda_export.export_snapshot(other.trainer))

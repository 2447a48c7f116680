"""Serving bundles and exported training steps of the port
(tcnn_tpu_torch/serving.py), on the CPU: the cases of
tests/test_serving.py with ``device="cpu"``, and the whole slice against
the JAX package.

Tolerances: a served request against ``Trainer.inference`` on the same
rows, rtol 1e-5, atol 1e-6, as tests/test_serving.py (a padded request
is a larger matrix product, whose CPU kernel may sum in another order);
on the card it is bit for bit (tests/test_torch_cuda.py).  An exported
training step against ``Trainer.training_step`` from the same state:
equal, the same CPU operations on the same values.  The whole slice
against JAX: the fp32 tolerance of tests/test_torch_slice.py, rtol 1e-5,
atol 1e-5.
"""

import io
import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu.utils import serialization as jser
from tcnn_tpu_torch import serving

ADAM = {"otype": "Adam", "learning_rate": 1e-2}


def _config(optimizer=None, network="MLP"):
    return {
        "loss": {"otype": "RelativeL2"},
        "optimizer": optimizer or ADAM,
        "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                     "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5},
        "network": {"otype": network, "n_neurons": 32, "n_hidden_layers": 2},
    }


def _trained(optimizer=None, steps=3, config=None):
    model = tcnn.create_from_config(2, 3, config or _config(optimizer), device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        model.trainer.training_step(torch.rand(512, 2, generator=g),
                                    torch.rand(512, 3, generator=g))
    return model


def _x(b, seed):
    return torch.rand(b, 2, generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_roundtrip_parity_and_bucketing(tmp_path):
    model = _trained()
    path = tmp_path / "model.tcnnz"
    serving.export_inference(model.trainer, str(path), batch_sizes=(1024, 256))
    srv = serving.load_inference(str(path), device="cpu")
    assert srv.batch_sizes == [256, 1024] and srv.platforms == ("cpu",)
    assert (srv.n_input_dims, srv.n_output_dims) == (2, 3)
    for b in (1, 100, 256, 700, 1024):
        x = _x(b, b)
        y = srv(x)
        assert y.shape == (b, 3) and y.dtype == torch.float32
        _close(y, model.trainer.inference(x))
    _close(srv(_x(50, 1).numpy()), model.trainer.inference(_x(50, 1)))   # numpy in


def test_bytes_roundtrip_no_file_and_meta():
    model = _trained(steps=1)
    data = serving.export_inference(model.trainer, batch_sizes=(256,))
    assert isinstance(data, bytes)
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        meta = json.loads(z.read("meta.json"))
    for key in ("format_version", "n_input_dims", "n_output_dims", "input_dtype",
                "batch_sizes", "platforms", "hyperparams"):   # the JAX bundle's keys
        assert key in meta
    assert meta["policy"] == {"param_dtype": "float32", "compute_dtype": "float32",
                              "output_dtype": "float32"}
    srv = serving.load_inference(data, device="cpu")
    _close(srv(_x(256, 1)), model.trainer.inference(_x(256, 1)))


def test_oversized_batch_and_wrong_width_raise():
    srv = serving.load_inference(serving.export_inference(
        _trained(steps=1).trainer, batch_sizes=(256,)), device="cpu")
    with pytest.raises(ValueError, match="largest exported bucket"):
        srv(torch.zeros((300, 2)))
    with pytest.raises(ValueError, match="expected"):
        srv(torch.zeros((256, 5)))


def test_custom_weights_baked():
    """EMA's custom weights (trainer.h:329-333) are what the bundle
    serves, not the raw parameters."""
    model = _trained({"otype": "EMA", "decay": 0.5, "nested": ADAM}, steps=4)
    srv = serving.load_inference(serving.export_inference(
        model.trainer, batch_sizes=(256,)), device="cpu")
    x = _x(256, 2)
    y_ema, y_raw = model.trainer.inference(x), model.trainer.forward(x)
    _close(srv(x), y_ema)
    assert not np.allclose(y_ema.numpy(), y_raw.numpy(), rtol=1e-5, atol=1e-6)


def test_default_buckets():
    assert serving.default_buckets(1 << 18, 1 << 14) == (
        1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18)
    assert serving.default_buckets(300, 256) == (256, 512)
    for bad, what in (((1024, 0), "min_batch"), ((1024, -2), "min_batch"),
                      ((0,), "max_batch")):
        with pytest.raises(ValueError, match=what):
            serving.default_buckets(*bad)


def _rewrite(blob, drop=(), meta_update=None):
    out = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as zin, zipfile.ZipFile(out, "w") as zout:
        for name in zin.namelist():
            if name in drop:
                continue
            data = zin.read(name)
            if name == "meta.json" and meta_update:
                data = json.dumps({**json.loads(data), **meta_update}).encode()
            zout.writestr(name, data)
    return out.getvalue()


def test_truncated_bundle_and_unknown_format_rejected_at_load():
    blob = serving.export_inference(_trained(steps=0).trainer, batch_sizes=(64, 256))
    with pytest.raises(ValueError, match="missing artifacts"):
        serving.load_inference(_rewrite(blob, drop=("batch_256.json",)), device="cpu")
    with pytest.raises(ValueError, match="unsupported bundle format"):
        serving.load_inference(_rewrite(blob, meta_update={"format_version": 2}),
                               device="cpu")
    with pytest.raises(ValueError, match="parameters"):
        serving.load_inference(_rewrite(blob, drop=("params/encoding.grid.npy",)),
                               device="cpu")


def test_composite_model_rebuilds_from_its_bundle():
    cfg = {**_config(), "encoding": {"otype": "Composite", "nested": [
        {"otype": "OneBlob", "n_bins": 4, "n_dims_to_encode": 1},
        {"otype": "HashGrid", "n_levels": 2, "log2_hashmap_size": 8, "n_dims_to_encode": 2},
        {"otype": "Identity"}]}}
    model = tcnn.create_from_config(4, 3, cfg, device="cpu")
    srv = serving.load_inference(serving.export_inference(model.trainer, batch_sizes=(64,)),
                                 device="cpu")
    x = torch.rand(64, 4, generator=torch.Generator().manual_seed(3))
    _close(srv(x), model.trainer.inference(x))


class TestTrainStepExport:
    def test_export_load_matches_live_step(self, tmp_path):
        model = _trained(config=_config(network="FullyFusedMLP"), steps=1)
        tr = model.trainer
        p = str(tmp_path / "train_step.json")
        serving.export_train_step(tr, 512, p)
        step = serving.load_train_step(p, device="cpu")
        state = tr.serialize()
        x, t = _x(512, 4), torch.rand(512, 3, generator=torch.Generator().manual_seed(5))
        s_aot, l_aot = step(state, x, t)
        l_live = tr.training_step(x, t)
        torch.testing.assert_close(l_aot, l_live, rtol=0, atol=0)
        assert s_aot["step"] == tr.step == 2
        fresh = tcnn.create_from_config(2, 3, _config(network="FullyFusedMLP"), device="cpu")
        fresh.trainer.deserialize(s_aot)
        for n, p_ in tr.params().items():
            torch.testing.assert_close(fresh.trainer.params()[n], p_, rtol=0, atol=0)
        with pytest.raises(ValueError, match="expected"):
            step(state, x[:256], t[:256])

    def test_multi_step_training_progresses(self):
        model = tcnn.create_from_config(2, 3, _config(network="FullyFusedMLP"), device="cpu")
        step = serving.load_train_step(serving.export_train_step(model.trainer, 512),
                                       device="cpu")
        state = model.trainer.serialize()
        x, t = _x(512, 1), torch.rand(512, 3, generator=torch.Generator().manual_seed(2))
        losses = []
        for _ in range(20):
            state, loss = step(state, x, t)
            losses.append(float(loss))
        assert losses[-1] < 0.3 * losses[0]

    def test_rejects_another_artifact(self):
        bundle = serving.export_inference(_trained(steps=0).trainer, batch_sizes=(64,))
        with pytest.raises(ValueError):
            serving.load_train_step(bundle, device="cpu")
        with pytest.raises(ValueError, match="train-step"):
            serving.load_train_step(json.dumps({"kind": "x"}).encode(), device="cpu")


def test_whole_slice_jax_trains_port_serves():
    """JAX trains EMA(Adam) 3 steps and serializes; the port deserializes,
    exports a bundle, loads it and serves what JAX's inference gives."""
    cfg = _config({"otype": "EMA", "decay": 0.9, "nested": ADAM}, network="FullyFusedMLP")
    jmodel = jtcnn.create_from_config(2, 3, cfg)
    state = jmodel.trainer.initial_state()
    rng = np.random.default_rng(0)
    for _ in range(3):
        state, _ = jmodel.trainer.training_step(
            state, jnp.asarray(rng.uniform(0, 1, (512, 2)).astype(np.float32)),
            jnp.asarray(rng.uniform(0, 1, (512, 3)).astype(np.float32)))
    data = json.loads(json.dumps(jser.serialize_trainer(jmodel.trainer, state)))

    model = tcnn.create_from_config(2, 3, cfg, device="cpu")
    model.trainer.deserialize(data)
    srv = serving.load_inference(serving.export_inference(
        model.trainer, batch_sizes=serving.default_buckets(2048, 256)), device="cpu")
    x = rng.uniform(0, 1, (1500, 2)).astype(np.float32)
    want = np.asarray(jmodel.trainer.inference(state, jnp.asarray(x)))
    np.testing.assert_allclose(srv(x).numpy(), want, rtol=1e-5, atol=1e-5)


ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    """A grep of every source of the port and of chip_smoke.py, and the
    modules of this slice imported in a fresh process."""
    import re
    import subprocess
    import sys

    bad = re.compile(r"^\s*(import|from)\s+(jax|tcnn_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "tcnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        assert not bad.search(f.read_text()), f
    code = ("import sys, tcnn_tpu_torch.serving, tcnn_tpu_torch.utils.checkpoint, "
            "tcnn_tpu_torch.utils.cuda_import, tcnn_tpu_torch.utils.cuda_export, "
            "tcnn_tpu_torch.utils.serialization, tcnn_tpu_torch.optimizers.shampoo\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tcnn_tpu', 'msgpack')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)


def test_loaders_default_to_cuda_and_raise_without_it(monkeypatch):
    model = _trained(steps=0)
    bundle = serving.export_inference(model.trainer, batch_sizes=(64,))
    step = serving.export_train_step(model.trainer, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load, blob in ((serving.load_inference, bundle), (serving.load_train_step, step)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(blob)

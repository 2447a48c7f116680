"""Checkpoints of the port (utils/checkpoint.py), on the CPU: the cases of
tests/test_checkpoint.py.  A restored trainer holds the saved
parameters, optimizer state and step bit for bit, and its next step
equals the saved trainer's next step bit for bit (the same CPU
operations on the same values)."""

import json

import pytest
import torch

import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.optimizers.base import named_leaves
from tcnn_tpu_torch.utils import checkpoint as ckpt


def _config(opt=None):
    return {
        "loss": {"otype": "L2"},
        "optimizer": opt or {"otype": "EMA", "decay": 0.9,
                             "nested": {"otype": "Adam", "learning_rate": 1e-2}},
        "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                     "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5},
        "network": {"otype": "MLP", "n_neurons": 32, "n_hidden_layers": 2},
    }


def _trainer(seed=1337, opt=None):
    return tcnn.create_from_config(2, 3, _config(opt), device="cpu", seed=seed).trainer


def _batch(i):
    g = torch.Generator().manual_seed(i)
    return torch.rand(512, 2, generator=g), torch.rand(512, 3, generator=g)


def _assert_same(a, b):
    assert a.step == b.step
    for (n, x), (m, y) in zip(named_leaves(a.params()), named_leaves(b.params())):
        assert n == m
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for (n, x), (m, y) in zip(named_leaves(a.opt_state), named_leaves(b.opt_state)):
        assert n == m
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_roundtrip_and_the_next_step(tmp_path):
    tr = _trainer()
    for i in range(2):
        tr.training_step(*_batch(i))
    ckpt.save_checkpoint(tmp_path / "ck", tr)
    back = ckpt.restore_checkpoint(tmp_path / "ck", like=_trainer(seed=7))
    _assert_same(tr, back)
    x, t = _batch(9)
    torch.testing.assert_close(back.training_step(x, t), tr.training_step(x, t),
                               rtol=0, atol=0)
    _assert_same(tr, back)
    with pytest.raises(FileExistsError):
        ckpt.save_checkpoint(tmp_path / "ck", tr, force=False)


def test_restore_refuses_another_configuration(tmp_path):
    tr = _trainer()
    ckpt.save_checkpoint(tmp_path / "ck", tr)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(tmp_path / "ck", like=_trainer(opt={"otype": "Adam"}))


def test_manager_interval_retention_and_restore(tmp_path):
    tr = _trainer()
    mgr = ckpt.make_manager(tmp_path / "run", max_to_keep=2, save_interval_steps=2)
    saved = []
    for i in range(5):
        tr.training_step(*_batch(i))
        if ckpt.save_step(mgr, tr):
            saved.append(tr.step)
    assert saved == [2, 4]
    assert mgr.latest_step() == 4 and mgr.all_steps() == [2, 4]
    assert not ckpt.save_step(mgr, tr, step=4)    # not past the newest
    tr.training_step(*_batch(5))
    assert ckpt.save_step(mgr, tr) and mgr.all_steps() == [4, 6]   # 2 dropped
    back = ckpt.restore_latest(mgr, like=_trainer(seed=3))
    _assert_same(tr, back)


def test_restore_latest_empty(tmp_path):
    mgr = ckpt.make_manager(tmp_path / "empty")
    assert ckpt.restore_latest(mgr, like=_trainer()) is None


def test_layout_tag_records_and_refuses_all_but_the_canonical_layout(tmp_path):
    d = tmp_path / "tagged"
    ckpt.check_layout_tag(d, {"n_model": 1})      # records
    ckpt.check_layout_tag(d, {"n_model": 1})      # the same: accepted
    assert json.loads((d / "table_layout.json").read_text()) == {"n_model": 1}
    with pytest.raises(ValueError, match="permuted grid tables"):
        ckpt.check_layout_tag(d, {"n_model": 2})   # another layout than the recorded one
    sharded = tmp_path / "sharded"
    ckpt.check_layout_tag(sharded, {"n_model": 2})          # a sharded layout records
    assert json.loads((sharded / "table_layout.json").read_text()) == {"n_model": 2}
    with pytest.raises(ValueError, match="permuted grid tables"):
        ckpt.check_layout_tag(sharded, {"n_model": 4})
    other = tmp_path / "other"
    other.mkdir()
    (other / "table_layout.json").write_text(json.dumps({"n_model": 4}))
    with pytest.raises(ValueError, match="permuted grid tables"):
        ckpt.check_layout_tag(other, {"n_model": 1})

"""The compiled requests (``Trainer.inference``, ``forward``,
``evaluate_loss``), the parallel layers' compiled steps and requests, and
``invalidate_jit_cache``, on the CPU.

On the CPU every compiled entry point runs eagerly (the card replays CUDA
graphs: ``tests/test_torch_cuda.py``, ``chip_smoke.py``).  So:
  * the requests are held against JAX's jitted ``inference``, ``forward``
    and ``evaluate_loss`` (``tcnn_tpu/trainer.py:287-303``) on a small
    config_hash-structured model at the fp32 policy, with Adam and with
    EMA(Adam) after two JAX steps (JAX's state carried across by
    ``load_jax_params`` and ``load_jax_opt_state``): rtol 1e-5, atol 1e-5
    on O(1) outputs (the same float32 math, sums in another order;
    ``tests/test_torch_slice.py``'s fp32 bound), the loss rtol 1e-5;
  * the capture logic runs with a CPU stand-in of the capture helper,
    whose graph's replay reruns the body over the static inputs: which
    calls capture and which replay, the graph keys, the capture mode, the
    shared memory pool, the kind of tensor each call returns and that it
    is never the graph's own buffer, bit for bit against the eager
    module.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch import trainer as ttrainer
from tcnn_tpu_torch.ops import grid_ops
from tcnn_tpu_torch.parallel import DataParallel, HybridParallel
from tcnn_tpu_torch.parallel.table_parallel import HybridMesh
from tcnn_tpu_torch.utils.jax_params import load_jax_opt_state, load_jax_params

from test_torch_compiled_step import small_hash_config


def ema_config():
    cfg = small_hash_config()
    return {**cfg, "optimizer": {"otype": "EMA", "decay": 0.9, "nested": cfg["optimizer"]}}


def _coords(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 2)).astype(np.float32)


def _model(cfg=None):
    return tcnn.create_from_config(2, 3, cfg or small_hash_config(), device="cpu")


# -- (i) the requests against JAX's jitted ones ---------------------------

@pytest.mark.parametrize("optimizer", ["Adam", "EMA"])
def test_inference_forward_and_evaluate_loss_equal_jax(optimizer):
    cfg = ema_config() if optimizer == "EMA" else small_hash_config()
    jmodel = jtcnn.create_from_config(2, 3, cfg)
    state = jmodel.trainer.initial_state()
    table = np.random.default_rng(0).uniform(-1, 1, state.params["encoding"]["grid"].shape)
    state.params["encoding"]["grid"] = jnp.asarray(table.astype(np.float32))
    jstep = jmodel.trainer.make_training_step()
    for seed in (1, 2):
        state, _ = jstep(state, jnp.asarray(_coords(512, seed)),
                         jnp.asarray(_coords(512, seed + 10)[:, [0, 1, 0]]))
    model = _model(cfg)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, state.params))
    load_jax_opt_state(model.trainer, jax.tree_util.tree_map(np.asarray, state.opt_state))
    x, target = _coords(1024, 5), _coords(1024, 6)[:, [1, 0, 1]]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    got = model.trainer.inference(tx)
    want = np.asarray(jmodel.trainer.inference(state, jx))
    assert got.is_inference() and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    got_f = model.trainer.forward(tx)
    want_f = np.asarray(jmodel.trainer.forward(state, jx))
    assert not got_f.is_inference() and not got_f.requires_grad
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=1e-5, atol=1e-5)
    # EMA: the custom weights, not the trained ones, answer requests
    assert (optimizer == "EMA") == (np.abs(want - want_f).max() > 1e-3)

    got_l = model.trainer.evaluate_loss(tx, torch.from_numpy(target))
    want_l = jmodel.trainer.evaluate_loss(state, jx, jnp.asarray(target))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)


# -- (ii) the capture logic, with a CPU stand-in of the capture helper -----

class CaptureStandIn:
    """``trainer._capture_step`` on the CPU: the warm-up runs the body
    over static copies of the inputs, the "capture" runs nothing (its
    output buffers start as copies of the warm-up's), and the graph's
    replay reruns the body into them.  Records each capture's mode,
    generators and pool."""

    def __init__(self):
        self.calls = []

    def __call__(self, body, inputs, capture_error_mode="global", generators=(), pool=None):
        self.calls.append({"mode": capture_error_mode, "generators": tuple(generators),
                           "pool": pool})
        with torch.inference_mode(False):
            static = tuple(t.clone() for t in inputs)
        warm = ttrainer._as_tuple(body(*static))
        outputs = tuple(o.clone() for o in warm)   # a capture runs nothing

        def replay():
            for out, new in zip(outputs, ttrainer._as_tuple(body(*static))):
                out.copy_(new)

        return ttrainer._CapturedStep(types.SimpleNamespace(replay=replay), static,
                                      outputs), warm


POOL = object()


@pytest.fixture
def captured(monkeypatch):
    stand_in = CaptureStandIn()
    monkeypatch.setattr(ttrainer, "_captures", lambda device: True)
    monkeypatch.setattr(ttrainer, "_capture_step", stand_in)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: POOL)
    return stand_in


def test_requests_capture_once_per_shape_and_return_fresh_tensors(captured):
    model = _model()
    trainer = model.trainer
    xa, xb = torch.from_numpy(_coords(256, 1)), torch.from_numpy(_coords(100, 2))

    def eager():
        with torch.inference_mode():
            return model.network.inference(xa)

    ya = [trainer.inference(xa) for _ in range(3)]   # a capture, then replays
    yb = trainer.inference(xb)
    fa = [trainer.forward(xa) for _ in range(2)]
    dev = xa.device
    key_a = ("inference", None, dev, (256, 2), torch.float32)
    assert set(trainer._graphs) == {key_a, ("inference", None, dev, (100, 2), torch.float32),
                                    ("forward", None, dev, (256, 2), torch.float32)}
    assert len(captured.calls) == 3
    assert all(c == {"mode": "global", "generators": (), "pool": POOL} for c in captured.calls)
    want = eager()
    for y in ya + [yb]:
        assert y.is_inference()
    for y in ya:
        assert torch.equal(y, want)
    with torch.no_grad():
        assert torch.equal(yb, model.network(xb))
    for f in fa:
        assert not f.is_inference() and not f.requires_grad and torch.equal(f, want)
    outputs = {o.data_ptr() for c in trainer._graphs.values() for o in c.outputs}
    assert len({y.data_ptr() for y in ya + [yb] + fa} | outputs) == len(ya) + 1 + len(fa) \
        + len(outputs)

    # eager training between requests shows in the next replay
    x, t = torch.from_numpy(_coords(512, 3)), torch.from_numpy(_coords(512, 4)[:, [0, 1, 0]])
    trainer.training_step(x, t)
    again = trainer.inference(xa)
    assert len(captured.calls) == 3 and not torch.equal(again, want)
    assert torch.equal(again, eager())
    # a request made inside inference_mode fills the same buffers as one made outside it
    with torch.inference_mode():
        assert torch.equal(trainer.forward(xa), again)
    assert torch.equal(trainer.forward(xa), again)

    trainer.invalidate_jit_cache()
    assert not trainer._graphs and trainer._request_pool is None


def test_a_request_inside_another_capture_runs_its_body(captured, monkeypatch):
    """Where the current stream is capturing already, the body runs
    itself, so that the outer capture records it: nothing is captured
    or replayed."""
    model = _model()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    x = torch.from_numpy(_coords(64, 1))
    y = model.trainer.inference(x)
    assert not captured.calls and not model.trainer._graphs
    with torch.inference_mode():
        assert torch.equal(y, model.network.inference(x))


def test_a_sharded_request_has_a_graph_of_its_own(captured):
    """The route, the tables' sharding, is part of the key: a graph
    captured unsharded is never replayed sharded.  Under a sharding the
    graph is captured in the collectives' capture mode."""
    model = _model()
    x = torch.from_numpy(_coords(64, 1))
    model.trainer.inference(x)
    with grid_ops.sharded_tables(None, 1):
        model.trainer.inference(x)
        model.trainer.inference(x)
    keys = sorted(model.trainer._graphs, key=lambda k: k[1] is not None)
    assert [k[1] for k in keys] == [None, grid_ops.TableSharding(None, 1)]
    assert [c["mode"] for c in captured.calls] == ["global", "thread_local"]


def _layer(kind, model):
    if kind == "data":
        return DataParallel()
    return HybridParallel(HybridMesh(1, 1, 0, 0, None, None, None), model=model)


@pytest.mark.parametrize("kind", ["data", "hybrid"])
def test_layer_step_graph_key_differs_from_trainer_step_key(captured, kind):
    """One trainer stepped through ``Trainer.make_training_step`` and a
    layer's ``make_training_step``: two graphs, the layer's keyed by the
    layer and captured in the collectives' mode with the rank's noise
    generator, so neither call replays the other's graph; each call
    counts one step.  The layer's ``make_inference`` keeps a graph of its
    own too."""
    model = _model()
    trainer = model.trainer
    trainer.perturbation_sigma = 0.1
    layer = _layer(kind, model)
    own, par = trainer.make_training_step(), layer.make_training_step(trainer)
    x, t = torch.from_numpy(_coords(512, 1)), torch.from_numpy(_coords(512, 2)[:, [0, 1, 0]])
    for _ in range(2):
        own(x, t)
        par(x, t)
    shapes = (((512, 2), torch.float32), ((512, 3), torch.float32))
    own_key = ("make_training_step", x.device) + shapes
    par_key = ("make_training_step", layer, x.device) + shapes
    assert set(trainer._graphs) == {own_key, par_key} and own_key != par_key
    assert [c["mode"] for c in captured.calls] == ["global", "thread_local"]
    gen = trainer._noise_generator(x.device)
    assert [c["generators"] for c in captured.calls] == [(gen,), (gen,)]
    assert trainer.step == 4

    y = layer.make_inference(trainer)(x)
    assert ("make_inference", layer, x.device, (512, 2), torch.float32) in trainer._graphs
    assert y.is_inference() and captured.calls[-1]["mode"] == "thread_local"
    assert torch.equal(y, trainer.inference(x))


@pytest.mark.parametrize("kind", ["data", "hybrid"])
def test_layer_step_on_the_cpu_equals_step_shard_map_steps(kind):
    """On the CPU a layer's compiled step is its ``step_shard_map`` step,
    counted: the same losses and parameters, bit for bit, with no graph."""
    a, b = _model(), _model()
    step = _layer(kind, a).make_training_step(a.trainer)
    body = _layer(kind, b).step_shard_map(b.trainer)
    for seed in (1, 2, 3):
        x = torch.from_numpy(_coords(256, seed))
        t = torch.from_numpy(_coords(256, seed + 5)[:, [0, 1, 0]])
        assert torch.equal(step(x, t), body(x, t))
    assert a.trainer.step == 3 and b.trainer.step == 0 and not a.trainer._graphs
    for name, p in a.trainer.params().items():
        assert torch.equal(p, b.trainer.params()[name]), name


def test_invalidate_jit_cache_drops_the_graphs_and_who_calls_it(monkeypatch):
    """``invalidate_jit_cache`` empties ``_graphs`` and drops the requests'
    pool; ``update_hyperparams`` and ``HybridParallel.shard_state`` call
    it (the launcher calls it at exit)."""
    model = _model()
    trainer = model.trainer
    calls = []
    invalidate = trainer.invalidate_jit_cache
    monkeypatch.setattr(trainer, "invalidate_jit_cache",
                        lambda: (calls.append(len(trainer._graphs)), invalidate()))
    for who in ("update_hyperparams", "shard_state"):
        trainer._graphs[(who,)] = object()
        trainer._request_pool = POOL
        if who == "update_hyperparams":
            trainer.update_hyperparams({"optimizer": {"learning_rate": 1e-3}})
        else:
            _layer("hybrid", model).shard_state(trainer)
        assert calls[-1] == 1, who
        assert not trainer._graphs and trainer._request_pool is None, who
    assert len(calls) == 2

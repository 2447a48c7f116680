"""The compiled single step (``Trainer.make_training_step``, ``step_fn``),
``serving.TrainStep`` on it, and the NeRF step made capturable, on the CPU.

On the CPU the compiled step runs its steps eagerly (the card replays a
CUDA graph: ``tests/test_torch_cuda.py``).  Inputs come from numpy with a
seed; ``load_jax_params`` carries the JAX weights across.  Tolerances:
  * ``make_training_step`` against JAX's, three steps of a small
    config_hash-structured model (HashGrid, FullyFusedMLP, RelativeL2,
    Adam) at the fp32 policy, with and without a pdf: each step's loss
    rtol 1e-5, the parameters after each step rtol 1e-5 (atol 1e-7, a
    float32 ulp of the O(1) operands where an update cancels the
    parameter) where that step's JAX gradient is beyond 1e-5 of its leaf's
    largest magnitude, as ``tests/test_torch_train.py``'s fp32 step tests
    (Adam moves an entry by about ±lr whatever its gradient's size, so a
    gradient within rounding of 0 may take either sign); the port takes
    JAX's state before each step;
  * ``step_fn`` against ``training_step``, and ``TrainStep`` against the
    one-entry ``training_loop`` it ran before: bit for bit (the same
    operations);
  * the NeRF transmittance (``fit_nerf_field.Transmittance``) against
    ``torch.cumprod`` and its autograd: bit for bit, forward and gradient
    (the same formula where no factor is 0, which none is), with alpha at
    and near 1 and running products that underflow;
  * the same against JAX's ``jnp.cumprod`` and its gradient: the forward
    within 48 · 2^-24 relative (one rounding per factor of 48 in another
    order; subnormal products within 2^-126), each gradient entry within
    48 · 2^-24 of S_k = Σ_{j>=k} |g_j| · out_j / f_k, the magnitudes of its
    terms (JAX multiplies the other factors, the port divides by f_k),
    plus 2^-126 / 1e-10 · max|g| where a product underflows (the class's
    docstring);
  * the NeRF step with the level fractions as a buffer against today's
    ``loss_and_grads`` with a float fraction, at 0.5 and 1.0, and against
    the JAX sample's loss: the loss rtol 1e-5, every gradient within 1e-4
    of its largest magnitude, as
    ``tests/test_torch_nerf.py::test_render_loss_and_gradients_equal_jax``.
"""

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch import serving
from tcnn_tpu_torch.samples import fit_nerf_field as tnf
from tcnn_tpu_torch.utils.jax_params import load_jax_opt_state, load_jax_params

from test_torch_slice import flat_params

SAMPLES = os.path.join(os.path.dirname(__file__), "..", "samples")


def small_hash_config():
    """config_hash's structure at a small size (tests/test_trainer.py's
    small config with a FullyFusedMLP)."""
    return {
        "loss": {"otype": "RelativeL2"},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2,
                      "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
        "encoding": {"otype": "HashGrid", "n_levels": 8,
                     "n_features_per_level": 2, "log2_hashmap_size": 12,
                     "base_resolution": 8, "per_level_scale": 1.5},
        "network": {"otype": "FullyFusedMLP", "n_neurons": 32,
                    "n_hidden_layers": 2, "activation": "ReLU",
                    "output_activation": "None"},
    }


def _batches(n, batch=1024, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (batch, 2)).astype(np.float32),
             rng.uniform(0, 1, (batch, 3)).astype(np.float32),
             rng.uniform(0.5, 2, (batch, 3)).astype(np.float32)) for _ in range(n)]


def _models(n=1):
    return [tcnn.create_from_config(2, 3, small_hash_config(), device="cpu") for _ in range(n)]


# -- (i) make_training_step against JAX's --------------------------------

def _jax_state(model):
    """The model's initial state with its grid table redrawn U(±1) from
    seed 0, a trained table's scale (``tests/test_torch_train.py``)."""
    state = model.trainer.initial_state()
    table = np.random.default_rng(0).uniform(-1, 1, state.params["encoding"]["grid"].shape)
    state.params["encoding"]["grid"] = jnp.asarray(table.astype(np.float32))
    return state


@pytest.mark.parametrize("with_pdf", [False, True], ids=["no-pdf", "pdf"])
def test_make_training_step_equals_jax(with_pdf):
    """Three calls of one compiled step on each side.  Before each call
    the port takes JAX's state (parameters and Adam's moments and
    counters, in place, as ``TrainStep`` loads a state), so that each
    step is held to the one-step tolerances and no step's rounding is
    carried into the next through Adam's moments."""
    jmodel = jtcnn.create_from_config(2, 3, small_hash_config())
    state = _jax_state(jmodel)
    (model,) = _models()
    jstep = jmodel.trainer.make_training_step(with_pdf=with_pdf)
    step = model.trainer.make_training_step(with_pdf=with_pdf)
    for x, t, pdf in _batches(3):
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, state.params))
        load_jax_opt_state(model.trainer, jax.tree_util.tree_map(np.asarray, state.opt_state))
        batch = (x, t) + ((pdf,) if with_pdf else ())
        jbatch = tuple(jnp.asarray(a) for a in batch)
        _, jgrads = jmodel.trainer.loss_value_and_grads(state.params, *jbatch)
        state, want = jstep(state, *jbatch)
        got = step(*(torch.from_numpy(a) for a in batch))
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        params = model.trainer.params()
        for name, want_p in flat_params(state.params).items():
            g = flat_params(jgrads)[name]
            sure = np.abs(g) > 1e-5 * np.abs(g).max()
            assert sure.sum() >= 1000 or sure.mean() > 0.5, name
            np.testing.assert_allclose(params[name].detach().numpy()[sure], want_p[sure],
                                       rtol=1e-5, atol=1e-7, err_msg=name)
    assert model.trainer.step == int(state.step) == 3


def test_make_training_step_pdf_arity():
    (model,) = _models()
    x, t, pdf = (torch.from_numpy(a) for a in _batches(1)[0])
    with pytest.raises(TypeError):
        model.trainer.make_training_step()(x, t, pdf)
    with pytest.raises(TypeError):
        model.trainer.make_training_step(with_pdf=True)(x, t)
    assert model.trainer.step == 0


# -- (ii) step_fn against training_step ---------------------------------

@pytest.mark.parametrize("with_pdf", [False, True], ids=["no-pdf", "pdf"])
def test_step_fn_equals_training_step_and_does_not_count(with_pdf):
    a, b = _models(2)
    body = a.trainer.step_fn(with_pdf=with_pdf)
    for x, t, pdf in _batches(3):
        batch = (torch.from_numpy(x), torch.from_numpy(t)) + (
            (torch.from_numpy(pdf),) if with_pdf else ())
        got = body(*batch)
        want = b.trainer.training_step(*batch)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert a.trainer.step == 0 and b.trainer.step == 3
    for name, p in a.trainer.params().items():
        torch.testing.assert_close(p, b.trainer.params()[name], rtol=0, atol=0)


def test_make_training_step_equals_training_steps_and_counts():
    a, b = _models(2)
    step = a.trainer.make_training_step()
    for x, t, _ in _batches(3):
        x, t = torch.from_numpy(x), torch.from_numpy(t)
        torch.testing.assert_close(step(x, t), b.trainer.training_step(x, t), rtol=0, atol=0)
    assert a.trainer.step == b.trainer.step == 3
    for name, p in a.trainer.params().items():
        torch.testing.assert_close(p, b.trainer.params()[name], rtol=0, atol=0)
    assert not a.trainer._graphs   # the CPU captures nothing


# -- (iii) JAX's jit options have no counterpart -------------------------

@pytest.mark.parametrize("option", [{"in_shardings": None}, {"in_shardings": ()},
                                    {"out_shardings": ()}, {"donate_state": False}],
                         ids=["in_shardings-None", "in_shardings", "out_shardings",
                              "donate_state"])
def test_make_training_step_refuses_jax_options(option):
    (model,) = _models()
    with pytest.raises(TypeError, match="no counterpart"):
        model.trainer.make_training_step(**option)


# -- (iv) TrainStep on the compiled step --------------------------------

def test_train_step_outputs_are_unchanged():
    """``TrainStep`` through ``make_training_step`` gives what the one-entry
    ``training_loop`` it ran before gives, bit for bit: the trainer dict
    and the loss, over three calls."""
    (model,) = _models()
    step = serving.load_train_step(serving.export_train_step(model.trainer, 1024),
                                   device="cpu")
    (before,) = _models()
    state = want_state = model.trainer.serialize()
    for x, t, _ in _batches(3):
        x, t = torch.from_numpy(x), torch.from_numpy(t)
        state, loss = step(state, x, t)
        before.trainer.deserialize(want_state)
        want_loss = before.trainer.training_loop(x[None], t[None])[0]
        want_state = before.trainer.serialize()
        assert loss.shape == want_loss.shape == ()
        torch.testing.assert_close(loss, want_loss, rtol=0, atol=0)
        assert state["step"] == want_state["step"]
        fresh, again = _models(2)
        fresh.trainer.deserialize(state)
        again.trainer.deserialize(want_state)
        for name, p in fresh.trainer.params().items():
            torch.testing.assert_close(p, again.trainer.params()[name], rtol=0, atol=0)
    assert state["step"] == 3


# -- (v) the NeRF transmittance ----------------------------------------

def _alphas(seed):
    """(64, 48) alphas in [0, 1]: uniform rows, rows with alpha exactly 1 on
    every third sample (their products underflow to 0 by the fifth), rows
    within 1e-6 of 1 (factors near 1e-6, products subnormal), and rows in
    [0.999, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (64, 48)).astype(np.float32)
    a[:8, ::3] = 1.0
    a[8:16] = 1 - rng.uniform(0, 1e-6, (8, 48)).astype(np.float32)
    a[16:24] = rng.uniform(0.999, 1, (8, 48)).astype(np.float32)
    return a, rng.normal(size=a.shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_transmittance_equals_torch_cumprod_bit_for_bit(seed):
    a, g = _alphas(seed)
    x1, x2 = (torch.from_numpy(a).requires_grad_() for _ in range(2))
    got = tnf.Transmittance.apply(x1)
    want = torch.cumprod(1.0 - x2 + 1e-10, dim=-1)
    assert torch.equal(got, want)
    assert bool((want == 0).any()) and bool(((want > 0) & (want < 2.0 ** -126)).any())
    (dg,) = torch.autograd.grad(got, x1, torch.from_numpy(g))
    (dw,) = torch.autograd.grad(want, x2, torch.from_numpy(g))
    assert torch.equal(dg, dw)


@pytest.mark.parametrize("seed", [0, 1])
def test_transmittance_equals_jax_cumprod(seed):
    a, g = _alphas(seed)
    x = torch.from_numpy(a).requires_grad_()
    out = tnf.Transmittance.apply(x)
    (dx,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    jout, vjp = jax.vjp(lambda v: jnp.cumprod(1.0 - v + 1e-10, axis=-1), jnp.asarray(a))
    (jdx,) = vjp(jnp.asarray(g))
    out, dx, jout, jdx = out.detach().numpy(), dx.numpy(), np.asarray(jout), np.asarray(jdx)
    tol = 48 * 2.0 ** -24
    normal = np.abs(jout) >= 2.0 ** -126
    np.testing.assert_allclose(out[normal], jout[normal], rtol=tol, atol=0)
    np.testing.assert_allclose(out[~normal], jout[~normal], rtol=0, atol=2.0 ** -126)
    f = 1 - a + np.float32(1e-10)
    terms = np.flip(np.cumsum(np.flip(np.abs(g) * out, -1), -1), -1) / f
    bound = tol * terms + 2.0 ** -126 / 1e-10 * np.abs(g).max()
    assert (np.abs(dx - jdx) <= bound).all(), float((np.abs(dx - jdx) - bound).max())


# -- (vi) the NeRF step with the fraction as a buffer --------------------

def _load_jax_sample(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_sample_{name}", os.path.join(SAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def nerf_nets():
    jnf = _load_jax_sample("fit_nerf_field")
    jd, jc = jnf.build_model(jtcnn.Policy())
    k0, k1 = jax.random.split(jax.random.key(0))
    params = {"density": jd.init(k0), "color": jc.init(k1)}
    td, tc = tnf.build_model(tcnn.Policy(), device="cpu")
    load_jax_params(td, jax.tree_util.tree_map(np.asarray, params["density"]))
    load_jax_params(tc, jax.tree_util.tree_map(np.asarray, params["color"]))
    return jnf, jd, jc, params, td, tc


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return np.asarray(tree)


@pytest.mark.parametrize("frac", [0.5, 1.0])
def test_nerf_step_with_a_fraction_buffer_equals_the_float_fraction(nerf_nets, frac):
    jnf, jd, jc, params, td, tc = nerf_nets
    n_rays, n_samples = 64, 8
    rng = np.random.default_rng(11)
    o = rng.normal(size=(n_rays, 3)).astype(np.float32)
    o = 0.5 + 1.2 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(0.25, 0.75, (n_rays, 3)).astype(np.float32) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    to, td_ = torch.from_numpy(o), torch.from_numpy(d)

    buf = tnf.per_sample_frac(frac, n_rays * n_samples, "cpu")
    assert tnf.per_sample_frac(buf, n_rays * n_samples, "cpu") is buf
    loss, grads = tnf.loss_and_grads(td, tc, to, td_, n_samples, max_level_frac=buf)
    want_loss, want = tnf.loss_and_grads(td, tc, to, td_, n_samples, max_level_frac=frac)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(grads) == set(want)

    def jloss(p):
        gt = jnf.render(lambda x, v: jnf.true_field(x), jnp.asarray(o), jnp.asarray(d),
                        n_samples)
        pred = jnf.render(lambda x, v: jnf.model_field(jd, jc, p, x, v, max_level_frac=frac),
                          jnp.asarray(o), jnp.asarray(d), n_samples)
        return jnp.mean((pred - gt) ** 2)

    jax_loss, jax_grads = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
    for name, g in grads.items():
        for ref in (want[name].numpy(), _leaf(jax_grads, name)):
            scale = float(np.abs(ref).max())
            assert scale > 0, name
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * scale,
                                       err_msg=name)

    # The sample's step (Adam, jittered samples) through the buffer moves
    # the parameters as through the float, bit for bit.
    jitter = torch.from_numpy(rng.uniform(0, 1, (n_rays, n_samples)).astype(np.float32))
    moved = []
    for f in (buf, frac):
        nets = copy.deepcopy((td, tc))
        opt = tcnn.create_optimizer(tnf.OPTIMIZER)
        opt_state = opt.init(*tnf.params_and_layout(*nets))
        tnf.step(*nets, opt, opt_state, to, td_, n_samples, jitter, f)
        moved.append(tnf.params_and_layout(*nets)[0])
    for name, p in moved[0].items():
        torch.testing.assert_close(p, moved[1][name], rtol=0, atol=0)

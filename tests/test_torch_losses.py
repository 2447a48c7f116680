"""Every loss of the port against the JAX package's, on the CPU.

The same seeded numpy predictions, targets and pdfs go through both.
Tolerances: values and gradients rtol 1e-6, atol 1e-12 (the same float32
operations in the same order); CrossEntropy's and Variance's predictions
lie in [0.1, 1], a PDF's range, so no log or reciprocal meets 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn

NAMES = ["L2", "MSE", "RelativeL2", "RelativeL2Luminance", "L1", "MAE", "RelativeL1",
         "MAPE", "SMAPE", "CrossEntropy", "Variance"]


def _data(dims, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.1, 1.0, (129, dims)).astype(np.float32)
    target = rng.uniform(0.1, 1.0, (129, dims)).astype(np.float32)
    pdf = rng.uniform(0.5, 2.0, (129, dims)).astype(np.float32)
    return pred, target, pdf


def _both(jloss, loss, pred, target, pdf):
    jpdf = None if pdf is None else jnp.asarray(pdf)
    want_v = np.asarray(jloss.values(jnp.asarray(pred), jnp.asarray(target), jpdf))
    want, want_g = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(target), jpdf))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    tpdf = None if pdf is None else torch.from_numpy(pdf)
    got_v = loss.values(p, torch.from_numpy(target), tpdf)
    got = loss(p, torch.from_numpy(target), tpdf)
    got.backward()
    np.testing.assert_allclose(got_v.detach().numpy(), want_v, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("with_pdf", [False, True])
@pytest.mark.parametrize("dims", [3, 6])
def test_loss_values_and_gradients_equal_jax(name, with_pdf, dims):
    pred, target, pdf = _data(dims)
    jloss = jtcnn.create_loss({"otype": name})
    loss = tcnn.create_loss({"otype": name})
    assert type(loss).__name__ == type(jloss).__name__
    assert loss.channel_agnostic == jloss.channel_agnostic
    _both(jloss, loss, pred, target, pdf if with_pdf else None)


@pytest.mark.parametrize("with_pdf", [False, True])
def test_constant_gradient_values_and_gradient_equal_jax(with_pdf):
    pred, target, pdf = _data(3, seed=1)
    g = [0.5, -1.0, 2.0]
    jloss, loss = jtcnn.ConstantGradientLoss(g), tcnn.ConstantGradientLoss(g)
    _both(jloss, loss, pred, target, pdf if with_pdf else None)
    v = loss.values(torch.from_numpy(pred), torch.from_numpy(target))
    assert v.shape == pred.shape and float(v.abs().max()) == 0.0


def test_trainer_keeps_the_constant_gradient_override():
    """The trainer calls ``loss(pred, target)``, which sums ``values``:
    the gradient reaching the network is the constant, not divided by
    the element count."""
    cfg = {"loss": {"otype": "L2"}, "optimizer": {"otype": "SGD", "learning_rate": 1.0},
           "encoding": {"otype": "Identity"},
           "network": {"otype": "MLP", "n_neurons": 16, "n_hidden_layers": 0,
                       "activation": "None", "output_activation": "None"}}
    model = tcnn.create_from_config(2, 3, cfg, device="cpu")
    model.trainer.loss = tcnn.ConstantGradientLoss([1.0, 0.0, -2.0])
    x = torch.rand(8, 2)
    loss, grads = model.trainer.loss_value_and_grads(x, torch.zeros(8, 3))
    assert float(loss) == 0.0
    want = x.sum(0)[:, None] * torch.tensor([[1.0, 0.0, -2.0]])
    torch.testing.assert_close(grads["network.layers.0"], want, rtol=1e-6, atol=1e-6)


def test_names_aliases_and_hyperparams_round_trip():
    for name in NAMES:
        loss = tcnn.create_loss({"otype": name})
        hp = loss.hyperparams()
        assert hp == jtcnn.create_loss({"otype": name}).hyperparams()
        assert type(tcnn.create_loss(hp)) is type(loss)
        loss.update_hyperparams(hp)   # otype only: accepted
    assert isinstance(tcnn.create_loss({}), tcnn.RelativeL2Loss)
    assert isinstance(tcnn.create_loss({"otype": "mae"}), tcnn.L1Loss)
    with pytest.raises(ValueError):
        tcnn.create_loss({"otype": "ConstantGradient"})   # not registered, as in JAX
    with pytest.raises(NotImplementedError):
        tcnn.create_loss({"otype": "L1"}).update_hyperparams({"scale": 2})

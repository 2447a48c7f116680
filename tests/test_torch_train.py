"""Slice 2: training in the port against the JAX package, on the CPU.

Inputs come from numpy with a seed; ``load_jax_params`` and
``load_jax_opt_state`` carry the JAX state across.  Tolerances:
  * RelativeL2 / L2 values and gradients: rtol 1e-6 (the same float32
    operations).
  * Adam: ``mu``, ``nu`` and the parameters rtol 1e-6, atol 1e-12, step
    counters equal.  The same float32 operations run in the same order,
    but XLA's float32 sqrt on the CPU is not always correctly rounded
    (about 0.6 % of values are one ulp off torch's): the table starts
    from U(±1), a trained table's scale, so that no update cancels the
    parameter it is subtracted from and magnifies that ulp.
  * one full-width config_hash step, DEFAULT_POLICY, JAX's plain path
    (and a config_btf-structured one, tests/test_torch_btf.py):
    loss rtol 1e-5; every gradient within 1e-5 relative plus 1e-6 of its
    leaf's largest magnitude (fp32 sums in another order).  Adam's first
    step moves each stepped entry by about ±lr whatever its gradient's
    size, so a gradient within rounding of zero may change its sign or its
    zero-ness: the updated parameters are compared, rtol 1e-5 and atol
    1e-7 (a float32 ulp of the O(1) operands, where an update cancels the
    parameter), only where |g| > 1e-5·max|g|.
  * one BF16_POLICY step with TCNN_TPU_FORCE_FAST_SCATTER=1 (JAX runs
    _gather_kernel, _scatter_kernel, _fwd_kernel and _bwd_kernel in
    interpret mode): loss rtol 2e-2; every gradient within 2e-2 of its
    leaf's largest magnitude (a grid feature, each hidden activation and
    each dz may round to the other bf16 neighbour, and JAX rounds every
    w·dy product to bf16); the updated parameters as in the fp32 step,
    where |g| exceeds that tolerance, so that both gradients have the same
    sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu.utils.image import synthetic_image as jax_synthetic_image
from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
from tcnn_tpu_torch.utils.jax_params import load_jax_opt_state, load_jax_params
from tcnn_tpu_torch.utils.metrics import psnr

from test_torch_slice import CONFIG, flat_params


def small_hash_config(network_otype="MLP"):
    """tests/test_trainer.py's small config."""
    return {
        "loss": {"otype": "RelativeL2"},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2,
                      "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
        "encoding": {"otype": "HashGrid", "n_levels": 8,
                     "n_features_per_level": 2, "log2_hashmap_size": 12,
                     "base_resolution": 8, "per_level_scale": 1.5},
        "network": {"otype": network_otype, "n_neurons": 32,
                    "n_hidden_layers": 2, "activation": "ReLU",
                    "output_activation": "None"},
    }


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- (b) losses ---------------------------------------------------------

@pytest.mark.parametrize("name", ["RelativeL2", "L2"])
@pytest.mark.parametrize("with_pdf", [False, True])
def test_loss_values_and_gradient_equal_jax(name, with_pdf):
    rng = np.random.default_rng(0)
    pred, target = rng.normal(size=(2, 257, 3)).astype(np.float32)
    pdf = rng.uniform(0.5, 2, (257, 3)).astype(np.float32) if with_pdf else None
    jloss = jtcnn.create_loss({"otype": name})
    want, want_g = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(target), None if pdf is None else jnp.asarray(pdf))
    )(jnp.asarray(pred))
    loss = tcnn.create_loss({"otype": name})
    p = torch.from_numpy(pred).requires_grad_()
    tpdf = None if pdf is None else torch.from_numpy(pdf)
    got = loss(p, torch.from_numpy(target), tpdf)
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-12)
    if pdf is None:   # channel-agnostic: the (D, B) layout gives the same value
        soa = loss(torch.from_numpy(pred.T.copy()), torch.from_numpy(target.T.copy()))
        np.testing.assert_allclose(float(soa), float(want), rtol=1e-6)


def test_loss_registry_default_and_rejects_updates():
    assert isinstance(tcnn.create_loss({}), tcnn.RelativeL2Loss)
    with pytest.raises(NotImplementedError):
        tcnn.create_loss({"otype": "L2"}).update_hyperparams({"scale": 2})


# -- (b) Adam -----------------------------------------------------------

ADAM_CFGS = [
    {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
     "epsilon": 1e-15, "l2_reg": 1e-6},
    {"otype": "Adam", "learning_rate": 5e-3, "beta1": 0.8, "beta2": 0.995,
     "epsilon": 1e-10, "l2_reg": 1e-4, "adabound": True, "relative_decay": 1e-2,
     "absolute_decay": 1e-4, "non_matrix_learning_rate_factor": 0.5,
     "clipping_magnitude": 0.5},
]


@pytest.mark.parametrize("cfg", ADAM_CFGS, ids=["config_hash", "all_options"])
def test_adam_steps_equal_jax_with_lazy_counters(cfg):
    """2 JAX steps, then the state carried across mid-training (some table
    entries never stepped), then 3 steps on both sides."""
    mcfg = {**small_hash_config(), "optimizer": cfg}
    jmodel = jtcnn.create_from_config(2, 3, mcfg)
    state = _jax_state(jmodel)
    rng = np.random.default_rng(1)

    def grads_tree(i):
        g = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), state.params)
        grid = g["encoding"]["grid"]
        grid[rng.uniform(size=grid.shape) < 0.4] = 0.0   # lazy steps
        grid[:64] = 0.0                                    # never stepped
        return g

    grads = [grads_tree(i) for i in range(5)]
    opt_state, params = state.opt_state, state.params
    for g in grads[:2]:
        opt_state, params = jmodel.optimizer.step(opt_state, g, params)

    model = tcnn.create_from_config(2, 3, mcfg, device="cpu")
    assert model.network.param_layout() == {
        "encoding.grid": "other", "network.layers.0": "matrix",
        "network.layers.1": "matrix", "network.layers.2": "matrix"}
    load_jax_params(model, _np_tree(params))
    load_jax_opt_state(model.trainer, _np_tree(opt_state))
    for g in grads[2:]:
        opt_state, params = jmodel.optimizer.step(opt_state, g, params)
        model.optimizer.step(model.trainer.opt_state,
                             {n: torch.from_numpy(v) for n, v in flat_params(g).items()},
                             model.trainer.params())

    st = model.trainer.opt_state
    assert int(st["step"]) == int(opt_state["step"]) == 5
    steps = flat_params(opt_state["param_steps"])
    assert (steps["encoding.grid"][:64] == 0).all() and steps["encoding.grid"].max() == 5
    for name, want in steps.items():
        np.testing.assert_array_equal(st["param_steps"][name].numpy(), want)
    for key in ("mu", "nu"):
        for name, want in flat_params(opt_state[key]).items():
            np.testing.assert_allclose(st[key][name].numpy(), want, rtol=1e-6, atol=1e-12)
    got = model.trainer.params()
    for name, want in flat_params(params).items():
        np.testing.assert_allclose(got[name].detach().numpy(), want, rtol=1e-6, atol=1e-12)


def test_update_hyperparams_takes_effect_and_rejects_unknown_keys():
    model = tcnn.create_from_config(2, 3, small_hash_config(), device="cpu")
    x, t = torch.rand(64, 2), torch.rand(64, 3)
    model.trainer.training_step(x, t)
    model.trainer.update_hyperparams({"optimizer": {"otype": "Adam", "learning_rate": 0.0}})
    assert model.optimizer.learning_rate == 0.0
    before = {n: p.detach().clone() for n, p in model.trainer.params().items()}
    model.trainer.training_step(x, t)
    for n, p in model.trainer.params().items():
        torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        model.trainer.update_hyperparams({"optimizer": {"bogus": 1}})


# -- (c), (d) one full-width config_hash step ----------------------------

def _jax_state(model):
    """The model's initial state with its grid table redrawn U(±1) from
    seed 0 (the table is the leaf named "grid", under a Composite too)."""
    state = model.trainer.initial_state()
    rng = np.random.default_rng(0)
    state.params.update(jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(rng.uniform(-1, 1, v.shape).astype(np.float32))
        if getattr(path[-1], "key", None) == "grid" else v, dict(state.params)))
    return state


def _step_against_jax(policy_name, grad_tol, cfg=CONFIG, n_dims=2):
    jpolicy, policy = getattr(jtcnn, policy_name), getattr(tcnn, policy_name)
    jmodel = jtcnn.create_from_config(n_dims, 3, cfg, policy=jpolicy)
    state = _jax_state(jmodel)
    model = tcnn.create_from_config(n_dims, 3, cfg, policy=policy, device="cpu")
    load_jax_params(model, _np_tree(state.params))
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (1024, n_dims)).astype(np.float32)
    t = rng.uniform(0, 1, (1024, 3)).astype(np.float32)

    want_loss, want_g = jmodel.trainer.loss_value_and_grads(
        state.params, jnp.asarray(x), jnp.asarray(t))
    loss, grads = model.trainer.loss_value_and_grads(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=grad_tol["loss"])
    # The JAX step's body (trainer.py:142-148) on these gradients: its
    # jitted step would run the interpret-mode kernels once more.
    _, new_params = jax.jit(jmodel.optimizer.step)(state.opt_state, want_g, state.params)
    want_g = flat_params(want_g)
    assert set(want_g) == set(grads)
    for name, want in want_g.items():
        got = grads[name].numpy()
        assert grads[name].dtype == torch.float32
        scale = np.abs(want).max()
        assert scale > 0
        err = np.abs(got - want)
        assert (err <= grad_tol["rel"] * np.abs(want) + grad_tol["max"] * scale).all(), \
            (name, float(err.max()), float(scale))

    model.trainer.training_step(torch.from_numpy(x), torch.from_numpy(t))
    got_p = model.trainer.params()
    for name, want in flat_params(new_params).items():
        g = want_g[name]
        sure = np.abs(g) > grad_tol["sign"] * np.abs(g).max()
        assert sure.sum() >= 1000 or sure.mean() > 0.5
        np.testing.assert_allclose(got_p[name].detach().numpy()[sure], want[sure],
                                   rtol=1e-5, atol=1e-7)


def test_full_width_fp32_training_step_equals_jax():
    _step_against_jax("DEFAULT_POLICY",
                      {"loss": 1e-5, "rel": 1e-5, "max": 1e-6, "sign": 1e-5})


def test_full_width_bf16_training_step_equals_jax_kernels(monkeypatch):
    monkeypatch.setenv("TCNN_TPU_FORCE_FAST_SCATTER", "1")
    _step_against_jax("BF16_POLICY",
                      {"loss": 2e-2, "rel": 0.0, "max": 2e-2, "sign": 2e-2})


def test_output_perturbation_matches_jax_with_injected_noise(monkeypatch):
    jmodel = jtcnn.create_from_config(2, 3, small_hash_config())
    jmodel.trainer.perturbation_sigma = 0.1
    state = jmodel.trainer.initial_state()
    model = tcnn.create_from_config(2, 3, small_hash_config(), device="cpu")
    model.trainer.perturbation_sigma = 0.1
    load_jax_params(model, _np_tree(state.params))
    rng = np.random.default_rng(4)
    x, t = rng.uniform(0, 1, (2, 256, 2)).astype(np.float32)[0], \
        rng.uniform(0, 1, (256, 3)).astype(np.float32)
    noise = rng.logistic(size=(256, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "logistic", lambda key, shape, dtype: jnp.asarray(noise))
    model.trainer.perturbation_noise = lambda shape, device: torch.from_numpy(noise)
    want, _ = jmodel.trainer.loss_value_and_grads(state.params, jnp.asarray(x),
                                                  jnp.asarray(t), step=state.step)
    got, _ = model.trainer.loss_value_and_grads(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_output_perturbation_noise_is_standard_logistic():
    model = tcnn.create_from_config(2, 3, small_hash_config(), device="cpu")
    noise = model.trainer.perturbation_noise((200000,), torch.device("cpu"))
    assert abs(float(noise.mean())) < 0.02
    assert abs(float(noise.std()) - np.pi / np.sqrt(3)) < 0.02
    assert not torch.equal(noise, model.trainer.perturbation_noise((200000,), "cpu"))


def test_external_dL_dy_step_equals_loss_step():
    """A step fed the loss's own output gradient equals the loss step."""
    a = tcnn.create_from_config(2, 3, small_hash_config(), device="cpu")
    b = tcnn.create_from_config(2, 3, small_hash_config(), device="cpu")
    x, t = torch.rand(128, 2), torch.rand(128, 3)
    pred = b.trainer.forward(x).float().requires_grad_()
    (dL_dy,) = torch.autograd.grad(b.loss(pred, t), pred)
    a.trainer.training_step(x, t)
    out = b.trainer.training_step_external_dL_dy(x, dL_dy)
    assert out.shape == (128, 3) and b.trainer.step == 1
    for n, p in a.trainer.params().items():
        torch.testing.assert_close(b.trainer.params()[n], p, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(a.trainer.evaluate_loss(x, t), b.trainer.evaluate_loss(x, t))


# -- (e) image fit, (f) training loop ----------------------------------

def test_synthetic_image_equals_jax():
    np.testing.assert_array_equal(synthetic_image(48, 40, seed=2),
                                  jax_synthetic_image(48, 40, seed=2))


def test_image_fit_loss_drops():
    """tests/test_trainer.py::test_loss_decreases_on_image_fit in the port."""
    sampler = ImageSampler(synthetic_image(64, 64), device="cpu")
    model = tcnn.create_from_config(2, 3, small_hash_config(), device="cpu")
    losses = [float(model.trainer.training_step(*sampler.sample_batch(1024)))
              for _ in range(100)]
    assert losses[-1] < 0.2 * losses[0]
    pred = model.trainer.inference(sampler.full_grid_coords())
    assert psnr(pred, sampler.image.reshape(-1, 3)) > 15.0


@pytest.mark.parametrize("network", ["MLP", "FullyFusedMLP"])
def test_training_loop_equals_training_steps(network):
    models = [tcnn.create_from_config(2, 3, small_hash_config(network), device="cpu")
              for _ in range(2)]
    samplers = [ImageSampler(synthetic_image(32, 32), seed=3, device="cpu")
                for _ in range(2)]
    loop = models[0].trainer.make_training_loop(
        lambda i: samplers[0].sample_batch(512), 4)
    got = loop()
    want = torch.stack([models[1].trainer.training_step(*samplers[1].sample_batch(512))
                        for _ in range(4)])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for n, p in models[0].trainer.params().items():
        torch.testing.assert_close(p, models[1].trainer.params()[n], rtol=0, atol=0)
    xs = torch.stack([samplers[0].sample_batch(512)[0] for _ in range(3)])
    ts = torch.rand(3, 512, 3)
    assert models[0].trainer.training_loop(xs, ts).shape == (3,)
    assert models[0].trainer.step == 7


def test_sampler_windows_stay_in_the_pool():
    sampler = ImageSampler(synthetic_image(16, 16), seed=1, device="cpu")
    xy, rgb = sampler.pool_data()
    assert xy.shape == (256, 2) and rgb.shape == (256, 3)
    # every pixel centre once
    assert len({(round(float(u) * 16), round(float(v) * 16)) for u, v in xy * 16 - 0.5}) == 256
    torch.testing.assert_close(sampler.sample_at(xy), rgb)
    bx, brgb = sampler.sample_batch(100)
    assert bx.shape == (100, 2) and brgb.shape == (100, 3)
    big_xy, _ = sampler.sample_batch(300)          # wraps around the pool
    assert big_xy.shape == (300, 2)
    bxy, bilinear = sampler.sample_batch_bilinear(50)
    torch.testing.assert_close(bilinear, sampler.sample_at(bxy))

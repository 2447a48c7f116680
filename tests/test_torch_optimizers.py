"""Every optimizer of the port against the JAX package's, on the CPU.

A small HashGrid + MLP's parameters (the table redrawn U(±1) from a
seed, a trained table's scale, as in tests/test_torch_train.py) take 25
steps of seeded numpy gradients on both sides.  The grid's gradients are
0 on 40 % of the entries and on the first 64 always (lazy Adam
counters).  JAX takes the first 3 steps alone; ``load_jax_opt_state``
and ``load_jax_params`` then carry its state across, so every state
leaf goes through the carry.  The steps cross Batched's period (4),
Lookahead's (6), Average's ring wrap (8 samples), ExponentialDecay's
boundaries (5, 12, 19) and Shampoo's root refreshes (t = 1, 10, 20).

Tolerances, per leaf, on the parameters, every state leaf and the custom
weights: integer leaves (step counters) equal; float leaves within rtol
1e-5 plus 1e-6 of the leaf's largest magnitude.  The float32 operations
run in JAX's order, but XLA's float32 sqrt and pow on the CPU are not
always correctly rounded (an ulp in 0.6 % of values), and Novograd's
per-layer Σg² sums in another order (the largest difference seen:
2.1e-7 of a leaf's largest magnitude).  Shampoo: rtol 1e-4 plus 1e-5 of
the largest magnitude: its roots come from LAPACK's eigh here and XLA's
there, and its matrix products sum in other orders (the largest
difference seen after 25 steps: 2.0e-6 of a leaf's largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.optimizers.base import jax_order, named_leaves
from tcnn_tpu_torch.utils.jax_params import load_jax_opt_state, load_jax_params

from test_torch_slice import flat_params

ADAM = {"otype": "Adam", "learning_rate": 1e-2, "beta2": 0.99, "epsilon": 1e-15,
        "l2_reg": 1e-6}
N_STEPS, JAX_FIRST = 25, 3

OPTIMIZERS = {
    "SGD": {"otype": "SGD", "learning_rate": 1e-2, "l2_reg": 1e-4},
    "Novograd": {"otype": "Novograd", "learning_rate": 1e-2, "relative_decay": 1e-3,
                 "absolute_decay": 1e-5},
    "EMA": {"otype": "EMA", "decay": 0.9, "nested": ADAM},
    "Average": {"otype": "Average", "n_samples": 8, "nested": ADAM},
    "Batched": {"otype": "Batched", "batch_size_multiplier": 4, "nested": ADAM},
    "Lookahead": {"otype": "Lookahead", "alpha": 0.5, "n_steps": 6, "nested": ADAM},
    "ExponentialDecay": {"otype": "ExponentialDecay", "decay_base": 0.5, "decay_start": 5,
                         "decay_end": 19, "decay_interval": 7, "nested": ADAM},
    "ExponentialDecay_SGD": {"otype": "ExponentialDecay", "decay_base": 0.5,
                             "decay_start": 5, "decay_end": 19, "decay_interval": 7,
                             "nested": {"otype": "SGD", "learning_rate": 1e-2}},
    "Composite_kinds": {"otype": "Composite", "learning_rate_factor": 0.5, "nested": [
        ADAM, {"otype": "SGD", "learning_rate": 1e-1, "params": "other"}]},
    "Composite_counts": {"otype": "Composite", "nested": [
        {"otype": "SGD", "learning_rate": 1e-1, "n_params_to_optimize": 688},
        {**ADAM, "n_params_to_optimize": 1 << 20}]},
    "Shampoo": {"otype": "Shampoo", "learning_rate": 1e-2},
    "EMA_Average": {"otype": "EMA", "decay": 0.8,
                    "nested": {"otype": "Average", "n_samples": 8, "nested": ADAM}},
    "Batched_EMA": {"otype": "Batched", "batch_size_multiplier": 4,
                    "nested": {"otype": "EMA", "decay": 0.9, "nested": ADAM}},
}


def _config(opt):
    return {"loss": {"otype": "RelativeL2"}, "optimizer": opt,
            "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                         "log2_hashmap_size": 8, "base_resolution": 4,
                         "per_level_scale": 1.5},
            "network": {"otype": "MLP", "n_neurons": 16, "n_hidden_layers": 2}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads(params, n):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        g = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), _np_tree(params))
        grid = g["encoding"]["grid"]
        grid[rng.uniform(size=grid.shape) < 0.4] = 0.0
        grid[:64] = 0.0
        out.append(g)
    return out


def _jax_start(cfg):
    jmodel = jtcnn.create_from_config(2, 3, cfg)
    state = jmodel.trainer.initial_state()
    grid = state.params["encoding"]["grid"]
    state.params["encoding"]["grid"] = jnp.asarray(
        np.random.default_rng(0).uniform(-1, 1, grid.shape).astype(np.float32))
    return jmodel, state


def _tol(name):
    return (1e-4, 1e-5) if "Shampoo" in name else (1e-5, 1e-6)


def _close(got, want, name, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        rtol, scale = _tol(name)
        atol = scale * max(float(np.abs(want).max()), 1e-30) if want.size else 0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_equal_jax(name):
    cfg = _config(OPTIMIZERS[name])
    jmodel, state = _jax_start(cfg)
    grads = _grads(state.params, N_STEPS)
    opt_state, params = state.opt_state, state.params
    for g in grads[:JAX_FIRST]:
        opt_state, params = jmodel.optimizer.step(opt_state, g, params)

    model = tcnn.create_from_config(2, 3, cfg, device="cpu")
    load_jax_params(model, _np_tree(params))
    load_jax_opt_state(model.trainer, _np_tree(opt_state))
    tparams = model.trainer.params()
    for g in grads[JAX_FIRST:]:
        opt_state, params = jmodel.optimizer.step(opt_state, g, params)
        model.optimizer.step(model.trainer.opt_state,
                             {n: torch.from_numpy(v) for n, v in flat_params(g).items()},
                             tparams)

    for n, want in flat_params(params).items():
        _close(tparams[n].detach().numpy(), want, name, f"param {n}")
    jleaves = jax.tree_util.tree_leaves(opt_state)
    tleaves = list(named_leaves(model.trainer.opt_state))
    assert len(jleaves) == len(tleaves)
    for want, (path, got) in zip(jleaves, tleaves):
        _close(got.numpy(), want, name, f"state {path}")
    want_cw = jmodel.optimizer.custom_weights(opt_state, params)
    got_cw = model.optimizer.custom_weights(model.trainer.opt_state, tparams)
    assert (want_cw is None) == (got_cw is None)
    if want_cw is not None:
        for n, want in flat_params(want_cw).items():
            _close(got_cw[n].detach().numpy(), want, name, f"custom weight {n}")


@pytest.mark.parametrize("name", ["EMA", "Batched", "Lookahead"])
def test_lazy_adam_counters_under_wrappers(name):
    """Grid rows that no gradient touches stay unstepped inside the
    wrapper's nested Adam, and their parameters unchanged (Lookahead's
    sync moves a row only toward its own unchanged slow copy)."""
    model = tcnn.create_from_config(2, 3, _config(OPTIMIZERS[name]), device="cpu")
    params = model.trainer.params()
    before = params["encoding.grid"].detach().clone()
    rng = np.random.default_rng(3)
    for _ in range(13):
        g = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
             for n, p in params.items()}
        g["encoding.grid"][:64] = 0.0
        model.optimizer.step(model.trainer.opt_state, g, params)
    st = model.trainer.opt_state["nested"]
    steps = st["param_steps"]["encoding.grid"]
    assert int(steps[:64].abs().max()) == 0 and int(steps[64:].max()) > 0
    torch.testing.assert_close(params["encoding.grid"].detach()[:64], before[:64],
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_create_optimizer_and_hyperparams_equal_jax(name):
    cfg = OPTIMIZERS[name]
    opt, jopt = tcnn.create_optimizer(cfg), jtcnn.create_optimizer(cfg)
    hp = opt.hyperparams()
    assert hp == jopt.hyperparams()
    assert tcnn.create_optimizer(hp).hyperparams() == hp
    assert opt.learning_rate == jopt.learning_rate
    assert opt.n_nested() == jopt.n_nested()
    for i in range(opt.n_nested()):
        assert opt.nested(i).hyperparams() == jopt.nested(i).hyperparams()
    with pytest.raises(IndexError):
        opt.nested(opt.n_nested())


def test_every_otype_defaults_equal_jax():
    for otype in ["Adam", "SGD", "Novograd", "Shampoo", "EMA", "Average", "Batched",
                  "Lookahead", "ExponentialDecay"]:
        assert (tcnn.create_optimizer({"otype": otype}).hyperparams()
                == jtcnn.create_optimizer({"otype": otype}).hyperparams()), otype
    assert isinstance(tcnn.create_optimizer({}), tcnn.Adam)
    comp = {"otype": "Composite", "nested": [{"otype": "Adam"}, {"otype": "SGD"}]}
    assert (tcnn.create_optimizer(comp).hyperparams()
            == jtcnn.create_optimizer(comp).hyperparams())


@pytest.mark.parametrize("update", [
    {"otype": "EMA", "decay": 0.5, "nested": {"learning_rate": 0.25}},
    {"otype": "Lookahead", "alpha": 0.25, "n_steps": 3, "nested": {"beta1": 0.5}},
    {"otype": "Composite", "learning_rate_factor": 2.0,
     "nested": [{"learning_rate": 0.5}, {"l2_reg": 0.0}]},
    {"otype": "Shampoo", "identity": 0.1, "frobenius_normalization": False},
])
def test_update_hyperparams_equal_jax(update):
    base = {"EMA": OPTIMIZERS["EMA"], "Lookahead": OPTIMIZERS["Lookahead"],
            "Composite": OPTIMIZERS["Composite_kinds"],
            "Shampoo": OPTIMIZERS["Shampoo"]}[update["otype"]]
    opt, jopt = tcnn.create_optimizer(base), jtcnn.create_optimizer(base)
    opt.update_hyperparams(update)
    jopt.update_hyperparams(update)
    assert opt.hyperparams() == jopt.hyperparams()
    with pytest.raises(NotImplementedError):
        opt.update_hyperparams({"bogus": 1})


def test_composite_rejects_a_misaligned_boundary_and_orders_by_jax_leaves():
    bad = {"otype": "Composite", "nested": [
        {"otype": "SGD", "n_params_to_optimize": 100}, {"otype": "Adam",
                                                        "n_params_to_optimize": 1 << 20}]}
    with pytest.raises(ValueError, match="boundary"):
        tcnn.create_from_config(2, 3, _config(bad), device="cpu")
    model = tcnn.create_from_config(2, 3, _config(OPTIMIZERS["Composite_counts"]),
                                    device="cpu")
    # The grid (688 entries) comes first in the JAX tree's order.
    assert model.optimizer._assignment == {n: int(n != "encoding.grid")
                                           for n in jax_order(model.trainer.params())}


def test_shampoo_refuses_capture_and_the_loop_says_why():
    """Since kernel SR refreshes Shampoo's roots on the device, every
    optimizer of ``OPTIMIZERS`` is capturable, Shampoo under each wrapper
    too; an optimizer that is not still passes its reason up through the
    wrappers, where ``Trainer.make_training_loop`` and
    ``make_training_step`` raise it on the card."""
    assert all(tcnn.create_optimizer(c).capturable for c in OPTIMIZERS.values())
    for wrapper in ("EMA", "Average", "Batched", "Lookahead", "ExponentialDecay"):
        opt = tcnn.create_optimizer({"otype": wrapper, "nested": {"otype": "Shampoo"}})
        assert opt.capturable and opt.capture_error == "", wrapper
    assert tcnn.create_optimizer({"otype": "Composite", "nested": [
        {"otype": "Adam", "params": "other"}, {"otype": "Shampoo", "params": "matrix"}]}).capturable

    class Uncapturable(tcnn.SGD):
        capturable = False
        capture_error = "this step reads the device"

    opt = tcnn.optimizers.EMA(tcnn.optimizers.Composite([tcnn.Adam(), Uncapturable()],
                                                        kinds_each=["other", "matrix"]))
    assert not opt.capturable and opt.capture_error == "this step reads the device"


def test_shampoo_refresh_due_equals_jax():
    """The refresh predicate on a counter tensor equals JAX's under
    ``jnp.uint32`` (``tcnn_tpu/optimizers/shampoo.py:140-141``) for t = 1
    to 1000: t = 1, 10, 20, ..., 90, 200, 400, ..., and not t = 100."""
    from tcnn_tpu_torch.optimizers.shampoo import refresh_due

    t = np.arange(1, 1001)
    tj = jnp.asarray(t, jnp.uint32)
    interval = jnp.where(tj < 100, jnp.uint32(10), jnp.uint32(200))
    want = np.asarray((tj == 1) | ((tj % interval) == 0))
    got = refresh_due(torch.from_numpy(t.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(np.flatnonzero(got) + 1) == [1, *range(10, 100, 10), *range(200, 1001, 200)]


def test_shampoo_loop_equals_jax_across_the_cadence_change(monkeypatch):
    """210 steps of ``make_training_loop`` at ``_config``'s grid and narrow
    MLP with Shampoo, the port's eager CPU steps (the plain refresh)
    against JAX's jitted ``lax.scan``, on the same batches (JAX's own
    draws from the loop's step keys), across the refreshes at t = 90 and
    200 and the step t = 100 that JAX does not refresh at: the losses,
    the parameters and every state leaf within the Shampoo tolerance.  At
    a learning rate of 1e-3: at 1e-2 the fit feeds the two eigensolvers'
    rounding back into its gradients and the runs part by 2e-3 of a loss
    by t = 190.  The control: the port's run again with a refresh at
    t = 100 too lies beyond the tolerance at this rate."""
    steps, batch = 210, 64
    cfg = _config({**OPTIMIZERS["Shampoo"], "learning_rate": 1e-3})
    jmodel, state = _jax_start(cfg)

    def sample(k):
        x = jax.random.uniform(k, (batch, 2))
        return x, jnp.stack([jnp.sin(6 * x[:, 0]), jnp.cos(5 * x[:, 1]), x[:, 0] * x[:, 1]], 1)

    key = jax.random.key(3)
    xs, ts = jax.jit(jax.vmap(lambda i: sample(jax.random.fold_in(key, i))))(jnp.arange(steps))
    xs, ts = np.array(xs), np.array(ts)
    model = tcnn.create_from_config(2, 3, cfg, device="cpu")
    start = _np_tree(state.params)   # the loop donates the state's buffers
    load_jax_params(model, start)
    state, jlosses = jmodel.trainer.make_training_loop(sample, steps)(state, key)
    losses = model.trainer.make_training_loop(
        lambda i: (torch.from_numpy(xs[i]), torch.from_numpy(ts[i])), steps)()
    _close(losses.numpy(), np.asarray(jlosses), "Shampoo", "losses")
    assert int(model.trainer.opt_state["step"]) == steps
    for n, want in flat_params(state.params).items():
        _close(model.trainer.params()[n].detach().numpy(), want, "Shampoo", f"param {n}")
    jleaves = jax.tree_util.tree_leaves(state.opt_state)
    tleaves = list(named_leaves(model.trainer.opt_state))
    assert len(jleaves) == len(tleaves)
    for want, (path, got) in zip(jleaves, tleaves):
        _close(got.numpy(), want, "Shampoo", f"state {path}")

    from tcnn_tpu_torch.ops.cuda import shampoo_root
    due = shampoo_root.refresh_due
    monkeypatch.setattr(shampoo_root, "refresh_due", lambda t: due(t) | (t == 100))
    wrong = tcnn.create_from_config(2, 3, cfg, device="cpu")
    load_jax_params(wrong, start)
    wrong.trainer.make_training_loop(
        lambda i: (torch.from_numpy(xs[i]), torch.from_numpy(ts[i])), steps)()
    rtol, scale = _tol("Shampoo")
    assert not all(np.allclose(wrong.trainer.params()[n].detach().numpy(), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))
                   for n, want in flat_params(state.params).items())


def test_composite_with_an_empty_group_steps_like_jax():
    """A Composite whose "other" optimizer gets no parameter (a Frequency
    encoding has none) still keeps and steps that optimizer's state, as
    JAX does; the state lies on the parameters' device."""
    cfg = {**_config(OPTIMIZERS["Composite_kinds"]),
           "encoding": {"otype": "Frequency", "n_frequencies": 2}}
    jmodel = jtcnn.create_from_config(2, 3, cfg)
    state = jmodel.trainer.initial_state()
    model = tcnn.create_from_config(2, 3, cfg, device="cpu")
    load_jax_params(model, _np_tree(state.params))
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (256, 2)).astype(np.float32)
    t = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    for _ in range(3):
        state, _ = jmodel.trainer.training_step(state, jnp.asarray(x), jnp.asarray(t))
        model.trainer.training_step(torch.from_numpy(x), torch.from_numpy(t))
    jleaves = jax.tree_util.tree_leaves(state.opt_state)
    tleaves = list(named_leaves(model.trainer.opt_state))
    assert [p for p, _ in tleaves][-1] == "nested.1.step"
    assert len(jleaves) == len(tleaves)
    for want, (path, got) in zip(jleaves, tleaves):
        _close(got.numpy(), want, "Composite", f"state {path}")

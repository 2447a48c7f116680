"""Second-order derivatives of the port against the JAX package, on the CPU.

On the CPU the port's autograd functions run the plain versions of the
kernels (G, GB, GI, GG, RS, M, MB), so these tests hold those plain
versions, and the autograd structure around them, against JAX's autodiff:

  * the grid's input gradient against ``jax.vjp`` in x of ``grid_encode``;
  * ``GridEncoding.backward_backward_input`` (all three outputs) against
    JAX's, for Linear and Smoothstep, hash and dense grids, on JAX's
    default route (its jnp path) and with ``TCNN_TPU_FORCE_FAST_SCATTER=1``
    (its custom VJP and Pallas kernels in interpret mode);
  * ``FusedMLPBackwardFunction`` (kernel MB and its differentiable
    backward) against the VJP of JAX's ``_fused_mlp_bwd_op``;
  * ``NetworkWithInputEncoding.backward_backward_input`` and
    ``input_gradient`` on the SDF sample's model structure;
  * one eikonal step's loss and parameter gradients against
    ``jax.value_and_grad`` of the JAX sample's loss, x_surf and x_vol
    injected, and against the plain eikonal step of ``tools/plain_path.py``.

Tolerances, all fp32 (the fp32 policy):
  * table gradients elementwise rtol 1e-4, atol 1e-6 (tests/test_scatter.py:120):
    the same fp32 products, summed in another order;
  * every other gradient within 1e-5 of its largest magnitude (1e-4 for
    the MLP's second order, whose JAX side is autodiff of jnp matmuls that
    sum in yet another order): sums over corners, levels and samples in
    another order, and the port's closed-form Smoothstep derivative
    6f(1 − f) against JAX's autodiff of f·f·(3 − 2f).
Inputs stay at least 1e-3 (in cells) away from every level's cell borders,
where Linear weights are not differentiable.  The JAX side runs under
``jax.jit``: one compilation per case instead of one per eager operation
(about 4x faster here), rounding within the same fp32 tolerances.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
from tcnn_tpu import common as jcommon
from tcnn_tpu.ops import grid_ops as jops
from tcnn_tpu.ops.pallas import fused_mlp as jfused
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.common import Activation, GridType, InterpolationType
from tcnn_tpu_torch.ops import grid_ops as tops
from tcnn_tpu_torch.ops.cuda import fused_mlp as tfused
from tcnn_tpu_torch.ops.cuda import grid_encode as tgrid
from tcnn_tpu_torch.ops.cuda import scatter as tscatter
from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
from tcnn_tpu_torch.tools.plain_path import plain_sdf_loss_and_grads
from tcnn_tpu_torch.utils.jax_params import load_jax_params

CONFIG_HASH = str(Path(__file__).resolve().parents[1] / "configs" / "config_hash.json")

# (n_dims, n_levels, F, log2_hashmap_size, base, per-level scale, grid type, interpolation)
GRID_CASES = [
    (2, 3, 2, 8, 4, 1.5, "Hash", "Linear"),
    (3, 3, 2, 9, 4, 1.5, "Hash", "Smoothstep"),
    (3, 2, 4, 10, 4, 2.0, "Dense", "Linear"),
    (2, 4, 1, 10, 4, 1.5, "Dense", "Smoothstep"),
]


def _case_id(c):
    return f"{c[0]}d-{c[6]}-{c[7]}-F{c[2]}"


def _grid_kwargs(case):
    D, L, F, hm, base, scale, gt, it = case
    return dict(n_levels=L, n_features_per_level=F, log2_hashmap_size=hm,
                base_resolution=base, per_level_scale=scale), gt, it


def _encodings(case):
    """The JAX and the port's GridEncoding of a case, at the fp32 policy,
    holding the same U(±1) table; returns (jax enc, jax params, port enc)."""
    kw, gt, it = _grid_kwargs(case)
    jenc = jtcnn.GridEncoding(case[0], grid_type=jcommon.GridType(gt),
                              interpolation=jcommon.InterpolationType(it),
                              policy=jtcnn.Policy(), **kw)
    enc = tcnn.GridEncoding(case[0], grid_type=GridType(gt), interpolation=InterpolationType(it),
                            policy=tcnn.Policy(), device="cpu", **kw)
    table = np.random.default_rng(1).uniform(-1, 1, enc.spec.n_params).astype(np.float32)
    with torch.no_grad():
        enc.grid.copy_(torch.from_numpy(table))
    return jenc, {"grid": jnp.asarray(table)}, enc


def _coords(spec, n, seed, lo=0.05, hi=0.95):
    """n points in [lo, hi]^D at least 1e-3 of a cell from every live
    level's cell borders (pos rounded twice in float32, as both packages do)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (4 * n, spec.n_dims)).astype(np.float32)
    keep = np.ones(len(x), bool)
    for lv in spec.levels:
        pos = (x * np.float32(lv.scale)).astype(np.float32) + np.float32(0.5)
        frac = pos - np.floor(pos)
        keep &= ((frac > 1e-3) & (frac < 1 - 1e-3)).all(axis=1)
    assert keep.sum() >= n
    return x[keep][:n]


def _assert_rel(got, want, rel, what=""):
    """max |got − want| <= rel · max |want| (a gradient that is None in the
    port must be zero in JAX)."""
    want = np.asarray(want, np.float32)
    if got is None:
        assert np.abs(want).max() == 0, what
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(want).max() > 0, what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _assert_table_grad(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    assert np.abs(np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("case", GRID_CASES, ids=_case_id)
@pytest.mark.parametrize("max_level", [None, 2])
def test_grid_input_gradient_equals_jax(case, max_level):
    jenc, params, enc = _encodings(case)
    spec = enc.spec
    x = _coords(spec, 300, 2)
    dy = np.random.default_rng(3).normal(size=(300, spec.n_output_dims)).astype(np.float32)
    @jax.jit
    def input_grad(t, xx, g):
        _, vjp = jax.vjp(lambda x_: jops.grid_encode(jenc.spec, t, x_, max_level=max_level), xx)
        return vjp(g)[0]

    want = input_grad(params["grid"], jnp.asarray(x), jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    y = tops.grid_encode(spec, enc.grid.detach(), xt, max_level=max_level)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    _assert_rel(got, want, 1e-5, "dx")


@pytest.mark.parametrize("case", GRID_CASES, ids=_case_id)
@pytest.mark.parametrize("route", ["jnp", "fast"])
def test_grid_backward_backward_input_equals_jax(case, route, monkeypatch):
    """route "fast": TCNN_TPU_FORCE_FAST_SCATTER=1, JAX's custom VJP with
    its Pallas grid kernels in interpret mode, differentiated once more."""
    if route == "fast":
        monkeypatch.setenv("TCNN_TPU_FORCE_FAST_SCATTER", "1")
    jenc, params, enc = _encodings(case)
    B = 64
    x = _coords(enc.spec, B, 4)
    rng = np.random.default_rng(5)
    dL_dy = rng.normal(size=(B, enc.n_output_dims)).astype(np.float32)
    dL_ddLdx = rng.normal(size=(B, enc.n_input_dims)).astype(np.float32)
    want = jax.jit(jenc.backward_backward_input)(params, jnp.asarray(x), jnp.asarray(dL_dy),
                                                 jnp.asarray(dL_ddLdx))
    ddLdy, dparams, dx = enc.backward_backward_input(
        torch.from_numpy(x), torch.from_numpy(dL_dy), torch.from_numpy(dL_ddLdx))
    assert set(dparams) == {"grid"}
    _assert_rel(ddLdy, want[0], 1e-5, "ddLdy")
    _assert_table_grad(dparams["grid"], want[1]["grid"])
    _assert_rel(dx, want[2], 1e-5, "dx")


def test_grid_table_cotangent_blocks_equal_jax():
    """The blocks of a loss on the table gradient itself (ct_dflat): d/d
    dcols through G and d/dx through GI with the cotangent as the table
    (scatter.py:528-550's math), against JAX's autodiff."""
    case = GRID_CASES[1]
    jenc, params, enc = _encodings(case)
    spec, B = enc.spec, 96
    x = _coords(spec, B, 6)
    rng = np.random.default_rng(7)
    w = rng.normal(size=(B, spec.n_output_dims)).astype(np.float32)
    u = rng.normal(size=spec.n_params).astype(np.float32)

    def jloss(xx, ww):
        dt, dx = jax.grad(lambda t, x_: jnp.sum(jops.grid_encode(jenc.spec, t, x_) * ww),
                          argnums=(0, 1))(params["grid"], xx)
        return jnp.sum(dt * jnp.asarray(u)) + jnp.sum(dx ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    table = enc.grid.detach().requires_grad_()
    y = tops.grid_encode(spec, table, xt)
    dt, dx = torch.autograd.grad((y * wt).sum(), [table, xt], create_graph=True)
    got = torch.autograd.grad((dt * torch.from_numpy(u)).sum() + (dx ** 2).sum(), [xt, wt])
    _assert_rel(got[0], want[0], 1e-5, "dx")
    _assert_rel(got[1], want[1], 1e-5, "dw")


MLP_ACTS = [(Activation.RELU, Activation.NONE), (Activation.TANH, Activation.SIGMOID)]


@pytest.mark.parametrize("width,n_hidden", [(16, 1), (64, 2)])
@pytest.mark.parametrize("acts", MLP_ACTS, ids=lambda a: f"{a[0].value}-{a[1].value}")
@pytest.mark.parametrize("soa_in,soa_out", [(True, False), (False, True)])
def test_fused_mlp_second_order_equals_jax_bwd_op(width, n_hidden, acts, soa_in, soa_out):
    act, out_act = acts
    dims = [(16, width)] + [(width, width)] * (n_hidden - 1) + [(width, 1)]
    rng = np.random.default_rng(width + n_hidden)
    ws = [(rng.uniform(-1, 1, d) * np.sqrt(6.0 / sum(d))).astype(np.float32) for d in dims]
    B = 200
    x = rng.uniform(-1, 1, (16, B) if soa_in else (B, 16)).astype(np.float32)
    g = rng.normal(size=(1, B) if soa_out else (B, 1)).astype(np.float32)
    ct_dx = rng.normal(size=x.shape).astype(np.float32)
    ct_ws = [rng.normal(size=d).astype(np.float32) for d in dims]
    jact, jout = jcommon.Activation(act.value), jcommon.Activation(out_act.value)
    @jax.jit
    def bwd_and_vjp(w, x_, g_, cts):
        out, vjp = jax.vjp(
            lambda w_, xx, gg: jfused._fused_mlp_bwd_op(w_, xx, gg, jact, jout, jnp.float32,
                                                        jnp.float32, soa_in, soa_out),
            w, x_, g_)
        return out, vjp(cts)

    (jdws, jdx), (w_want, x_want, g_want) = bwd_and_vjp(
        tuple(jnp.asarray(w) for w in ws), jnp.asarray(x), jnp.asarray(g),
        (tuple(jnp.asarray(c) for c in ct_ws), jnp.asarray(ct_dx)))

    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    dx, *dws = tfused.FusedMLPBackwardFunction.apply(
        xt, gt, act, out_act, torch.float32, torch.float32, soa_in, soa_out, *wt)
    _assert_rel(dx, jdx, 1e-5, "dx")
    for i, (a, b) in enumerate(zip(dws, jdws)):
        _assert_rel(a, b, 1e-5, f"dW{i}")
    grads = torch.autograd.grad([dx, *dws], [xt, gt, *wt],
                                grad_outputs=[torch.from_numpy(ct_dx)]
                                + [torch.from_numpy(c) for c in ct_ws], allow_unused=True)
    _assert_rel(grads[0], x_want, 1e-4, "d x")
    _assert_rel(grads[1], g_want, 1e-4, "d g")
    for i, (a, b) in enumerate(zip(grads[2:], w_want)):
        _assert_rel(a, b, 1e-4, f"d W{i}")


SDF_SMALL = {**sdf.CONFIG,
             "encoding": {**sdf.CONFIG["encoding"], "n_levels": 4, "log2_hashmap_size": 10}}


def _sdf_models(route, monkeypatch):
    """The SDF sample's model structure at a small size (4 levels, 2^10-row
    tables; FullyFusedMLP 64 x 2, 16 -> 1), JAX's and the port's, with the
    same parameters (the grid U(±1))."""
    if route == "fast":
        monkeypatch.setenv("TCNN_TPU_FORCE_FAST_SCATTER", "1")
    jmodel = jtcnn.create_from_config(3, 1, SDF_SMALL, policy=jtcnn.Policy())
    params = jmodel.network.init(jax.random.key(0))
    table = np.random.default_rng(9).uniform(-1, 1, params["encoding"]["grid"].shape)
    params["encoding"]["grid"] = jnp.asarray(table.astype(np.float32))
    model = tcnn.create_from_config(3, 1, SDF_SMALL, policy=tcnn.Policy(), device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jmodel.network, params, model


def _flat_grads(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in leaves}


@pytest.mark.parametrize("route", ["jnp", "fast"])
def test_network_backward_backward_input_equals_jax(route, monkeypatch):
    jnet, params, model = _sdf_models(route, monkeypatch)
    net = model.network
    B = 128
    x = _coords(net.encoding.spec, B, 10)
    rng = np.random.default_rng(11)
    dL_dy = rng.normal(size=(B, 1)).astype(np.float32)
    dL_ddLdx = rng.normal(size=(B, 3)).astype(np.float32)
    want = jax.jit(jnet.backward_backward_input)(params, jnp.asarray(x), jnp.asarray(dL_dy),
                                                 jnp.asarray(dL_ddLdx))
    ddLdy, dparams, dx = net.backward_backward_input(
        torch.from_numpy(x), torch.from_numpy(dL_dy), torch.from_numpy(dL_ddLdx))
    _assert_rel(ddLdy, want[0], 1e-5, "ddLdy")
    jgrads = _flat_grads(want[1])
    assert set(dparams) == set(jgrads)
    _assert_table_grad(dparams["encoding.grid"], jgrads["encoding.grid"])
    for name in dparams:
        if name != "encoding.grid":
            _assert_rel(dparams[name], jgrads[name], 1e-4, name)
    _assert_rel(dx, want[2], 1e-4, "dx")
    for dim in (0,):
        _assert_rel(net.input_gradient(torch.from_numpy(x), dim),
                    jax.jit(jnet.input_gradient, static_argnums=2)(params, jnp.asarray(x), dim),
                    1e-5, "input_gradient")


def _jax_sdf_loss(jnet, xs, xv):
    """The JAX sample's loss (samples/fit_sdf_eikonal.py:67-84), x_surf and
    x_vol given."""
    def loss_fn(p):
        def f(xx):
            return jnet.apply(p, xx)[:, 0]
        surf_loss = jnp.mean(f(xs) ** 2)
        grad_x = jax.grad(lambda xx: jnp.sum(f(xx)))(xv)
        grad_norm = jnp.sqrt(jnp.sum(grad_x * grad_x, axis=-1) + 1e-12)
        return surf_loss + 0.1 * jnp.mean((grad_norm - 1.0) ** 2)
    return loss_fn


@pytest.mark.parametrize("route", ["jnp", "fast"])
def test_eikonal_step_gradients_equal_jax(route, monkeypatch):
    jnet, params, model = _sdf_models(route, monkeypatch)
    xs, xv = sdf.sample_points(torch.Generator().manual_seed(12), 256, "cpu")
    want_loss, want = jax.jit(jax.value_and_grad(_jax_sdf_loss(
        jnet, jnp.asarray(xs.numpy()), jnp.asarray(xv.numpy()))))(params)
    loss, grads = sdf.loss_and_grads(model.network, xs, xv)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = _flat_grads(want)
    assert set(grads) == set(want)
    _assert_table_grad(grads["encoding.grid"], want["encoding.grid"])
    for name in grads:
        if name != "encoding.grid":
            _assert_rel(grads[name], want[name], 1e-4, name)


def _spy_plain(monkeypatch, names):
    """Count calls of the named plain versions (the CPU stand-ins of the
    kernels; on the card each is a launch)."""
    calls = dict.fromkeys(names, 0)
    for mod in (tgrid, tfused, tscatter):
        for n in names:
            if hasattr(mod, n):
                def spy(*a, _f=getattr(mod, n), _n=n, **k):
                    calls[_n] += 1
                    return _f(*a, **k)
                monkeypatch.setattr(mod, n, spy)
    return calls


def test_plain_sdf_step_equals_model_step_and_launch_counts(monkeypatch):
    """The plain eikonal step of tools/plain_path.py equals the model's
    step bit for bit on the CPU, where the model runs the same plain
    versions; and the model's step runs G, M and MB twice, GB once (the
    surface term: the first-order call's table gradient, which the step
    would discard, is not computed), GI and GG once each, and RS never (GG
    adds the table gradient itself)."""
    model = tcnn.create_from_config(3, 1, SDF_SMALL, policy=tcnn.Policy(), device="cpu")
    with torch.no_grad():
        model.network.encoding.grid.uniform_(-1, 1, generator=torch.Generator().manual_seed(13))
    xs, xv = sdf.sample_points(torch.Generator().manual_seed(14), 512, "cpu")
    want_loss, want = plain_sdf_loss_and_grads(model.network, xs, xv)
    calls = _spy_plain(monkeypatch, [
        "grid_encode_plain", "fused_mlp_plain", "fused_mlp_bwd_plain", "grid_encode_bwd_plain",
        "grid_encode_bwd_input_plain", "grid_encode_bwd_bwd_plain", "row_scatter_add_plain"])
    loss, grads = sdf.loss_and_grads(model.network, xs, xv)
    assert loss.item() == want_loss.item()
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name
    # fused_mlp_plain: the two forwards and the recompute inside MB's
    # differentiable backward
    assert calls == {"grid_encode_plain": 2, "fused_mlp_plain": 3, "fused_mlp_bwd_plain": 2,
                     "grid_encode_bwd_plain": 1, "grid_encode_bwd_input_plain": 1,
                     "grid_encode_bwd_bwd_plain": 1, "row_scatter_add_plain": 0}


@pytest.mark.parametrize("fracs", ["half", "spread"])
def test_plain_sdf_step_under_a_level_mask_equals_model_step(fracs):
    """With ``level_frac`` the plain eikonal step equals, bit for bit on
    the CPU, the step of the model called with the same per-sample
    ``max_level_per_element`` (autograd through the loss, as
    ``chip_smoke.py``'s masked step drives it)."""
    model = tcnn.create_from_config(3, 1, SDF_SMALL, policy=tcnn.Policy(), device="cpu")
    net = model.network
    gen = torch.Generator().manual_seed(15)
    with torch.no_grad():
        net.encoding.grid.uniform_(-1, 1, generator=gen)
    xs, xv = sdf.sample_points(gen, 512, "cpu")
    frac = torch.full((512,), 0.5) if fracs == "half" else torch.rand(512, generator=gen)
    want_loss, want = plain_sdf_loss_and_grads(net, xs, xv, level_frac=frac)

    def f(x):
        return net(x, max_level_per_element=frac)[:, 0]

    xv = xv.clone().requires_grad_()
    (gx,) = torch.autograd.grad(f(xv).sum(), xv, create_graph=True)
    loss = torch.mean(f(xs) ** 2) + sdf.EIKONAL_WEIGHT * sdf.eikonal_loss(gx)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    assert loss.item() == want_loss.item()
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        assert torch.equal(g, want[name]), name
    # the mask bites: the unmasked plain step differs
    assert not torch.equal(plain_sdf_loss_and_grads(net, xs, xv.detach())[1]["encoding.grid"],
                           want["encoding.grid"])


def test_input_gradient_launches_no_table_gradient(monkeypatch):
    """``Module.input_gradient`` asks autograd for x's gradient alone: the
    grid's backward runs GI and no GB (the engine would drop the table's
    gradient), and the answer equals the one with GB forced."""
    model = tcnn.create_from_config(3, 1, SDF_SMALL, policy=tcnn.Policy(), device="cpu")
    net = model.network
    with torch.no_grad():
        net.encoding.grid.uniform_(-1, 1, generator=torch.Generator().manual_seed(16))
    x = sdf.sample_points(torch.Generator().manual_seed(17), 256, "cpu")[1]
    calls = _spy_plain(monkeypatch, ["grid_encode_bwd_plain", "grid_encode_bwd_input_plain"])
    dx = net.input_gradient(x, 0)
    assert calls == {"grid_encode_bwd_plain": 0, "grid_encode_bwd_input_plain": 1}
    monkeypatch.setattr(tops, "_engine_will_use", lambda t: True)
    assert torch.equal(net.input_gradient(x, 0), dx)
    assert calls == {"grid_encode_bwd_plain": 1, "grid_encode_bwd_input_plain": 2}


@pytest.mark.parametrize("ask", ["x", "table", "leaf", "both", "backward", "backward_x"])
def test_engine_node_query_pinned(ask):
    """The private ``torch._C._will_engine_execute_node`` behind
    ``ops/grid_ops.py::_engine_will_use``: inside a backward it tells
    whether the engine runs the table's node and x's, for the views of the
    table and of x that ``grid_encode`` hands the autograd functions (a
    leaf cannot be asked under ``autograd.grad``), the table asked first.
    The table's gradient is computed exactly when it is asked for, and
    then equals the plain one."""
    spec = tops.make_grid_spec(2, 3, 2, 8, 4, 1.5)
    gen = torch.Generator().manual_seed(18)
    leaf = torch.nn.Parameter(torch.rand(spec.n_params, generator=gen) * 2 - 1)
    table = leaf * 1.0   # a non-leaf table, as a policy's cast makes it
    x = torch.rand((64, 2), generator=gen).requires_grad_()
    seen = []
    real = tops._engine_will_use
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops, "_engine_will_use", lambda t: seen.append(real(t)) or seen[-1])
        y = tops.grid_encode(spec, table, x).sum()
        if ask == "x":
            torch.autograd.grad(y, x)
        elif ask == "table":
            (g,) = torch.autograd.grad(y, table)
        elif ask == "leaf":
            (g,) = torch.autograd.grad(y, leaf)
        elif ask == "both":
            _, g = torch.autograd.grad(y, [x, leaf])
        elif ask == "backward":
            y.backward()
            g = leaf.grad
        else:
            y.backward(inputs=[x])
    used = ask not in ("x", "backward_x")
    assert seen == [used, ask in ("x", "both", "backward", "backward_x")]
    if used:
        want = tgrid.grid_encode_bwd_plain(spec, table.detach(), x.detach(),
                                           torch.ones((spec.n_output_dims, 64)),
                                           list(range(spec.n_levels)))
        torch.testing.assert_close(g, want, rtol=0, atol=0)


def test_first_order_paths_run_no_second_order_kernel(monkeypatch):
    """A config_hash training step and a request reach none of GI, GG and
    RS (x needs no gradient), and one GB and one MB per step."""
    calls = _spy_plain(monkeypatch, ["grid_encode_bwd_plain", "fused_mlp_bwd_plain",
                                     "grid_encode_bwd_input_plain",
                                     "grid_encode_bwd_bwd_plain", "row_scatter_add_plain"])
    model = tcnn.create_from_config(2, 3, CONFIG_HASH, device="cpu")
    gen = torch.Generator().manual_seed(15)
    x, target = torch.rand((256, 2), generator=gen), torch.rand((256, 3), generator=gen)
    model.trainer.training_step(x, target)
    model.trainer.inference(x)
    assert calls == {"grid_encode_bwd_plain": 1, "fused_mlp_bwd_plain": 1,
                     "grid_encode_bwd_input_plain": 0, "grid_encode_bwd_bwd_plain": 0,
                     "row_scatter_add_plain": 0}

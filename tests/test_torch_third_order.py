"""Third derivatives of the port against the JAX package, on the CPU.

On the CPU the port's autograd functions run the plain versions of the
kernels (G, GB, GI, GG, GT, M, MB), so these tests hold those plain
versions, and the autograd structure around them, against JAX's autodiff:

  * a curvature loss, Σ (d/dx ⟨∂y/∂x, 1⟩)² at 8 points (a Hessian-vector
    product in x, as a curvature regulariser of an SDF fit uses),
    differentiated in the parameters of a HashGrid (4 levels × 2, 2^10
    rows, base 4, scale 1.5) into a FullyFusedMLP or an MLP (16 × 2,
    Softplus), Smoothstep and Linear;
  * ``torch.func.jvp`` of a Hessian-vector product in x (forward mode over
    two reverse passes) against ``jax.jvp``, and the gradient in the table
    of ``torch.func.hessian`` (reverse over forward over reverse);
  * kernel GT's plain version, each of its blocks, against JAX's autodiff
    of the jnp grid: with gi(T, x, δ) the grid's input gradient and
    S = ⟨∇_x ⟨gi, v⟩, β⟩, GT's (d_dcols, d_x, d_flat) are ∂S/∂(δ, x, T);
  * the derivative of a stochastic-interpolation table gradient in x;
  * the run planners of a FullyFusedMLP deeper than one launch of M or MB.

Tolerances, all fp32 (the fp32 policy): every gradient within 1e-5 of
its largest magnitude for the grid's (sums over corners, levels and
samples in another order, and the closed-form Smoothstep derivatives
6f(1 − f), 6 − 12f and −12 against JAX's autodiff of f·f·(3 − 2f)), 1e-4
for the MLP's weights (JAX's autodiff of jnp matmuls sums in yet another
order).  Inputs stay at least 1e-3 (in cells) from every level's cell
borders, where the weights are not differentiable.  The JAX side runs
under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
from tcnn_tpu.ops import grid_ops as jops
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.common import Activation
from tcnn_tpu_torch.ops import grid_ops as tops
from tcnn_tpu_torch.ops.cuda import fused_mlp as tfused
from tcnn_tpu_torch.ops.cuda import grid_encode as tgrid
from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
from tcnn_tpu_torch.utils.jax_params import load_jax_params

GRID = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10,
        "base_resolution": 4, "per_level_scale": 1.5}


def _net_cfg(otype, n_hidden=2):
    return {"otype": otype, "n_neurons": 16, "n_hidden_layers": n_hidden,
            "activation": "Softplus", "output_activation": "None"}


def _models(enc_cfg, net_cfg, table_seed=1):
    """JAX's and the port's NetworkWithInputEncoding with the same
    parameters (the grid U(±1) where ``table_seed`` is given)."""
    jnet = jtcnn.create_network_with_input_encoding(3, 1, enc_cfg, net_cfg, policy=jtcnn.Policy())
    params = jnet.init(jax.random.key(0))
    if table_seed is not None:
        shape = params["encoding"]["grid"].shape
        params["encoding"]["grid"] = jnp.asarray(
            np.random.default_rng(table_seed).uniform(-1, 1, shape).astype(np.float32))
    net = tcnn.create_network_with_input_encoding(3, 1, enc_cfg, net_cfg, policy=tcnn.Policy(),
                                                  device="cpu")
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, params))
    return jnet, params, net


def _coords(spec, n, seed, lo=0.05, hi=0.95):
    """n points at least 1e-3 of a cell from every level's cell borders."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (8 * n, spec.n_dims)).astype(np.float32)
    keep = np.ones(len(x), bool)
    for lv in spec.levels:
        pos = (x * np.float32(lv.scale)).astype(np.float32) + np.float32(0.5)
        frac = pos - np.floor(pos)
        keep &= ((frac > 1e-3) & (frac < 1 - 1e-3)).all(axis=1)
    assert keep.sum() >= n
    return x[keep][:n]


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in leaves}


def _assert_rel(got, want, rel, what=""):
    """max |got − want| <= rel · max |want|, and want not all zero."""
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(want).max() > 0, what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("otype", ["FullyFusedMLP", "MLP"])
@pytest.mark.parametrize("interp", ["Smoothstep", "Linear"])
def test_curvature_loss_parameter_gradients_equal_jax(otype, interp):
    enc_cfg = {**GRID, "interpolation": interp}
    jnet, params, net = _models(enc_cfg, _net_cfg(otype))
    x = _coords(net.encoding.spec, 8, 2)

    @jax.jit
    def jax_grads(p):
        def loss(p_):
            def gsum(xx):
                return jnp.sum(jax.grad(lambda z: jnp.sum(jnet.apply(p_, z)))(xx))
            return jnp.sum(jax.grad(gsum)(jnp.asarray(x)) ** 2)
        return jax.value_and_grad(loss)(p)

    want_loss, want = jax_grads(params)
    xt = torch.from_numpy(x).requires_grad_()
    (gx,) = torch.autograd.grad(net(xt).sum(), xt, create_graph=True)
    (hv,) = torch.autograd.grad(gx.sum(), xt, create_graph=True)
    loss = (hv ** 2).sum()
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = _flat(want)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        _assert_rel(g, want[n], 1e-5 if n == "encoding.grid" else 1e-4, n)


def _spy_input_gradients(monkeypatch):
    """Records the ``need_x`` that kernels GT and GG are called with (their
    plain versions on the CPU) and counts kernel GI's calls."""
    seen = {"GT": [], "GG": [], "GI": 0}
    for name, key in (("grid_encode_third", "GT"), ("grid_encode_bwd_bwd", "GG"),
                      ("grid_encode_bwd_input", "GI")):
        def spy(*a, _f=getattr(tgrid, name), _k=key, **k):
            if _k == "GI":
                seen["GI"] += 1
            else:
                seen[_k].append(k["need_x"])
            return _f(*a, **k)
        monkeypatch.setattr(tgrid, name, spy)
    return seen


@pytest.mark.parametrize("act", ["ReLU", "Softplus"])
def test_parameter_passes_ask_for_no_input_gradient(act, monkeypatch):
    """The parameter pass of the curvature step and of the eikonal step
    (``samples/fit_sdf_eikonal.py``: ``autograd.grad(loss, params)``) uses
    no gradient in x_vol, and the engine says so (``_engine_will_use`` on
    the view of x that ``grid_encode`` hands the functions): GT and GG are
    called with need_x False and GI is not called.  Asked for x's gradient
    as well (``autograd.grad(loss, [x, *params])``), every GT and GG call
    computes its d_x, and d loss / d x of the curvature step's loss in x
    (the eikonal term plus mean |H v|², weight 1 so that the third order
    counts) equals ``jax.grad``'s of the same loss within the MLP tolerance
    of ``test_curvature_loss_parameter_gradients_equal_jax``, 1e-4 of its
    largest magnitude (x's gradient sums the MLP's terms)."""
    net_cfg = {**_net_cfg("FullyFusedMLP"), "activation": act}
    jnet, params, net = _models({**GRID, "interpolation": "Smoothstep"}, net_cfg)
    seen = _spy_input_gradients(monkeypatch)
    spec = net.encoding.spec
    x, xs = (torch.from_numpy(_coords(spec, 8, s)) for s in (7, 9))
    v = np.random.default_rng(8).normal(size=(8, 3)).astype(np.float32)
    vt = torch.from_numpy(v)
    ps = list(net.parameters())
    for step, loss_fn in (("curvature", lambda: sdf.curvature_loss(net, xs, x, vt)),
                          ("eikonal", lambda: sdf.loss_fn(net, xs, x)[0])):
        loss = loss_fn()
        seen.update(GT=[], GG=[], GI=0)
        torch.autograd.grad(loss, ps)
        assert seen == {"GT": [False] if step == "curvature" else [],
                        "GG": [False] * len(seen["GG"]), "GI": 0}, (step, seen)
        assert seen["GG"], step

    @jax.jit
    def jax_dx(xx):
        def loss(z):
            def f(u):
                return jnp.sum(jnet.apply(params, u)[:, 0])
            gx = jax.grad(f)(z)
            eik = jnp.mean((jnp.sqrt(jnp.sum(gx * gx, axis=-1) + 1e-12) - 1.0) ** 2)
            hv = jax.grad(lambda w: jnp.sum(jax.grad(f)(w) * v))(z)
            return sdf.EIKONAL_WEIGHT * eik + jnp.mean(jnp.sum(hv * hv, axis=-1))
        return jax.grad(loss)(xx)

    xt = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(net(xt)[:, 0].sum(), xt, create_graph=True)
    (hv,) = torch.autograd.grad((gx * vt).sum(), xt, create_graph=True)
    loss = sdf.EIKONAL_WEIGHT * sdf.eikonal_loss(gx) + torch.mean(torch.sum(hv * hv, dim=-1))
    seen.update(GT=[], GG=[], GI=0)
    dx = torch.autograd.grad(loss, [xt, *ps])[0]
    assert seen["GT"] == [True] and seen["GG"] and all(seen["GG"]), seen
    assert seen["GI"] == (1 if act == "Softplus" else 0), seen
    _assert_rel(dx, jax_dx(jnp.asarray(x.numpy())), 1e-4, "d loss / d x")


@pytest.mark.parametrize("otype", ["FullyFusedMLP", "MLP"])
def test_jvp_of_the_hessian_vector_product_equals_jax(otype):
    """``torch.func.jvp`` (and ``jacfwd``, its vmap) of h(x) = ∇_x ⟨∇_x y,
    v⟩: forward mode through the grid's second order (GG's and GI's
    tangents, GT's blocks with β = t_x) and the MLP's (``torch.func.vjp``
    of the plain chain)."""
    jnet, params, net = _models({**GRID, "interpolation": "Smoothstep"}, _net_cfg(otype))
    rng = np.random.default_rng(3)
    x = _coords(net.encoding.spec, 6, 4)
    v, t = (rng.normal(size=x.shape).astype(np.float32) for _ in range(2))

    def jh(xx):
        return jax.grad(lambda z: jnp.sum(
            jax.grad(lambda w: jnp.sum(jnet.apply(params, w)))(z) * v))(xx)

    want_y, want_t = jax.jit(lambda a, b: jax.jvp(jh, (a,), (b,)))(jnp.asarray(x),
                                                                   jnp.asarray(t))
    pp = {n: p.detach() for n, p in net.named_parameters()}
    vt = torch.from_numpy(v)

    def f(z):
        return torch.func.functional_call(net, pp, (z,)).sum()

    def h(z):
        return torch.func.grad(lambda w: (torch.func.grad(f)(w) * vt).sum())(z)

    y, ty = torch.func.jvp(h, (torch.from_numpy(x),), (torch.from_numpy(t),))
    _assert_rel(y, want_y, 1e-5, "h")
    _assert_rel(ty, want_t, 1e-5, "jvp of h")
    jac = torch.func.jacfwd(h)(torch.from_numpy(x))
    want_jac = jax.jit(jax.jacfwd(jh))(jnp.asarray(x))
    _assert_rel(jac, want_jac, 1e-5, "jacfwd of h")


def test_grad_of_the_hessian_in_the_table_equals_jax():
    """Reverse mode over ``torch.func.hessian`` (forward over reverse) in x:
    the gradient in the table of the sum of the Hessian's entries, the
    backward of ``GridBwdBwdFunction`` under its own jvp, against JAX's."""
    jnet, params, net = _models({**GRID, "interpolation": "Smoothstep"},
                                _net_cfg("FullyFusedMLP"))
    x = _coords(net.encoding.spec, 3, 5)
    pp = {n: p.detach() for n, p in net.named_parameters()}

    def hsum(g):
        p2 = {**pp, "encoding.grid": g}
        return torch.func.hessian(
            lambda z: torch.func.functional_call(net, p2, (z,)).sum())(torch.from_numpy(x)).sum()

    @jax.jit
    def want_fn(g):
        def h(g_):
            p2 = {**params, "encoding": {"grid": g_}}
            return jnp.sum(jax.hessian(lambda z: jnp.sum(jnet.apply(p2, z)))(jnp.asarray(x)))
        return jax.grad(h)(g)

    got = torch.func.grad(hsum)(pp["encoding.grid"])
    _assert_rel(got, want_fn(params["encoding"]["grid"]), 1e-5, "d table of the Hessian")


# (n_dims, n_levels, F, log2_hashmap_size, base, per-level scale, grid type, interpolation)
GT_CASES = [
    (3, 3, 2, 9, 4, 1.5, "Hash", "Smoothstep"),
    (3, 3, 2, 8, 4, 1.5, "Hash", "Linear"),
    (3, 2, 4, 10, 4, 2.0, "Dense", "Smoothstep"),
    (2, 4, 1, 10, 4, 1.5, "Dense", "Linear"),
]


@pytest.mark.parametrize("case", GT_CASES, ids=lambda c: f"{c[0]}d-{c[6]}-{c[7]}-F{c[2]}")
@pytest.mark.parametrize("masked", [False, True])
def test_gt_blocks_equal_jax_autodiff(case, masked):
    D, L, F, hm, base, scale, gt, it = case
    jspec = jops.make_grid_spec(D, L, F, hm, base, scale, grid_type=jtcnn.GridType(gt),
                                interpolation=jtcnn.InterpolationType(it))
    spec = tops.make_grid_spec(D, L, F, hm, base, scale, grid_type=tcnn.GridType(gt),
                               interpolation=tcnn.InterpolationType(it))
    B = 40
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, spec.n_params).astype(np.float32)
    x = _coords(spec, B, 6)
    dcols = rng.normal(size=(L * F, B)).astype(np.float32)
    v, beta = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(2))
    frac = rng.uniform(0, 1, B).astype(np.float32) if masked else None
    kw = {} if frac is None else {"max_level_per_element": jnp.asarray(frac)}

    @jax.jit
    def jax_blocks(t, xx, dc):
        def gi(t_, x_, dc_):
            _, vjp = jax.vjp(lambda z: jops.grid_encode(jspec, t_, z, soa=True, **kw), x_)
            return vjp(dc_)[0]

        def s(t_, x_, dc_):
            dx = jax.grad(lambda z: jnp.sum(gi(t_, z, dc_) * v))(x_)
            return jnp.sum(dx * beta)
        return jax.grad(s, argnums=(0, 1, 2))(t, xx, dc)

    want_t, want_x, want_dc = jax_blocks(jnp.asarray(table), jnp.asarray(x), jnp.asarray(dcols))
    got = tgrid.grid_encode_third_plain(
        spec, torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(dcols),
        torch.from_numpy(v), torch.from_numpy(beta), list(range(L)),
        level_frac=None if frac is None else torch.from_numpy(frac))
    _assert_rel(got.d_dcols, want_dc, 1e-5, "d_dcols")
    _assert_rel(got.d_flat, want_t, 1e-5, "d_flat")
    if it == "Smoothstep" or D >= 3:
        _assert_rel(got.d_x, want_x, 1e-5, "d_x")
    else:   # Linear's third derivatives are the mixed ones of three dims
        assert float(got.d_x.abs().max()) == 0.0 and np.abs(np.asarray(want_x)).max() == 0.0


def test_stochastic_table_gradient_cotangent_equals_jax():
    """A loss on the table gradient of a grid with stochastic interpolation,
    Σ (∂y/∂grid)², differentiated in x (HashGrid 4 × 2, MLP 16 × 1,
    Softplus): the cotangent of GB's one-hot scatter gathered at the same
    corners (``StochasticGatherFunction``), nothing through the one-hot
    weights themselves (comparisons, JAX's ``ws_bwd``)."""
    enc_cfg = {**GRID, "stochastic_interpolation": True}
    jnet, params, net = _models(enc_cfg, _net_cfg("MLP", 1), table_seed=None)
    x = _coords(net.encoding.spec, 8, 2)

    @jax.jit
    def jax_grad(xx):
        def loss(z):
            g = jax.grad(lambda p: jnp.sum(jnet.apply(p, z)))(params)["encoding"]["grid"]
            return jnp.sum(g ** 2)
        return jax.grad(loss)(xx)

    want = jax_grad(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(net(xt).sum(), net.encoding.grid, create_graph=True)
    (gx,) = torch.autograd.grad((g ** 2).sum(), xt)
    _assert_rel(gx, want, 1e-5, "d x")


def test_fused_mlp_run_planners_at_depth_40():
    """A FullyFusedMLP 16 × 40 hidden layers, 41 layers: kernel M takes it
    in two launches of at most 32 layers (``m_runs``), and the chain of
    runs, each inner run ending on the hidden activation in the compute
    dtype, has the whole chain's bits (plain versions, both dtypes); MB's
    runs also keep within 32 layers (``mb_segments`` with ``mb_plan``'s
    bound on a run's length)."""
    assert tfused.m_runs(41) == [(0, 21), (21, 41)]
    assert tfused.m_runs(32) == [(0, 32)]
    assert tfused.m_runs(33) == [(0, 17), (17, 33)]
    assert tfused.m_runs(70) == [(0, 24), (24, 47), (47, 70)]
    assert tfused.mb_segments(41, lambda a, b: b - a <= tfused.MAX_LAYERS) == [(0, 21), (21, 41)]
    rng = np.random.default_rng(8)
    dims = [(8, 16)] + [(16, 16)] * 39 + [(16, 2)]
    ws = [torch.from_numpy((rng.uniform(-1, 1, d) * np.sqrt(6.0 / sum(d))).astype(np.float32))
          for d in dims]
    for cdt in (torch.float32, torch.bfloat16):
        for soa_in, soa_out in ((True, False), (False, True)):
            x = torch.from_numpy(rng.uniform(-1, 1, (8, 50) if soa_in else (50, 8))
                                 .astype(np.float32)).to(cdt)
            args = (Activation.RELU, Activation.NONE, cdt, torch.float32, soa_in, soa_out)
            want = tfused.fused_mlp_plain(ws, x, *args)
            got = tfused.fused_mlp_fwd_chained(ws, x, *args, tfused.m_runs(len(ws)),
                                               fwd=tfused.fused_mlp_plain)
            torch.testing.assert_close(got, want, rtol=0, atol=0)

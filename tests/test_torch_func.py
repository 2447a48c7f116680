"""``torch.func`` through the port's autograd functions, against JAX, on the CPU.

The grid's forward mode mirrors ``tests/test_grid.py::TestForwardMode``
(its spec: 2-D, 3 levels x 2, 2^6 rows, base 4, scale 1.6, Smoothstep),
here against JAX's own values: ``jacfwd`` against ``jacrev`` and against
``jax.jacfwd`` in the table and in x, the Hessian by ``jacfwd(grad)``
against JAX's, ``jvp`` against ``jax.jvp`` on both of JAX's routes, and
the refusal under stochastic interpolation.  Then a config_hash model at
a small size (4 levels, 2^10-row tables, the FullyFusedMLP 64 x 2 of the
config), the fp32 policy, the same parameters in both packages:
``torch.func.jvp``, ``jacfwd``, ``jacrev``, ``grad``, ``vmap`` and a Hessian
against ``jax.jvp``, ``jax.jacfwd``, ``jax.jacrev``, ``jax.grad`` and
``jax.hessian``.  On the CPU the functions run the kernels' plain versions;
the vmap rules fold a vmapped x into the batch or take a call per entry
(``ops/func_rules.py``), both held here.

Tolerances (fp32), those of ``tests/test_grid.py::TestForwardMode``:
jacfwd against jacrev rtol 1e-5 / atol 1e-6 in the table, 1e-4 / 1e-5 in
x; the Hessian rtol 1e-3 / atol 1e-4; jvp 1e-4 / 1e-5.  Against JAX, each
quantity within 1e-5 of its largest magnitude, 1e-4 for the Hessians
(sums over corners, levels and samples in another order, and the port's
closed-form Smoothstep derivatives against JAX's autodiff of
f·f·(3 − 2f)).  Inputs keep 1e-3 of a cell from every level's borders.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as jtcnn
from tcnn_tpu import common as jcommon
from tcnn_tpu.ops import grid_ops as jops
import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.common import Activation, InterpolationType
from tcnn_tpu_torch.ops import grid_ops as tops
from tcnn_tpu_torch.ops.cuda import fused_mlp as tfused
from tcnn_tpu_torch.utils.jax_params import load_jax_params

CONFIG_HASH = str(Path(__file__).resolve().parents[1] / "configs" / "config_hash.json")


def _coords(spec, n, seed):
    """n points in [0.05, 0.95]^D at least 1e-3 of a cell from every
    level's cell borders."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.95, (8 * n, spec.n_dims)).astype(np.float32)
    keep = np.ones(len(x), bool)
    for lv in spec.levels:
        frac = (x * np.float32(lv.scale)).astype(np.float32) + np.float32(0.5)
        frac = frac - np.floor(frac)
        keep &= ((frac > 1e-3) & (frac < 1 - 1e-3)).all(axis=1)
    return x[keep][:n]


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max()
    assert err <= rel * scale, (what, err, scale)


@pytest.fixture(scope="module")
def grid():
    """tests/test_grid.py::TestForwardMode's spec with a U(±1) table."""
    kw = dict(interpolation=InterpolationType.SMOOTHSTEP)
    spec = tops.make_grid_spec(2, 3, 2, 6, 4, 1.6, **kw)
    jspec = jops.make_grid_spec(2, 3, 2, 6, 4, 1.6,
                                interpolation=jcommon.InterpolationType.SMOOTHSTEP)
    table = np.random.default_rng(0).uniform(-1, 1, spec.n_params).astype(np.float32)
    x = _coords(spec, 8, 1)
    return spec, jspec, table, x


def test_jacfwd_matches_jacrev_table(grid):
    spec, jspec, table, x = grid
    xt = torch.from_numpy(x)
    f = lambda t: tops.grid_encode(spec, t, xt)
    jf = torch.func.jacfwd(f)(torch.from_numpy(table))
    jr = torch.func.jacrev(f)(torch.from_numpy(table))
    np.testing.assert_allclose(jf.numpy(), jr.numpy(), rtol=1e-5, atol=1e-6)
    want = jax.jacfwd(lambda t: jops.grid_encode(jspec, t, jnp.asarray(x),
                                                 fast_scatter=False))(jnp.asarray(table))
    _close(jf, want, 1e-5, "jacfwd in the table")


def test_jacfwd_matches_jacrev_input(grid):
    spec, jspec, table, x = grid
    tt = torch.from_numpy(table)
    f = lambda v: tops.grid_encode(spec, tt, v)
    jf = torch.func.jacfwd(f)(torch.from_numpy(x))
    jr = torch.func.jacrev(f)(torch.from_numpy(x))
    np.testing.assert_allclose(jf.numpy(), jr.numpy(), rtol=1e-4, atol=1e-5)
    want = jax.jacfwd(lambda v: jops.grid_encode(jspec, jnp.asarray(table), v,
                                                 fast_scatter=False))(jnp.asarray(x))
    _close(jf, want, 1e-5, "jacfwd in x")


@pytest.mark.parametrize("wrt", ["x", "table"])
def test_fwd_of_rev_second_order(grid, wrt):
    """The Hessian by jacfwd∘grad, forward over reverse: the tangents of
    GridEncodeBackwardFunction (kernels GB, GI, GG and RS forward), against
    JAX's jacfwd∘grad."""
    spec, jspec, table, x = grid
    if wrt == "x":
        tt = torch.from_numpy(table)
        h = torch.func.jacfwd(torch.func.grad(
            lambda v: (tops.grid_encode(spec, tt, v) ** 2).sum()))(torch.from_numpy(x))
        want = jax.jacfwd(jax.grad(lambda v: jnp.sum(jops.grid_encode(
            jspec, jnp.asarray(table), v, fast_scatter=False) ** 2)))(jnp.asarray(x))
    else:
        xt = torch.from_numpy(x)
        h = torch.func.jacfwd(torch.func.grad(
            lambda t: (tops.grid_encode(spec, t, xt) ** 2).sum()))(torch.from_numpy(table))
        want = jax.jacfwd(jax.grad(lambda t: jnp.sum(jops.grid_encode(
            jspec, t, jnp.asarray(x), fast_scatter=False) ** 2)))(jnp.asarray(table))
    _close(h, want, 1e-4, f"Hessian in {wrt}")


@pytest.mark.parametrize("fast", [False, True])
def test_fast_path_jvp_falls_back(grid, fast):
    """jvp in the table and in x at once against ``jax.jvp`` on JAX's plain
    path and on its fast path (which falls back to jnp under a forward-mode
    trace)."""
    spec, jspec, table, x = grid
    rng = np.random.default_rng(2)
    vt = rng.normal(size=table.shape).astype(np.float32)
    vx = rng.normal(size=x.shape).astype(np.float32)
    y, t = torch.func.jvp(lambda a, b: tops.grid_encode(spec, a, b),
                          (torch.from_numpy(table), torch.from_numpy(x)),
                          (torch.from_numpy(vt), torch.from_numpy(vx)))
    jy, jt = jax.jvp(lambda a, b: jops.grid_encode(jspec, a, b, fast_scatter=fast),
                     (jnp.asarray(table), jnp.asarray(x)), (jnp.asarray(vt), jnp.asarray(vx)))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)


def test_stochastic_stays_reverse_only(grid):
    spec, jspec, table, x = grid
    sspec = dataclasses.replace(spec, stochastic_interpolation=True)
    t = torch.from_numpy(table)
    with pytest.raises(NotImplementedError, match="reverse-only"):
        torch.func.jvp(lambda a: tops.grid_encode(sspec, a, torch.from_numpy(x)), (t,), (t,))
    # reverse mode runs
    g = torch.func.grad(lambda a: tops.grid_encode(sspec, a, torch.from_numpy(x)).sum())(t)
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("soa", [False, True])
def test_vmap_folds_x_and_loops_over_tables(grid, soa):
    """A vmapped x goes through one call over V·B samples, a vmapped table
    through a call per entry; both equal the calls one by one."""
    spec, _, table, x = grid
    xs = torch.from_numpy(np.stack([x, x[::-1].copy(), 1 - x]))
    tt = torch.from_numpy(table)
    got = torch.func.vmap(lambda v: tops.grid_encode(spec, tt, v, soa=soa))(xs)
    for i in range(3):
        torch.testing.assert_close(got[i], tops.grid_encode(spec, tt, xs[i], soa=soa),
                                   rtol=0, atol=0)
    ts = torch.stack([tt, 2 * tt])
    got = torch.func.vmap(lambda t: tops.grid_encode(spec, t, xs[0], soa=soa))(ts)
    for i in range(2):
        torch.testing.assert_close(got[i], tops.grid_encode(spec, ts[i], xs[0], soa=soa),
                                   rtol=0, atol=0)


# --- the whole config_hash model, small --------------------------------------

SMALL_HASH = {"encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                           "log2_hashmap_size": 10, "base_resolution": 16,
                           "per_level_scale": 1.5},
              "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                          "output_activation": "None", "n_neurons": 64,
                          "n_hidden_layers": 2}}


@pytest.fixture(scope="module")
def model():
    """config_hash's structure, small, at the fp32 policy: JAX's network and
    params and the port's network holding them (the grid U(±1))."""
    import json
    import re

    cfg = json.loads(re.sub(r"//[^\n]*", "", Path(CONFIG_HASH).read_text()))
    cfg = {**cfg, "encoding": SMALL_HASH["encoding"], "network": SMALL_HASH["network"]}
    jmodel = jtcnn.create_from_config(2, 3, cfg, policy=jtcnn.Policy())
    params = jmodel.network.init(jax.random.key(0))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["encoding"]["grid"] = rng.uniform(
        -1, 1, params["encoding"]["grid"].shape).astype(np.float32)
    tmodel = tcnn.create_from_config(2, 3, cfg, policy=tcnn.Policy(), device="cpu")
    load_jax_params(tmodel, params)
    spec = tmodel.network.encoding.spec
    x = _coords(spec, 16, 5)
    return jmodel.network, jax.tree_util.tree_map(jnp.asarray, params), tmodel.network, x


def _functional(net):
    names = [n for n, _ in net.named_parameters()]
    return names, lambda vals, v: torch.func.functional_call(net, dict(zip(names, vals)), (v,))


def _jax_leaves(params, names):
    out = []
    for n in names:
        node = params
        for part in n.split("."):
            node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
        out.append(node)
    return out


def test_model_jvp_equals_jax(model):
    jnet, params, net, x = model
    names, f = _functional(net)
    vals = [p.detach() for p in net.parameters()]
    rng = np.random.default_rng(6)
    tv = [torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)) for v in vals]
    tx = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    y, t = torch.func.jvp(lambda vs, v: f(vs, v), (vals, torch.from_numpy(x)), (tv, tx))

    leaves = _jax_leaves(params, names)

    def jf(ls, v):
        p = jax.tree_util.tree_map(lambda a: a, params)
        for n, leaf in zip(names, ls):
            node = p
            parts = n.split(".")
            for part in parts[:-1]:
                node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
            if isinstance(node, list):
                node[int(parts[-1])] = leaf
            else:
                node[parts[-1]] = leaf
        return jnet.apply(p, v)

    jy, jt = jax.jvp(jf, (leaves, jnp.asarray(x)),
                     ([jnp.asarray(v.numpy()) for v in tv], jnp.asarray(tx.numpy())))
    _close(y, jy, 1e-5, "output")
    _close(t, jt, 1e-5, "tangent")


def test_model_jacobians_equal_jax(model):
    """jacfwd and jacrev in x (the input Jacobian of every output), and
    jacrev in the table and in the first layer, against JAX's."""
    jnet, params, net, x = model
    xt = torch.from_numpy(x)
    want = jax.jacrev(lambda v: jnet.apply(params, v))(jnp.asarray(x))
    _close(torch.func.jacrev(net)(xt), want, 1e-5, "jacrev in x")
    _close(torch.func.jacfwd(net)(xt), want, 1e-5, "jacfwd in x")
    names, f = _functional(net)
    vals = [p.detach() for p in net.parameters()]
    for i, name in enumerate(names):
        if name not in ("encoding.grid", "network.layers.0"):
            continue

        def fi(leaf, i=i):
            return f(vals[:i] + [leaf] + vals[i + 1:], xt)

        def jfi(leaf, name=name):
            p = jax.tree_util.tree_map(lambda a: a, params)
            if name == "encoding.grid":
                p["encoding"]["grid"] = leaf
            else:
                p["network"]["layers"] = [leaf] + list(p["network"]["layers"][1:])
            return jnet.apply(p, jnp.asarray(x))

        want = jax.jacrev(jfi)(_jax_leaves(params, [name])[0])
        _close(torch.func.jacrev(fi)(vals[i]), want, 1e-5, f"jacrev in {name}")


def test_model_grad_and_vmap_equal_jax(model):
    jnet, params, net, x = model
    names, f = _functional(net)
    vals = [p.detach() for p in net.parameters()]
    xt = torch.from_numpy(x)
    grads = torch.func.grad(lambda vs: (f(vs, xt) ** 2).sum())(vals)
    want = jax.grad(lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x)) ** 2))(params)
    for name, g, w in zip(names, grads, _jax_leaves(want, names)):
        _close(g, w, 1e-5, f"grad {name}")
    xs = xt.reshape(4, 4, 2)
    got = torch.func.vmap(net)(xs)
    _close(got.reshape(16, 3), jnet.apply(params, jnp.asarray(x)), 1e-5, "vmap")
    # per-sample gradients in the parameters: a call per sample (dW sums)
    per = torch.func.vmap(torch.func.grad(lambda vs, v: (f(vs, v[None]) ** 2).sum()),
                          in_dims=(None, 0))(vals, xt[:3])
    for i in range(3):
        one = torch.func.grad(lambda vs: (f(vs, xt[i:i + 1]) ** 2).sum())(vals)
        for a, b in zip(per, one):
            torch.testing.assert_close(a[i], b, rtol=1e-6, atol=1e-7)


def test_model_hessian_in_x_equals_jax(model):
    """jacfwd∘grad of the model in x: FusedMLPBackwardFunction's jvp (MB on
    t_g, the plain tangent's gradient) and the grid's, against jax.hessian."""
    jnet, params, net, x = model
    x4 = x[:4]
    h = torch.func.jacfwd(torch.func.grad(lambda v: (net(v) ** 2).sum()))(torch.from_numpy(x4))
    want = jax.hessian(lambda v: jnp.sum(jnet.apply(params, v) ** 2))(jnp.asarray(x4))
    _close(h, want, 1e-4, "Hessian in x")


# --- kernel MB beyond one tile's shared memory --------------------------------

def test_mb_segments_split_evenly_into_runs_that_fit():
    assert tfused.mb_segments(6, lambda a, b: True) == [(0, 6)]
    assert tfused.mb_segments(13, lambda a, b: b - a <= 11) == [(0, 7), (7, 13)]
    assert tfused.mb_segments(13, lambda a, b: b - a <= 5) == [(0, 5), (5, 9), (9, 13)]
    with pytest.raises(NotImplementedError):
        tfused.mb_segments(5, lambda a, b: b - a < 2)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("soa_in,soa_out", [(True, False), (False, True)])
def test_segmented_mb_equals_the_whole_chain(cdt, soa_in, soa_out):
    """The MLP backward as runs of layers (M at the boundaries, MB per run
    from the last, dx between runs in fp32) equals the whole chain's
    backward bit for bit, in the plain versions: 128 wide, 12 hidden
    layers, the shape kernel MB takes only so."""
    rng = np.random.default_rng(7)
    dims = [(32, 128)] + [(128, 128)] * 11 + [(128, 3)]
    ws = [torch.from_numpy((rng.uniform(-1, 1, d) * np.sqrt(6.0 / sum(d))).astype(np.float32))
          for d in dims]
    x = torch.from_numpy(rng.uniform(-1, 1, (32, 300) if soa_in else (300, 32))
                         .astype(np.float32)).to(cdt)
    g = torch.from_numpy(rng.normal(size=(3, 300) if soa_out else (300, 3)).astype(np.float32))
    args = (Activation.RELU, Activation.NONE, cdt, soa_in, soa_out)
    want_dws, want_dx = tfused.fused_mlp_bwd_plain(ws, x, g, *args)
    for segs in ([(0, 7), (7, 13)], [(0, 4), (4, 8), (8, 13)]):
        dws, dx = tfused.fused_mlp_bwd_segmented(ws, x, g, *args, segs,
                                                 fwd=tfused.fused_mlp_plain,
                                                 bwd=tfused.fused_mlp_bwd_plain)
        assert dx.dtype == x.dtype and dx.shape == x.shape
        torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
        for a, b in zip(dws, want_dws):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

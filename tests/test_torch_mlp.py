"""The port's MLP and FusedMLP against the JAX package, on the CPU.

Inputs and weights come from numpy with a seed; both packages get the
same ones.  FusedMLP is held against the JAX package's Pallas kernel
``fused_mlp_apply`` (interpret mode) and its plain chain
``_jnp_mlp_ref``.  Tolerances:
  * fp32 compute: rtol 1e-5, atol 1e-6 (sums in another order).
  * bf16 compute: rtol 2e-2, atol 2e-3.  Each hidden activation is
    rounded to bf16 (2^-8 relative); with the sums taken in another
    order, a rounding may fall to the other neighbour at every layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnn_tpu import common as jcommon
from tcnn_tpu.ops import activations as jact
from tcnn_tpu.ops.pallas import fused_mlp as jfused
from tcnn_tpu_torch import FusedMLP, MLP, create_network
from tcnn_tpu_torch.common import BF16_POLICY, Activation
from tcnn_tpu_torch.ops.activations import apply_activation
from tcnn_tpu_torch.ops.cuda import fused_mlp as tfused
from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_fwd
from tcnn_tpu_torch.tools import kernel_ablation

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-3)}


def _weights(dims, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, d) * np.sqrt(6.0 / sum(d))).astype(np.float32)
            for d in dims]


@pytest.mark.parametrize("act", list(Activation), ids=lambda a: a.value)
def test_activations_equal_jax(act):
    x = np.random.default_rng(0).uniform(-3, 3, 1001).astype(np.float32)
    want = jact.apply_activation(jnp.asarray(x), jcommon.Activation(act.value))
    got = apply_activation(torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("soa_in,soa_out", [(True, False), (False, True), (True, True)])
def test_fused_mlp_equals_jax_kernel_and_plain_chain(width, dtype, soa_in, soa_out):
    dims = [(32, width), (width, width), (width, 3)]
    ws = _weights(dims, width)
    x = np.random.default_rng(1).uniform(-1, 1, (300, 32)).astype(np.float32)
    xin = x.T.copy() if soa_in else x
    kw = dict(compute_dtype=getattr(jnp, dtype), output_dtype=jnp.float32)
    jws = [jnp.asarray(w) for w in ws]
    want_kernel = jfused.fused_mlp_apply(
        jws, jnp.asarray(xin), activation=jcommon.Activation.RELU,
        output_activation=jcommon.Activation.NONE, input_soa=soa_in,
        output_soa=soa_out, **kw)
    want_plain = jfused._jnp_mlp_ref(
        jws, jnp.asarray(xin), jcommon.Activation.RELU, jcommon.Activation.NONE,
        kw["compute_dtype"], kw["output_dtype"], soa_in, soa_out)

    got = fused_mlp_fwd([torch.from_numpy(w) for w in ws], torch.from_numpy(xin),
                        Activation.RELU, Activation.NONE,
                        compute_dtype=getattr(torch, dtype),
                        output_dtype=torch.float32, input_soa=soa_in,
                        output_soa=soa_out)
    assert got.shape == ((3, 300) if soa_out else (300, 3))
    for want in (want_kernel, want_plain):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("out_act", [Activation.NONE, Activation.SIGMOID, Activation.SOFTPLUS])
def test_fused_mlp_module_deep_chain_equals_jax(out_act):
    net = FusedMLP(n_input_dims=16, n_output_dims=5, n_neurons=32,
                   n_hidden_layers=4, activation=Activation.LEAKY_RELU,
                   output_activation=out_act, device="cpu")
    ws = _weights([tuple(p.shape) for p in net.layers], 2)
    with torch.no_grad():
        for p, w in zip(net.layers, ws):
            p.copy_(torch.from_numpy(w))
    x = np.random.default_rng(3).uniform(-1, 1, (200, 16)).astype(np.float32)
    want = jfused._jnp_mlp_ref([jnp.asarray(w) for w in ws], jnp.asarray(x),
                               jcommon.Activation.LEAKY_RELU,
                               jcommon.Activation(out_act.value),
                               jnp.float32, jnp.float32, False)
    got = net.inference(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL["float32"])


def test_width_restriction():
    with pytest.raises(ValueError, match="widths"):
        FusedMLP(n_input_dims=4, n_output_dims=4, n_neurons=48, n_hidden_layers=2,
                 device="cpu")


def test_layer_shapes_and_names_follow_jax_layout():
    net = create_network({"otype": "FullyFusedMLP", "n_neurons": 64,
                          "n_hidden_layers": 2}, 32, 3, device="cpu")
    assert [tuple(p.shape) for p in net.layers] == [(32, 64), (64, 64), (64, 3)]
    assert [n for n, _ in net.named_parameters()] == [
        "layers.0", "layers.1", "layers.2"]
    assert net.hyperparams()["otype"] == "FullyFusedMLP"
    mlp = MLP(n_input_dims=10, n_output_dims=7, n_neurons=32, n_hidden_layers=3,
              device="cpu")
    assert [tuple(p.shape) for p in mlp.layers] == [(10, 32), (32, 32), (32, 32), (32, 7)]


def test_zero_hidden_layers_is_a_single_matmul():
    net = FusedMLP(n_input_dims=4, n_output_dims=2, n_neurons=16, n_hidden_layers=0,
                   device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 4)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(net(x).numpy(), (x @ net.layers[0]).numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(net(x.t(), input_soa=True, output_soa=True).numpy(),
                                   (x @ net.layers[0]).t().numpy(), rtol=1e-6, atol=1e-6)


def test_xavier_and_siren_init_ranges():
    g = torch.Generator().manual_seed(0)
    mlp = MLP(n_input_dims=64, n_output_dims=64, n_neurons=64, n_hidden_layers=2,
              generator=g, device="cpu")
    bound = np.sqrt(6.0 / 128.0)
    w = mlp.layers[1].detach().abs()
    assert w.max() <= bound + 1e-6 and w.max() > bound * 0.8
    siren = MLP(n_input_dims=2, n_output_dims=1, n_neurons=64, n_hidden_layers=2,
                activation=Activation.SINE, device="cpu")
    assert siren.layers[0].detach().abs().max() <= 30.0 / 2 + 1e-5
    assert siren.layers[1].detach().abs().max() <= np.sqrt(6.0 / 64) + 1e-6


def test_bf16_policy_rounds_between_layers():
    """The bf16 chain rounds every hidden activation: it differs from the
    fp32 chain by far more than fp32 rounding, and equals JAX's bf16 chain."""
    dims = [(32, 64), (64, 64), (64, 3)]
    ws = _weights(dims, 5)
    x = np.random.default_rng(6).uniform(-1, 1, (256, 32)).astype(np.float32)
    net = FusedMLP(n_input_dims=32, n_output_dims=3, n_neurons=64, n_hidden_layers=2,
                   policy=BF16_POLICY, device="cpu")
    with torch.no_grad():
        for p, w in zip(net.layers, ws):
            p.copy_(torch.from_numpy(w))
        got = net(torch.from_numpy(x)).numpy()
    f32 = np.maximum(np.maximum(x @ ws[0], 0) @ ws[1], 0) @ ws[2]
    assert np.abs(got - f32).max() > 1e-4
    want = jfused._jnp_mlp_ref([jnp.asarray(w) for w in ws], jnp.asarray(x),
                               jcommon.Activation.RELU, jcommon.Activation.NONE,
                               jnp.bfloat16, jnp.float32, False)
    np.testing.assert_allclose(got, np.asarray(want), **TOL["bfloat16"])


def test_kernel_ablation_step_order_alternates():
    """``kernel_ablation --steps`` runs the two checkouts in pairs that
    alternate which one runs first, so that neither always follows the
    other."""
    assert kernel_ablation.step_order(4) == ["baseline", "tree", "tree", "baseline"] * 2


@pytest.mark.parametrize("name", sorted(kernel_ablation.ABLATIONS))
def test_kernel_ablations_patch_the_current_sources(tmp_path, name):
    """Each ablation of tools/kernel_ablation.py finds its text in the
    kernel sources (its copy raises otherwise): the tool stays runnable
    on the card as the kernels change."""
    patches = kernel_ablation.ABLATIONS[name]
    root = kernel_ablation._copy(tmp_path, name, patches)
    for fname, old, new in patches:
        text = (root / "tcnn_tpu_torch" / "csrc" / fname).read_text()
        assert old not in text or old in new, (name, fname)


# -- wide inputs: the first layer alone, streamed in chunks of its inputs ------

@pytest.mark.parametrize("d_in", [256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_at_wide_inputs_equals_jax(d_in, dtype):
    """A FullyFusedMLP 128 × 2 at 256 and 512 inputs (past kernel M's or
    MB's shared memory on the card, where the first layer runs alone through
    the streamed-layer instances; here the plain versions) against JAX at
    every order the port computes: the forward against ``_jnp_mlp_ref``,
    dW and dx (``FusedMLPBackwardFunction``, kernel MB's plain version)
    against ``_fused_mlp_bwd_op``, and their gradients in x, g and W (the
    second order) against its VJP.  fp32: 1e-5 of each largest magnitude
    (1e-4 for the second order, autodiff of jnp matmuls on the JAX side);
    bf16: the MLP tolerances above, 2e-2 of each largest magnitude for the
    gradients (a dz may round to the other bf16 neighbour)."""
    dims = [(d_in, 128), (128, 128), (128, 3)]
    ws = _weights(dims, d_in)
    rng = np.random.default_rng(d_in + 1)
    B = 200
    x = rng.uniform(-1, 1, (d_in, B)).astype(np.float32)   # SoA, the grid's layout
    g = rng.normal(size=(B, 3)).astype(np.float32)
    ct_dx = rng.normal(size=x.shape).astype(np.float32)
    ct_ws = [rng.normal(size=d).astype(np.float32) for d in dims]
    relu, none = jcommon.Activation.RELU, jcommon.Activation.NONE
    jcdt, cdt = getattr(jnp, dtype), getattr(torch, dtype)
    jws = tuple(jnp.asarray(w) for w in ws)
    want_y = jfused._jnp_mlp_ref(list(jws), jnp.asarray(x), relu, none, jcdt, jnp.float32,
                                 True, False)

    @jax.jit
    def bwd_and_vjp(w, x_, g_, cts):
        out, vjp = jax.vjp(lambda w_, xx, gg: jfused._fused_mlp_bwd_op(
            w_, xx, gg, relu, none, jcdt, jnp.float32, True, False), w, x_, g_)
        return out, vjp(cts)

    (jdws, jdx), (w_want, x_want, g_want) = bwd_and_vjp(
        jws, jnp.asarray(x), jnp.asarray(g),
        (tuple(jnp.asarray(c) for c in ct_ws), jnp.asarray(ct_dx)))
    tws = [torch.from_numpy(w) for w in ws]
    y = fused_mlp_fwd(tws, torch.from_numpy(x), Activation.RELU, Activation.NONE, cdt,
                      torch.float32, True, False)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL[dtype])
    rel1, rel2 = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    wt = [w.clone().requires_grad_() for w in tws]
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    dx, *dws = tfused.FusedMLPBackwardFunction.apply(
        xt, gt, Activation.RELU, Activation.NONE, cdt, torch.float32, True, False, *wt)
    grads = torch.autograd.grad([dx, *dws], [xt, gt, *wt],
                                grad_outputs=[torch.from_numpy(ct_dx)]
                                + [torch.from_numpy(c) for c in ct_ws])
    for what, got, want, rel in [("dx", dx, jdx, rel1)] + [
            (f"dW{i}", a, b, rel1) for i, (a, b) in enumerate(zip(dws, jdws))] + [
            ("d x", grads[0], x_want, rel2), ("d g", grads[1], g_want, rel2)] + [
            (f"d W{i}", a, b, rel2) for i, (a, b) in enumerate(zip(grads[2:], w_want))]:
        got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape and np.abs(want).max() > 0, what
        assert np.abs(got - want).max() <= rel * np.abs(want).max(), what


def test_plan_runs_put_a_wide_first_or_last_layer_alone():
    """``plan_runs`` keeps ``mb_segments``' runs wherever some fit (every
    shape the fused kernels took keeps its launches), and otherwise puts the
    first layer, the last or both in runs of their own (the streamed-layer
    instances), the layers between in runs of two or more, or alone where
    one is left, each run of at most ``MAX_LAYERS`` layers."""
    assert tfused.plan_runs(3, lambda a, b: True) == [(0, 3)]
    assert tfused.plan_runs(13, lambda a, b: b - a <= 7) == [(0, 7), (7, 13)]
    assert tfused.plan_runs(3, lambda a, b: a > 0) == [(0, 1), (1, 3)]
    assert tfused.plan_runs(2, lambda a, b: False) == [(0, 1), (1, 2)]
    assert tfused.plan_runs(4, lambda a, b: b < 4) == [(0, 3), (3, 4)]
    assert tfused.plan_runs(3, lambda a, b: b < 3) == [(0, 2), (2, 3)]   # a 600-wide output
    assert tfused.plan_runs(5, lambda a, b: 0 < a and b < 5) == [(0, 1), (1, 4), (4, 5)]
    assert tfused.plan_runs(14, lambda a, b: a > 0 and b - a <= 7) == [(0, 1), (1, 8), (8, 14)]
    assert tfused.plan_runs(40, lambda a, b: a > 0) == [(0, 1), (1, 21), (21, 40)]
    with pytest.raises(NotImplementedError):
        tfused.plan_runs(4, lambda a, b: b - a < 2)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("runs", [[(0, 1), (1, 3)], [(0, 1), (1, 2), (2, 3)]], ids=str)
def test_a_first_layer_alone_keeps_the_chains_bits(cdt, runs):
    """The MLP at 512 inputs with its first layer in a run of its own (the
    streamed-layer instances' plain versions: ``fused_mlp_wide_fwd`` and
    ``_bwd`` take the CPU's) equals the whole chain bit for bit, forward
    and backward: the run's output is the hidden activation in the compute
    dtype, its dx the next run's input gradient in fp32, as one launch
    holds them."""
    dims = [(512, 64), (64, 64), (64, 3)]
    ws = [torch.from_numpy(w) for w in _weights(dims, 9)]
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.uniform(-1, 1, (512, 150)).astype(np.float32)).to(cdt)
    g = torch.from_numpy(rng.normal(size=(150, 3)).astype(np.float32))
    args = (Activation.RELU, Activation.NONE, cdt)
    want_y = tfused.fused_mlp_plain(ws, x, *args, torch.float32, True, False)
    got_y = tfused.fused_mlp_fwd_chained(ws, x, *args, torch.float32, True, False, runs)
    assert torch.equal(got_y, want_y)
    want_dws, want_dx = tfused.fused_mlp_bwd_plain(ws, x, g, *args, True, False)
    dws, dx = tfused.fused_mlp_bwd_segmented(ws, x, g, *args, True, False, runs)
    assert torch.equal(dx, want_dx) and dx.dtype == x.dtype
    assert all(torch.equal(a, b) for a, b in zip(dws, want_dws))


# -- wide outputs: the last layer alone, its columns in blocks (MW, MBW) -------

@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_fused_mlp_with_600_outputs_equals_jax(policy):
    """A FullyFusedMLP 32 -> 128 x 2 -> 600, wider than kernels M's and MB's
    layouts hold (on the card its last layer runs alone through MW and MBW;
    here the plain versions), against the JAX package's ``FusedMLP`` on its
    Pallas kernels in interpret mode (``use_pallas=True``), which take any
    output width: the forward at the MLP tolerances above, the weight and
    input gradients of ⟨y, c⟩ (c ~ N(0, 1)) within 1e-5 (fp32) or 2e-2
    (bf16) of each gradient's largest magnitude."""
    from tcnn_tpu.models.networks.fused_mlp import FusedMLP as JFusedMLP
    from tcnn_tpu_torch.common import DEFAULT_POLICY

    dims = [(32, 128), (128, 128), (128, 600)]
    ws = _weights(dims, 600)
    rng = np.random.default_rng(601)
    x = rng.uniform(-1, 1, (300, 32)).astype(np.float32)
    ct = rng.normal(size=(300, 600)).astype(np.float32)
    bf16 = policy == "bfloat16"
    jnet = JFusedMLP(n_input_dims=32, n_output_dims=600, n_neurons=128, n_hidden_layers=2,
                     policy=jcommon.BF16_POLICY if bf16 else jcommon.DEFAULT_POLICY,
                     use_pallas=True)
    params = {"layers": [jnp.asarray(w) for w in ws]}

    @jax.jit
    def fwd_and_grads(p, xx):
        def loss(p_, x_):
            return jnp.sum(jnet.apply(p_, x_).astype(jnp.float32) * ct)
        return jnet.apply(p, xx), jax.grad(loss, argnums=(0, 1))(p, xx)

    want_y, (want_p, want_x) = fwd_and_grads(params, jnp.asarray(x))
    # a generator of its own: the weights are JAX's, and the global one stays as it was
    net = FusedMLP(n_input_dims=32, n_output_dims=600, n_neurons=128, n_hidden_layers=2,
                   policy=BF16_POLICY if bf16 else DEFAULT_POLICY,
                   generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for p, w in zip(net.layers, ws):
            p.copy_(torch.from_numpy(w))
    xt = torch.from_numpy(x).requires_grad_()
    y = net(xt)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(want_y, np.float32),
                               **TOL[policy])
    rel = 2e-2 if bf16 else 1e-5
    for what, got, want in [("dx", xt.grad, want_x)] + [
            (f"dW{i}", p.grad, w) for i, (p, w) in enumerate(zip(net.layers,
                                                                 want_p["layers"]))]:
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape and np.abs(want).max() > 0, what
        assert np.abs(got - want).max() <= rel * np.abs(want).max(), what


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("runs", [[(0, 2), (2, 3)], [(0, 1), (1, 2), (2, 3)]], ids=str)
def test_a_last_layer_alone_keeps_the_chains_bits(cdt, runs):
    """The MLP 32 -> 128 x 2 -> 600 with its last layer in a run of its own
    (``plan_runs``' tail, which MW and MBW take on the card), with the plain
    versions passed as each run's forward and backward, equals the whole
    chain bit for bit, forward and backward: the run before it ends on the
    hidden activation in the compute dtype, and its dx is that run's output
    gradient in fp32, as one launch holds them."""
    dims = [(32, 128), (128, 128), (128, 600)]
    ws = [torch.from_numpy(w) for w in _weights(dims, 11)]
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.uniform(-1, 1, (150, 32)).astype(np.float32)).to(cdt)
    g = torch.from_numpy(rng.normal(size=(150, 600)).astype(np.float32))
    args = (Activation.RELU, Activation.NONE, cdt)
    plain_fwd, plain_bwd = tfused.fused_mlp_plain, tfused.fused_mlp_bwd_plain
    want_y = tfused.fused_mlp_plain(ws, x, *args, torch.float32, False, False)
    got_y = tfused.fused_mlp_fwd_chained(ws, x, *args, torch.float32, False, False, runs,
                                         fwd=plain_fwd)
    assert torch.equal(got_y, want_y)
    want_dws, want_dx = tfused.fused_mlp_bwd_plain(ws, x, g, *args, False, False)
    dws, dx = tfused.fused_mlp_bwd_segmented(ws, x, g, *args, False, False, runs,
                                             fwd=plain_fwd, bwd=plain_bwd)
    assert torch.equal(dx, want_dx) and dx.dtype == x.dtype
    assert all(torch.equal(a, b) for a, b in zip(dws, want_dws))


def _mbw_replay(w, x, g, cdt, soa_in, rows, bn=128):
    """Kernel MBW's sums (``csrc/fused_mlp_wide.cu``) for a layer without an
    activation, in PyTorch: z per block of ``bn`` columns, the sum over K in
    stages of 64 (bf16) or 32 (fp32) inputs in order; dz = g rounded once
    to the compute dtype, ``pad8(N)`` columns with zeros past N; dx = dz Wᵀ
    per block of ``bn`` of its K columns, the sum over N in stages in order;
    dW as each range of ``rows`` samples' partial (a sum over the range in
    stages), the partials added in range order.  Returns (z, dW, dx)."""
    bk = 64 if cdt == torch.bfloat16 else 32
    K, N = w.shape
    xs = (x.t() if soa_in else x).to(cdt).float()
    B, ldz = xs.shape[0], -(-N // 8) * 8
    wp = torch.zeros(K, ldz)
    wp[:, :N] = w.to(cdt).float()
    z = torch.zeros(B, ldz)
    for n0 in range(0, ldz, bn):
        for k0 in range(0, K, bk):
            z[:, n0:n0 + bn] += xs[:, k0:k0 + bk] @ wp[k0:k0 + bk, n0:n0 + bn]
    dz = torch.zeros(B, ldz)
    dz[:, :N] = g.to(cdt).float()
    dx = torch.zeros(B, K)
    for k0 in range(0, K, bn):
        for s0 in range(0, ldz, bk):
            dx[:, k0:k0 + bn] += dz[:, s0:s0 + bk] @ wp[k0:k0 + bn, s0:s0 + bk].t()
    dw = torch.zeros(K, N)
    for r0 in range(0, B, rows):
        part = torch.zeros(K, ldz)
        for s0 in range(r0, min(B, r0 + rows), bk):
            s1 = min(s0 + bk, r0 + rows, B)
            part += xs[s0:s1].t() @ dz[s0:s1]
        dw += part[:, :N]
    return z[:, :N], dw, (dx.t() if soa_in else dx)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("soa_in", [True, False])
@pytest.mark.parametrize("n,rows", [(129, 64), (600, 96), (600, 300)])
def test_mbw_sums_emulated_equal_plain(cdt, soa_in, n, rows):
    """MBW's sum structure replayed on the CPU (``_mbw_replay``: column
    blocks, dz rounded once, the batch ranges' partial dW summed in range
    order, dx over N in stages) against ``fused_mlp_bwd_plain`` of the layer
    and its z against the plain product: each within the bound of two fp32
    sums of the same n terms in two orders, 2(n - 1)·2^-24·Σ|terms| per
    element (n = K for z, N for dx, B for dW).  N = 129 and 600 are ragged
    against a block of 128; the ranges cut the batch of 300 unevenly."""
    rng = np.random.default_rng(n + rows)
    K, B = 96, 300
    w = torch.from_numpy((rng.uniform(-1, 1, (K, n)) * np.sqrt(6 / (K + n))).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (B, K)).astype(np.float32))
    x = (x.t().contiguous() if soa_in else x).to(cdt)
    g = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32))
    z, dw, dx = _mbw_replay(w, x, g, cdt, soa_in, rows)
    want_dws, want_dx = tfused.fused_mlp_bwd_plain([w], x, g, Activation.NONE, Activation.NONE,
                                                   cdt, soa_in, False, torch.float32)
    xs, wc = (x.t() if soa_in else x).float(), w.to(cdt).float()
    dz = g.to(cdt).float()
    u = 2.0 ** -24
    for what, got, want, terms, count in (
            ("z", z, xs @ wc, xs.abs() @ wc.abs(), K),
            ("dx", dx.t() if soa_in else dx, (want_dx.t() if soa_in else want_dx).float(),
             dz.abs() @ wc.abs().t(), n),
            ("dW", dw, want_dws[0], xs.abs().t() @ dz.abs(), B)):
        bound = 2 * (count - 1) * u * terms + 1e-30
        assert got.shape == want.shape, what
        assert bool(((got - want).abs() <= bound).all()), \
            (what, float(((got - want).abs() / bound).max()))

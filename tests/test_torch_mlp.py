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

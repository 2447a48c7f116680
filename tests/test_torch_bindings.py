"""The port's torch-module bindings (``tcnn_tpu_torch.bindings.torch_interop``)
against the JAX package's (``tcnn_tpu.bindings.torch_interop``), on the CPU.

Each case of ``tests/test_torch_interop.py`` (the JAX bindings' own tests)
has its counterpart here: the port's module gets the JAX module's flat
``params`` (``load_jax_flat_params``) and both take the same seeded numpy
inputs.  On the CPU the port's modules run the plain versions of the
kernels (G, GB, GI, GG, RS for the grid; the fused MLP's M and MB where
the network is a FullyFusedMLP); ``tests/test_torch_cuda.py`` holds the
kernels against these plain paths on the card.

Tolerances, all fp32: first order (forward, parameter and input
gradients) rtol 1e-5, atol 1e-6, as the JAX tests use (the same fp32
products, summed in another order); second order (the gradient of the
input gradient, gradgradcheck's analytic side) rtol 1e-4, atol 1e-6: the
closed-form Smoothstep derivative 6f(1 − f) against JAX's autodiff of
f·f·(3 − 2f), and sums over corners, levels and samples in another order;
five ``torch.optim.Adam`` steps rtol 1e-4, atol 1e-6 on the parameters
(each step divides by √v, which carries the first-order rounding on).
"""

import io
import pickle

import jax
import numpy as np
import pytest
import torch

from tcnn_tpu.bindings import torch_interop as jti
from tcnn_tpu_torch.bindings import torch_interop as tti
from tcnn_tpu_torch.samples import mlp_learning_an_image_pytorch as sample
from tcnn_tpu_torch.utils.jax_params import load_jax_flat_params

ENC_CFG = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
           "log2_hashmap_size": 9, "base_resolution": 4,
           "per_level_scale": 1.5, "interpolation": "Smoothstep"}
NET_CFG = {"otype": "MLP", "n_neurons": 16, "n_hidden_layers": 2,
           "activation": "ReLU", "output_activation": "None"}
FUSED_CFG = dict(NET_CFG, otype="FullyFusedMLP")
FREQ_CFG = {"otype": "Frequency", "n_frequencies": 4}
FIRST = {"rtol": 1e-5, "atol": 1e-6}
SECOND = {"rtol": 1e-4, "atol": 1e-6}


def pair(kind, *args, **kwargs):
    """The JAX module and the port's on the CPU, holding the JAX module's params."""
    jm = getattr(jti, kind)(*args, **kwargs)
    tm = getattr(tti, kind)(*args, **kwargs, device="cpu")
    load_jax_flat_params(tm, jm.params.detach().numpy())
    return jm, tm


def inputs(n, d, seed=0, grad=False):
    x = np.random.RandomState(seed).rand(n, d).astype(np.float32)
    return [torch.tensor(x, requires_grad=grad) for _ in range(2)]


def close(a, b, tol=FIRST):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), **tol)


class TestForward:
    @pytest.mark.parametrize("net", [NET_CFG, FUSED_CFG], ids=["MLP", "FullyFusedMLP"])
    def test_network_with_input_encoding(self, net):
        jm, tm = pair("NetworkWithInputEncoding", 2, 3, ENC_CFG, net)
        assert tm.params.shape == jm.params.shape
        xj, xt = inputs(64, 2)
        y = tm(xt)
        assert y.shape == (64, 3) and y.dtype == torch.float32
        close(y, jm(xj))

    def test_matches_jax_path(self):
        jm, tm = pair("NetworkWithInputEncoding", 2, 3, ENC_CFG, NET_CFG)
        xj, xt = inputs(32, 2, seed=1)
        y_jax = np.asarray(jm.native._fwd(jax.numpy.asarray(jm.params.detach().numpy()),
                                          jax.numpy.asarray(xj.numpy())))
        np.testing.assert_allclose(tm(xt).detach().numpy(), y_jax, **FIRST)

    @pytest.mark.parametrize("cfg", [FREQ_CFG, ENC_CFG], ids=["Frequency", "HashGrid"])
    def test_encoding_only(self, cfg):
        jm, tm = pair("Encoding", 2, cfg)
        xj, xt = inputs(16, 2)
        y = tm(xt)
        assert y.shape == (16, jm.n_output_dims)
        close(y, jm(xj))

    @pytest.mark.parametrize("net", [NET_CFG, FUSED_CFG], ids=["MLP", "FullyFusedMLP"])
    def test_network_only(self, net):
        jm, tm = pair("Network", 8, 4, net)
        xj, xt = inputs(16, 8)
        y = tm(xt)
        assert y.shape == (16, 4)
        close(y, jm(xj))

    def test_wrong_width_raises(self):
        tm = tti.Network(8, 4, NET_CFG, device="cpu")
        with pytest.raises(ValueError, match="input dims"):
            tm(torch.rand(16, 5))


class TestBackward:
    def test_param_and_input_grads(self):
        jm, tm = pair("NetworkWithInputEncoding", 2, 3, ENC_CFG, NET_CFG)
        xj, xt = inputs(64, 2, grad=True)
        for m, x in ((jm, xj), (tm, xt)):
            (m(x) ** 2).sum().backward()
        assert tm.params.grad is not None and bool(torch.isfinite(tm.params.grad).all())
        close(tm.params.grad, jm.params.grad)
        close(xt.grad, xj.grad)

    @pytest.mark.parametrize("net", [NET_CFG, FUSED_CFG], ids=["MLP", "FullyFusedMLP"])
    def test_grads_match_jax(self, net):
        jm, tm = pair("NetworkWithInputEncoding", 2, 3, ENC_CFG, net)
        xj, xt = inputs(32, 2, grad=True)
        for m, x in ((jm, xj), (tm, xt)):
            (m(x) ** 2).sum().backward()
        close(tm.params.grad, jm.params.grad)
        close(xt.grad, xj.grad)

    def test_training_with_torch_optimizer(self):
        """Five ``torch.optim.Adam`` steps of both modules on the same
        batches: the losses and the parameters stay together."""
        jm, tm = pair("NetworkWithInputEncoding", 2, 3, ENC_CFG, NET_CFG)
        rng = np.random.RandomState(2)
        batches = [(torch.from_numpy(rng.rand(256, 2).astype(np.float32)),
                    torch.from_numpy(rng.rand(256, 3).astype(np.float32))) for _ in range(5)]
        losses = {}
        for m in (jm, tm):
            opt = torch.optim.Adam(m.parameters(), lr=1e-2)
            losses[m] = []
            for x, t in batches:
                opt.zero_grad()
                loss = ((m(x) - t) ** 2).mean()
                loss.backward()
                opt.step()
                losses[m].append(float(loss.detach()))
        np.testing.assert_allclose(losses[tm], losses[jm], **SECOND)
        close(tm.params, jm.params, SECOND)
        assert losses[tm][-1] < losses[tm][0]

    def test_gradients_reach_the_flat_vector_only(self):
        """``params`` is the module's one parameter: the native module's
        leaves are views of it, not parameters of the binding."""
        tm = tti.NetworkWithInputEncoding(2, 3, ENC_CFG, NET_CFG, device="cpu")
        assert [n for n, _ in tm.named_parameters()] == ["params"]
        assert list(tm.state_dict()) == ["params"]
        with torch.no_grad():
            tm.params.zero_()
        assert all(float(p.abs().max()) == 0 for p in tm.native.parameters())


class TestDoubleBackward:
    @pytest.mark.parametrize("net", [NET_CFG, FUSED_CFG], ids=["MLP", "FullyFusedMLP"])
    def test_grad_of_input_grad(self, net):
        """Eikonal-style use: a loss on dL/dx differentiated once more, the
        parameter and input gradients against the JAX bindings'."""
        jm, tm = pair("NetworkWithInputEncoding", 2, 1, ENC_CFG, net)
        xj, xt = inputs(16, 2, seed=3, grad=True)
        for m, x in ((jm, xj), (tm, xt)):
            (dydx,) = torch.autograd.grad(m(x).sum(), x, create_graph=True)
            ((dydx.norm(dim=-1) - 1.0) ** 2).mean().backward()
        assert bool(torch.isfinite(tm.params.grad).all())
        close(tm.params.grad, jm.params.grad, SECOND)
        close(xt.grad, xj.grad, SECOND)

    @pytest.mark.parametrize("net", [NET_CFG, FUSED_CFG], ids=["MLP", "FullyFusedMLP"])
    def test_grad_of_input_grad_network_only(self, net):
        """A network alone: a ReLU MLP's input gradient does not depend on
        x, so x's second gradient is zeros, as JAX's."""
        jm, tm = pair("Network", 8, 1, net)
        xj, xt = inputs(16, 8, seed=4, grad=True)
        for m, x in ((jm, xj), (tm, xt)):
            (dydx,) = torch.autograd.grad(m(x).sum(), x, create_graph=True)
            (dydx ** 2).mean().backward()
        close(tm.params.grad, jm.params.grad, SECOND)
        assert float(xj.grad.abs().max()) == 0
        assert torch.equal(xt.grad, xj.grad)

    def test_gradgradcheck_small(self):
        enc = tti.Encoding(2, {"otype": "OneBlob", "n_bins": 4}, device="cpu")
        x = torch.rand(4, 2, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
        x = (x * 0.6 + 0.2).requires_grad_(True)
        # float32 finite differences need loose tolerances (as the JAX test's)
        assert torch.autograd.gradcheck(lambda xx: enc(xx), (x,), eps=1e-3, atol=1e-2,
                                        rtol=1e-2, nondet_tol=0.0)
        assert torch.autograd.gradgradcheck(lambda xx: enc(xx), (x,), eps=1e-3, atol=1e-2,
                                            rtol=1e-2, nondet_tol=0.0)

    def test_second_order_matches_jax_on_the_grid_encoding(self):
        """The gradient of ⟨∂y/∂x, c⟩ for the grid alone (kernels GI, GG and
        RS on the card; their plain versions here) against the JAX module's."""
        jm, tm = pair("Encoding", 2, ENC_CFG)
        xj, xt = inputs(40, 2, seed=5, grad=True)
        c = torch.from_numpy(np.random.RandomState(6).randn(40, 2).astype(np.float32))
        for m, x in ((jm, xj), (tm, xt)):
            y = m(x)
            (dx,) = torch.autograd.grad((y * torch.linspace(-1, 1, y.shape[1])).sum(), x,
                                        create_graph=True)
            (dx * c).sum().backward()
        close(tm.params.grad, jm.params.grad, SECOND)
        close(xt.grad, xj.grad, SECOND)


class TestModuleProtocol:
    def test_pickle_roundtrip(self):
        tm = tti.NetworkWithInputEncoding(2, 3, ENC_CFG, NET_CFG, device="cpu")
        x = torch.rand(32, 2)
        with torch.no_grad():
            tm.params += 0.01   # move off the initial values so the state matters
        y0 = tm(x)
        m2 = pickle.loads(pickle.dumps(tm))
        assert torch.equal(m2(x), y0)
        buf = io.BytesIO()
        torch.save(tm, buf)
        buf.seek(0)
        m3 = torch.load(buf, weights_only=False)
        assert torch.equal(m3(x), y0)
        m3(x).sum().backward()   # gradients still reach params after the rebuild
        assert m3.params.grad is not None and float(m3.params.grad.abs().max()) > 0

    @pytest.mark.parametrize("kind,args", [("Encoding", (2, FREQ_CFG)),
                                           ("Encoding", (2, ENC_CFG)),
                                           ("Network", (8, 4, NET_CFG))])
    def test_pickle_encoding_and_network(self, kind, args):
        tm = getattr(tti, kind)(*args, device="cpu")
        with torch.no_grad():
            tm.params += 0.01
        x = torch.rand(16, tm.n_input_dims)
        assert torch.equal(pickle.loads(pickle.dumps(tm))(x), tm(x))

    def test_seed_changes_init(self):
        a = tti.Network(8, 4, NET_CFG, seed=1, device="cpu")
        b = tti.Network(8, 4, NET_CFG, seed=2, device="cpu")
        assert not torch.equal(a.params, b.params)
        c = tti.Network(8, 4, NET_CFG, seed=1, device="cpu")
        assert torch.equal(a.params, c.params)
        g = tti.NetworkWithInputEncoding(2, 3, ENC_CFG, NET_CFG, seed=3, device="cpu")
        table = g._split(g.params)[0]   # U(-1e-4, 1e-4), as the JAX package draws it
        assert float(table.abs().max()) <= 1e-4 and float(table.abs().max()) > 0

    def test_encoding_dtype_half(self):
        jm, tm = pair("Encoding", 2, FREQ_CFG, dtype=torch.float16)
        xj, xt = inputs(16, 2)
        y = tm(xt)
        assert y.dtype == torch.float16
        assert torch.equal(y, jm(xj))   # one fp32 value cast to fp16 on both sides
        with pytest.raises(ValueError, match="fp32 or fp16"):
            tti.Encoding(2, FREQ_CFG, dtype=torch.int32, device="cpu")

    @pytest.mark.parametrize("b", [1, 7, 255, 300])
    def test_odd_batch_sizes(self, b):
        """Any batch size, padded to 256 inside and sliced back."""
        jm, tm = pair("NetworkWithInputEncoding", 2, 3, ENC_CFG, NET_CFG)
        xj, xt = inputs(b, 2, seed=b, grad=True)
        for m, x in ((jm, xj), (tm, xt)):
            y = m(x)
            assert y.shape == (b, 3)
            y.sum().backward()
        assert xt.grad.shape == (b, 2) and bool(torch.isfinite(xt.grad).all())
        close(xt.grad, xj.grad)
        close(tm.params.grad, jm.params.grad)

    def test_extra_repr_and_attributes(self):
        tm = tti.NetworkWithInputEncoding(2, 3, ENC_CFG, NET_CFG, seed=7, device="cpu")
        jm = jti.NetworkWithInputEncoding(2, 3, ENC_CFG, NET_CFG, seed=7)
        assert repr(tm) == repr(jm)
        assert tm.loss_scale == 1.0 and tm.dtype == torch.float32 and tm.seed == 7
        assert (tm.n_input_dims, tm.n_output_dims) == (2, 3)
        assert tti.BATCH_GRANULARITY == jti.BATCH_GRANULARITY == 256
        tti.free_temporary_memory()

    def test_device_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA device"):
            tti.Network(8, 4, NET_CFG)


def test_load_jax_flat_params_refuses_another_length():
    tm = tti.Network(8, 4, NET_CFG, device="cpu")
    before = tm.params.detach().clone()
    n = tm.params.numel()
    for bad in (np.zeros(n - 1, np.float32), np.zeros(n + 4, np.float32),
                np.zeros((1, n), np.float32)):
        with pytest.raises(ValueError, match="flat params"):
            load_jax_flat_params(tm, bad)
    assert torch.equal(tm.params, before)


def test_unaligned_leaf_is_handed_over_as_a_copy():
    """A leaf whose offset in ``params`` is not a multiple of four floats
    (none in the JAX package's grids, whose tables come first; a network of
    3-wide layers has one) is handed to the module as a copy, and its
    gradient still reaches ``params``."""
    tm = tti.Network(3, 1, dict(NET_CFG, n_neurons=3, n_hidden_layers=1), device="cpu")
    leaves = tm._leaves   # (3, 3) at 0, (3, 1) at 9: the second is copied
    assert [leaf.copy for leaf in leaves] == [False, True]
    # an explicit generator: a draw where the 3-wide ReLU layer is dead for
    # every sample would leave both gradients zero
    x = torch.rand(8, 3, generator=torch.Generator().manual_seed(0))
    tm(x).sum().backward()
    # the same network on independent copies of its weights, padded as
    # the module pads the batch
    own = {leaf.name: v.detach().clone().requires_grad_()
           for leaf, v in zip(leaves, tm._split(tm.params))}
    xp = torch.nn.functional.pad(x, [0, 0, 0, tti.BATCH_GRANULARITY - 8])
    y = torch.func.functional_call(tm.native, own, (xp,))[:8]
    want = torch.cat([g.reshape(-1) for g in torch.autograd.grad(y.sum(), list(own.values()))])
    assert torch.equal(tm.params.grad, want)
    assert float(want[:9].abs().max()) > 0 and float(want[9:].abs().max()) > 0


def test_image_sample_runs_a_few_steps(tmp_path):
    """The ported sample on the CPU at a tiny size: a 24 x 20 image, 12
    steps of 2^6 pixels; the loss falls, the PSNR at step 10 is reported
    and its prediction dumped."""
    from PIL import Image

    rng = np.random.RandomState(0)
    img = (rng.rand(20, 24, 3) * 255).astype(np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(img).save(path)
    out = sample.main(["x", str(path), "12", "6"], device="cpu", out_dir=str(tmp_path))
    assert out["losses"].shape == (12,) and bool(torch.isfinite(out["losses"]).all())
    assert float(out["losses"][-1]) < float(out["losses"][0])
    assert set(out["psnr_at"]) == {10} and np.isfinite(out["psnr_at"][10])
    assert (tmp_path / "10_pytorch.jpg").exists()


def test_image_sample_pixel_centres_match_the_jax_sample():
    h, w = 5, 7
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    want = np.stack([(xs.ravel() + 0.5) / w, (ys.ravel() + 0.5) / h],
                    axis=-1).astype(np.float32)
    assert np.array_equal(sample.pixel_centres(h, w, torch.device("cpu")).numpy(), want)

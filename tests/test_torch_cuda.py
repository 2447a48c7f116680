"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA device, as on
CPU-only hosts.  This file imports neither jax nor ``tcnn_tpu``, so it
also runs on a card host without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: float32 tables are read exactly, so grid outputs differ from
the plain version only by the order of the fp32 corner sum (rtol 1e-5);
bfloat16 outputs are compared within one bf16 ulp of the plain value,
since an fp32 sum that differs in its last bit may round to the other
neighbour.  The MLP's bf16 chain may round each hidden activation to the
other bf16 neighbour (sums in another order): rtol 2e-2, atol 2e-3 on
O(1) outputs; fp32 sums in another order: rtol 1e-5, atol 1e-5.

Backward kernels:
  * grid table gradient (GB): the fp32 atomics and ``index_add_`` sum
    each row in another order, so a row may differ by 1e-5 of
    S = Σ|w·dy| over its updates, plus one bf16 ulp of the value for
    bf16 tables (the fp32 sum may round to the other neighbour).
  * fused-MLP backward (MB): fp32 sums over the batch in another order,
    1e-4 of each gradient's largest magnitude; in bf16 each dz may round
    to the other neighbour, 2e-2 of it.
  * a whole training step: the gradients within the MB tolerance of the
    plain path's; the graph loop's losses within 1e-3 of eager steps'.
"""

import numpy as np
import pytest
import torch

from tcnn_tpu_torch import BF16_POLICY, DEFAULT_POLICY, create_from_config
from tcnn_tpu_torch.common import (Activation, GridType, HashType,
                                   InterpolationType)
from tcnn_tpu_torch.ops import grid_ops
from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd,
                                               fused_mlp_bwd_plain,
                                               fused_mlp_fwd, fused_mlp_plain)
from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd,
                                                 grid_encode_bwd_plain,
                                                 grid_encode_fwd,
                                                 grid_encode_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests cover the plain path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |t| (8 significant bits)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def assert_grid_close(got, want):
    if want.dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs()
        assert bool((err <= bf16_ulp(want)).all()), float(err.max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


GRID_CASES = [
    # (n_dims, F, log2_hashmap, base, scale, grid_type, hash, interp)
    (2, 2, 15, 16, 1.5, GridType.HASH, HashType.COHERENT_PRIME, InterpolationType.LINEAR),
    (3, 4, 12, 4, 1.6, GridType.HASH, HashType.PRIME, InterpolationType.SMOOTHSTEP),
    (4, 2, 14, 4, 1.5, GridType.HASH, HashType.COHERENT_ADD, InterpolationType.LINEAR),
    (1, 8, 9, 8, 2.0, GridType.HASH, HashType.REVERSED_PRIME, InterpolationType.NEAREST),
    (2, 3, 10, 4, 1.8, GridType.DENSE, HashType.COHERENT_PRIME, InterpolationType.LINEAR),
    (3, 1, 10, 4, 1.8, GridType.TILED, HashType.COHERENT_PRIME, InterpolationType.LINEAR),
]


@pytest.mark.parametrize("case", GRID_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("soa", [True, False])
def test_grid_encode_kernel_matches_plain(cuda, case, dtype, soa):
    D, F, hm, base, scale, gtype, htype, interp = case
    spec = grid_ops.make_grid_spec(D, 8, F, hm, base, scale, grid_type=gtype,
                                   hash_type=htype, interpolation=interp)
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    # out-of-[0,1] and negative coordinates included; a ragged batch
    x = torch.from_numpy(rng.uniform(-0.3, 1.3, (4133, D)).astype(np.float32)).to(cuda)
    for live in (list(range(spec.n_levels)), [0, 1, 2]):
        got = grid_encode_fwd(spec, flat, x, live, soa=soa)
        torch.cuda.synchronize()
        want = grid_encode_plain(spec, flat, x, live, soa=soa)
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        assert_grid_close(got, want)


@pytest.mark.parametrize("width", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("soa_in,soa_out", [(True, False), (False, True)])
def test_fused_mlp_kernel_matches_plain(cuda, width, dtype, soa_in, soa_out):
    rng = np.random.default_rng(width)
    dims = [(32, width), (width, width), (width, width), (width, 3)]
    ws = [torch.from_numpy(rng.uniform(-1, 1, d).astype(np.float32)
                           * np.sqrt(6.0 / sum(d))).to(cuda) for d in dims]
    x = torch.from_numpy(rng.uniform(-1, 1, (1000, 32)).astype(np.float32)).to(cuda)
    x = x.t().contiguous() if soa_in else x
    for out_act in (Activation.NONE, Activation.SIGMOID):
        args = (ws, x.to(dtype), Activation.RELU, out_act, dtype, torch.float32,
                soa_in, soa_out)
        got = fused_mlp_fwd(*args)
        torch.cuda.synchronize()
        want = fused_mlp_plain(*args)
        assert got.shape == want.shape == ((3, 1000) if soa_out else (1000, 3))
        tol = dict(rtol=2e-2, atol=2e-3) if dtype == torch.bfloat16 else \
            dict(rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("policy", [BF16_POLICY, DEFAULT_POLICY])
def test_slice_inference_goes_through_both_kernels(cuda, policy):
    model = create_from_config(2, 3, "configs/config_hash.json", policy=policy)
    x = torch.rand((3000, 2), generator=torch.Generator(cuda).manual_seed(0),
                   device=cuda)
    g0, m0 = grid_encode_fwd.launches, fused_mlp_fwd.launches
    y = model.trainer.inference(x)
    torch.cuda.synchronize()
    assert (grid_encode_fwd.launches - g0, fused_mlp_fwd.launches - m0) == (1, 1)
    assert y.shape == (3000, 3) and bool(torch.isfinite(y).all())


def test_cuda_input_gradient_and_second_order_raise_slice_3(cuda):
    model = create_from_config(2, 3, "configs/config_hash.json")
    x = torch.rand((64, 2), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="slice 3"):
        model.network(x)
    y = model.network(x.detach())
    with pytest.raises(NotImplementedError, match="slice 3"):
        torch.autograd.grad(y.square().sum(), list(model.network.parameters()),
                            create_graph=True)


def grid_bwd_bound(spec, flat, x, dcols, live):
    """S = Σ|w·dy| per table entry, the scale of a row's rounding error."""
    return grid_encode_bwd_plain(spec, flat.float(), x, dcols.float().abs(), live)


def assert_grid_grad_close(got, want, scale):
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * scale + 1e-30
    if want.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(want)
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("case", GRID_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_encode_bwd_kernel_matches_plain(cuda, case, dtype):
    D, F, hm, base, scale, gtype, htype, interp = case
    spec = grid_ops.make_grid_spec(D, 8, F, hm, base, scale, grid_type=gtype,
                                   hash_type=htype, interpolation=interp)
    rng = np.random.default_rng(1)
    flat = torch.zeros(spec.n_params, dtype=dtype, device=cuda)
    x = torch.from_numpy(rng.uniform(-0.3, 1.3, (4133, D)).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(8 * F, 4133)).astype(np.float32))
    dcols = dcols.to(dtype).to(cuda)
    for live in (list(range(spec.n_levels)), [0, 1, 2]):
        for dc in (dcols, dcols.t().contiguous().t()):   # SoA, and AoS seen as SoA
            got = grid_encode_bwd(spec, flat, x, dc, live)
            torch.cuda.synchronize()
            want = grid_encode_bwd_plain(spec, flat, x, dc, live)
            assert got.shape == want.shape and got.dtype == want.dtype == dtype
            assert_grid_grad_close(got, want, grid_bwd_bound(spec, flat, x, dc, live))
        dead = torch.ones(spec.n_entries, dtype=torch.bool, device=cuda)
        for lv in live:
            level = spec.levels[lv]
            dead[level.offset:level.offset + level.size] = False
        assert bool((got.reshape(-1, F)[dead] == 0).all())


def mlp_bwd_tol(want, dtype):
    return (2e-2 if dtype == torch.bfloat16 else 1e-4) * float(want.abs().max())


@pytest.mark.parametrize("width", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("soa_in,soa_out", [(True, False), (False, True)])
def test_fused_mlp_bwd_kernel_matches_plain(cuda, width, dtype, soa_in, soa_out):
    rng = np.random.default_rng(width + 1)
    dims = [(32, width), (width, width), (width, 3)]
    ws = [torch.from_numpy(rng.uniform(-1, 1, d).astype(np.float32)
                           * np.sqrt(6.0 / sum(d))).to(cuda) for d in dims]
    x = torch.from_numpy(rng.uniform(-1, 1, (1000, 32)).astype(np.float32)).to(cuda)
    x = (x.t().contiguous() if soa_in else x).to(dtype)
    g = torch.from_numpy(rng.normal(size=(1000, 3)).astype(np.float32)).to(cuda)
    g = g.t().contiguous() if soa_out else g
    for out_act in (Activation.NONE, Activation.SIGMOID):
        args = (ws, x, g, Activation.RELU, out_act, dtype, soa_in, soa_out)
        got_dws, got_dx = fused_mlp_bwd(*args)
        torch.cuda.synchronize()
        want_dws, want_dx = fused_mlp_bwd_plain(*args)
        assert got_dx.shape == want_dx.shape == x.shape and got_dx.dtype == dtype
        for got, want in zip([*got_dws, got_dx], [*want_dws, want_dx]):
            assert got.shape == want.shape
            err = float((got.float() - want.float()).abs().max())
            assert err <= mlp_bwd_tol(want.float(), dtype), err


def plain_loss_and_grads(model, x, target):
    """The training loss and its gradients through the plain versions, on
    the same tensors: G, M, MB and GB each replaced by its plain version."""
    enc, net, pol = model.network.encoding, model.network.network, model.network.policy
    live = list(range(enc.spec.n_levels))
    table = enc.grid.detach().to(pol.compute_dtype)
    ws = [w.detach() for w in net.layers]
    feats = grid_encode_plain(enc.spec, table, x, live, soa=True).to(pol.compute_dtype)
    pred = fused_mlp_plain(ws, feats, net.activation, net.output_activation,
                           pol.compute_dtype, pol.output_dtype, True, False)
    pred = pred.float().requires_grad_()
    loss = model.loss(pred, target)
    (dy,) = torch.autograd.grad(loss, pred)
    dws, dfeats = fused_mlp_bwd_plain(ws, feats, dy, net.activation,
                                      net.output_activation, pol.compute_dtype,
                                      True, False)
    dtable = grid_encode_bwd_plain(enc.spec, table, x, dfeats, live).float()
    grads = {"network.encoding.grid": dtable}
    grads.update({f"network.network.layers.{i}": d for i, d in enumerate(dws)})
    return loss.detach(), grads


@pytest.mark.parametrize("policy", [BF16_POLICY, DEFAULT_POLICY])
def test_training_step_gradients_match_plain_path(cuda, policy):
    model = create_from_config(2, 3, "configs/config_hash.json", policy=policy)
    with torch.no_grad():
        model.network.encoding.grid.uniform_(-1, 1, generator=torch.Generator(cuda).manual_seed(1))
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.rand((5000, 2), generator=gen, device=cuda)
    target = torch.rand((5000, 3), generator=gen, device=cuda)
    counts = (grid_encode_fwd.launches, fused_mlp_fwd.launches,
              grid_encode_bwd.launches, fused_mlp_bwd.launches)
    loss, grads = model.trainer.loss_value_and_grads(x, target)
    torch.cuda.synchronize()
    after = (grid_encode_fwd.launches, fused_mlp_fwd.launches,
             grid_encode_bwd.launches, fused_mlp_bwd.launches)
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1, 1]
    want_loss, want = plain_loss_and_grads(model, x, target)
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=0)
    assert set(grads) == {"encoding.grid", "network.layers.0", "network.layers.1",
                          "network.layers.2"}
    for name, got in grads.items():
        ref = want["network." + name]
        assert got.dtype == torch.float32 and got.shape == ref.shape
        err = float((got - ref).abs().max())
        assert err <= mlp_bwd_tol(ref, policy.compute_dtype), (name, err)


def test_graph_loop_equals_eager_steps(cuda):
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image

    models = [create_from_config(2, 3, "configs/config_hash.json", policy=BF16_POLICY)
              for _ in range(2)]
    samplers = [ImageSampler(synthetic_image(128, 128)) for _ in range(2)]
    loop = models[0].trainer.make_training_loop(lambda i: samplers[0].sample_batch(4096), 6)
    got = loop()
    want = torch.stack([models[1].trainer.training_step(*samplers[1].sample_batch(4096))
                        for _ in range(6)])
    torch.cuda.synchronize()
    assert models[0].trainer.step == models[1].trainer.step == 6
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0)
    again = loop()   # the captured graph is reused
    assert again.shape == (6,) and bool(torch.isfinite(again).all())
    assert models[0].trainer.step == 12

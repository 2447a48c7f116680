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
    The same for config_btf (slice 3), whose grid reads a strided column
    slice of its (B, 6) input in place.

Second order (slice 4):
  * grid input gradient (GI) and second order (GG): each output within
    1e-5 of its largest magnitude (fp32 sums over corners and levels in
    another order; for bf16 tables both read the same bf16 values);
  * row scatter-add (RS): per entry within 2^-11 of S = Σ|g| over its
    updates (fp32 atomics in any order), plus one bf16 ulp for bf16 output;
  * the SDF sample's eikonal step: the table gradient per entry within
    2^-11 of S = Σ|terms| (GB's and RS's atomics), the weights' gradients
    within 1e-4 of their largest magnitude, of the plain eikonal step's.
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
                                                 grid_encode_bwd_bwd,
                                                 grid_encode_bwd_bwd_plain,
                                                 grid_encode_bwd_input,
                                                 grid_encode_bwd_input_plain,
                                                 grid_encode_bwd_plain,
                                                 grid_encode_fwd,
                                                 grid_encode_plain)
from tcnn_tpu_torch.ops.cuda.scatter import (row_scatter_add, row_scatter_add_plain,
                                             scatter_add_cols)
from tcnn_tpu_torch.tools.plain_path import (plain_loss_and_grads, plain_sdf_loss_and_grads,
                                             relu_flip_rows)

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
    """Input gradients and second derivatives run on the card since slice
    4, through kernels GI, GG and RS; a third derivative raises."""
    model = create_from_config(2, 3, "configs/config_hash.json")
    x = torch.rand((64, 2), device=cuda, requires_grad=True)
    counts = (grid_encode_bwd_input.launches, grid_encode_bwd_bwd.launches,
              row_scatter_add.launches)
    (gx,) = torch.autograd.grad(model.network(x).square().sum(), x, create_graph=True)
    params = list(model.network.parameters())
    grads = torch.autograd.grad(gx.square().sum(), params, retain_graph=True)
    torch.cuda.synchronize()
    after = (grid_encode_bwd_input.launches, grid_encode_bwd_bwd.launches,
             row_scatter_add.launches)
    # GI twice: for gx, and in the second pass back through the features
    # (the loss's output gradient 2y depends on x), whose x part
    # autograd.grad(..., params) then drops
    assert [a - b for a, b in zip(after, counts)] == [2, 1, 1]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch.autograd.grad(gx.square().sum(), params, create_graph=True)


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
        ref = want[name]
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


# -- slice 3: the config_btf path ------------------------------------------

BTF_CONFIG = "configs/config_btf.json"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_kernels_read_a_strided_input_slice(cuda, dtype):
    """G and GB on columns 0-3 of a (B, 6) tensor, read in place, against
    the same columns made contiguous and against the plain versions."""
    spec = grid_ops.make_grid_spec(4, 8, 2, 14, 4, 1.5, hash_type=HashType.COHERENT_ADD)
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    x6 = torch.from_numpy(rng.uniform(0, 1, (4133, 6)).astype(np.float32)).to(cuda)
    xs, xc = x6[:, :4], x6[:, :4].contiguous()
    assert not xs.is_contiguous()
    live = list(range(spec.n_levels))
    for soa in (True, False):
        got = grid_encode_fwd(spec, flat, xs, live, soa=soa)
        torch.cuda.synchronize()
        assert torch.equal(got, grid_encode_fwd(spec, flat, xc, live, soa=soa))
        assert_grid_close(got, grid_encode_plain(spec, flat, xs, live, soa=soa))
    dfull = torch.from_numpy(rng.normal(size=(4133, 40)).astype(np.float32)).to(dtype).to(cuda)
    dc = dfull[:, :spec.n_output_dims].t()      # MB's AoS gradient, as the model hands it
    got = grid_encode_bwd(spec, flat, xs, dc, live)
    torch.cuda.synchronize()
    want = grid_encode_bwd_plain(spec, flat, xs, dc, live)
    assert_grid_grad_close(got, want, grid_bwd_bound(spec, flat, xs, dc, live))
    assert_grid_grad_close(grid_encode_bwd(spec, flat, xc, dc.contiguous(), live), want,
                           grid_bwd_bound(spec, flat, xs, dc, live))
    with pytest.raises(ValueError, match="unit stride"):
        grid_encode_fwd(spec, flat, x6.t().contiguous().t()[:, :4], live)


@pytest.mark.parametrize("hash_type", [HashType.COHERENT_ADD, HashType.COHERENT_PRIME])
def test_grid_encode_bwd_at_4d_2e19_row_levels(cuda, hash_type):
    """GB where the JAX package takes its serial routes: _pair_kernel
    (dense and CoherentAdd levels) and _weighted_kernel (CoherentPrime
    hashed levels), on config_btf's first levels: 65,536 and 331,776 dense
    rows, then 2^19 hashed."""
    spec = grid_ops.make_grid_spec(4, 4, 2, 19, 16, 1.5, hash_type=hash_type)
    assert [lv.size for lv in spec.levels] == [65536, 331776, 524288, 524288]
    rng = np.random.default_rng(6)
    flat = torch.zeros(spec.n_params, dtype=torch.bfloat16, device=cuda)
    x = torch.from_numpy(rng.uniform(0, 1, (1 << 16, 4)).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(8, 1 << 16)).astype(np.float32))
    dcols = dcols.to(torch.bfloat16).to(cuda)
    live = list(range(4))
    got = grid_encode_bwd(spec, flat, x, dcols, live)
    torch.cuda.synchronize()
    want = grid_encode_bwd_plain(spec, flat, x, dcols, live)
    assert_grid_grad_close(got, want, grid_bwd_bound(spec, flat, x, dcols, live))
    # the level wrap of the pair route: some sample's odd dim-0 corner on
    # a level's first row while its even corner is on the level's last
    idx, ws = grid_ops.build_indices_weights(spec, x, live)
    idx = idx.reshape(4, 16, -1)
    last = torch.tensor([lv.offset + lv.size - 1 for lv in spec.levels], device=cuda)
    if hash_type == HashType.COHERENT_ADD:
        assert bool((idx[:, 0::2, :] == last[:, None, None]).any())


def test_fused_mlp_kernels_at_btf_width(cuda):
    """M and MB at config_btf's 40 -> 64 x 3 -> 3, AoS input (d_in padded
    to 48 inside the kernels)."""
    rng = np.random.default_rng(7)
    dims = [(40, 64), (64, 64), (64, 64), (64, 3)]
    ws = [torch.from_numpy(rng.uniform(-1, 1, d).astype(np.float32)
                           * np.sqrt(6.0 / sum(d))).to(cuda) for d in dims]
    x = torch.from_numpy(rng.uniform(-1, 1, (5000, 40)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(5000, 3)).astype(np.float32)).to(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        args = (ws, x.to(dtype), Activation.RELU, Activation.NONE, dtype, torch.float32,
                False, False)
        got = fused_mlp_fwd(*args)
        torch.cuda.synchronize()
        tol = dict(rtol=2e-2, atol=2e-3) if dtype == torch.bfloat16 else \
            dict(rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, fused_mlp_plain(*args), **tol)
        bargs = (ws, x.to(dtype), g, Activation.RELU, Activation.NONE, dtype, False, False)
        got_dws, got_dx = fused_mlp_bwd(*bargs)
        torch.cuda.synchronize()
        want_dws, want_dx = fused_mlp_bwd_plain(*bargs)
        for a, b in zip([*got_dws, got_dx], [*want_dws, want_dx]):
            assert a.shape == b.shape
            assert float((a.float() - b.float()).abs().max()) <= mlp_bwd_tol(b.float(), dtype)


@pytest.mark.parametrize("policy", [BF16_POLICY, DEFAULT_POLICY])
def test_btf_training_step_gradients_match_plain_path(cuda, policy):
    model = create_from_config(6, 3, BTF_CONFIG, policy=policy)
    grid = model.network.encoding.nested[0]
    assert grid.grid.numel() == 15474688 and grid.grid.device.type == "cuda"
    with torch.no_grad():
        grid.grid.uniform_(-1, 1, generator=torch.Generator(cuda).manual_seed(1))
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.rand((5000, 6), generator=gen, device=cuda)
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
    assert set(grads) == set(want)
    for name, got in grads.items():
        ref = want[name]
        assert got.dtype == torch.float32 and got.shape == ref.shape
        err = float((got - ref).abs().max())
        assert err <= mlp_bwd_tol(ref, policy.compute_dtype), (name, err)


def test_btf_graph_loop_equals_eager_steps(cuda):
    from tcnn_tpu_torch.samples.fit_btf import batch_sampler

    models = [create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY) for _ in range(2)]
    samplers = [batch_sampler(4096, cuda, seed=3) for _ in range(2)]
    loop = models[0].trainer.make_training_loop(samplers[0], 6)
    got = loop()
    want = torch.stack([models[1].trainer.training_step(*samplers[1](i)) for i in range(6)])
    torch.cuda.synchronize()
    assert models[0].trainer.step == models[1].trainer.step == 6
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0)
    again = loop()   # the captured graph is reused
    assert again.shape == (6,) and bool(torch.isfinite(again).all())
    y = models[0].trainer.inference(samplers[0](0)[0])
    assert y.shape == (4096, 3) and bool(torch.isfinite(y).all())


# -- slice 4: second order ---------------------------------------------------


def assert_rel_close(got, want, rel):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(want.float().abs().max())
    assert scale > 0
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("case", GRID_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_input_gradient_and_second_order_kernels_match_plain(cuda, case, dtype):
    """GI and GG against their plain versions, every live-level set of
    test_grid_encode_bwd_kernel_matches_plain; dcols SoA and AoS-as-SoA."""
    D, F, hm, base, scale, gtype, htype, interp = case
    spec = grid_ops.make_grid_spec(D, 8, F, hm, base, scale, grid_type=gtype,
                                   hash_type=htype, interpolation=interp)
    rng = np.random.default_rng(8)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    x = torch.from_numpy(rng.uniform(0.02, 0.98, (4133, D)).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(8 * F, 4133)).astype(np.float32))
    dcols = dcols.to(dtype).to(cuda)
    ddx = torch.from_numpy(rng.normal(size=(4133, D)).astype(np.float32)).to(cuda)
    for live in (list(range(spec.n_levels)), [0, 1, 2]):
        for dc in (dcols, dcols.t().contiguous().t()):
            got = grid_encode_bwd_input(spec, flat, x, dc, live)
            torch.cuda.synchronize()
            want = grid_encode_bwd_input_plain(spec, flat, x, dc, live)
            if interp == InterpolationType.NEAREST:
                assert bool((got == 0).all()) and bool((want == 0).all())
            else:
                assert_rel_close(got, want, 1e-5)
            got = grid_encode_bwd_bwd(spec, flat, x, dc, ddx, live)
            torch.cuda.synchronize()
            want = grid_encode_bwd_bwd_plain(spec, flat, x, dc, ddx, live)
            assert torch.equal(got.rows, want.rows)
            for a, b in zip((got.d_dcols, got.d_x, got.g), (want.d_dcols, want.d_x, want.g)):
                if interp == InterpolationType.NEAREST or (
                        b is want.d_x and interp == InterpolationType.LINEAR and D == 1):
                    assert float(a.abs().max()) == float(b.abs().max()) == 0
                else:
                    assert_rel_close(a, b, 1e-5)


def assert_scatter_close(got, want, scale):
    err = (got.float() - want.float()).abs()
    tol = 2.0 ** -11 * scale + 1e-30
    if want.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(want)
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("f", [1, 2, 3, 4, 8])
def test_row_scatter_kernel_matches_plain(cuda, f):
    """RS on random rows (a few out of range), g contiguous, g as the
    transpose of F column streams (row 10), and a bf16 result."""
    rng = np.random.default_rng(f)
    n_rows, m = 5000, 200003
    idx = torch.from_numpy(rng.integers(-3, n_rows + 3, m).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(m, f)).astype(np.float32)).to(cuda)
    scale = row_scatter_add_plain(idx, g.abs(), n_rows)
    want = row_scatter_add_plain(idx, g, n_rows)
    got = row_scatter_add(idx, g, n_rows)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n_rows * f,) and got.dtype == torch.float32
    assert_scatter_close(got, want, scale)
    streams = g.t().contiguous()
    assert_scatter_close(scatter_add_cols(idx, streams, n_rows), want, scale)
    bf = row_scatter_add(idx, g, n_rows, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert_scatter_close(bf, row_scatter_add_plain(idx, g, n_rows, torch.bfloat16), scale)


def test_sdf_eikonal_step_matches_plain_step(cuda):
    """The SDF sample's step at full width (3-D HashGrid 8 x 2, 2^15 rows,
    FullyFusedMLP 64 x 2, fp32), B = 2^14, against the plain eikonal step;
    it launches GI, GG and RS once each."""
    from tcnn_tpu_torch import Policy
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    model = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
    with torch.no_grad():
        model.network.encoding.grid.uniform_(-1, 1, generator=torch.Generator(cuda).manual_seed(4))
    xs, xv = sdf.sample_points(torch.Generator(cuda).manual_seed(5), 1 << 14, cuda)
    counts = (grid_encode_bwd_input.launches, grid_encode_bwd_bwd.launches,
              row_scatter_add.launches)
    loss, grads = sdf.loss_and_grads(model.network, xs, xv)
    torch.cuda.synchronize()
    after = (grid_encode_bwd_input.launches, grid_encode_bwd_bwd.launches,
             row_scatter_add.launches)
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1]
    want_loss, want, scale = plain_sdf_loss_and_grads(model.network, xs, xv, table_scale=True)
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=0)
    assert set(grads) == set(want)
    for name, got in grads.items():
        if name == "encoding.grid":
            assert_scatter_close(got, want[name], scale)
        else:
            assert_rel_close(got, want[name], 1e-4)


# -- the redesigned fused-MLP kernels: geometry, depth, determinism ---------

SDF_DIMS = [(16, 64), (64, 64), (64, 1)]
BTF_DIMS = [(40, 64), (64, 64), (64, 64), (64, 3)]


def mlp_inputs(cuda, dims, batch, seed, soa_in):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy(rng.uniform(-1, 1, d).astype(np.float32)
                           * np.sqrt(6.0 / sum(d))).to(cuda) for d in dims]
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, dims[0][0])).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(batch, dims[-1][1])).astype(np.float32)).to(cuda)
    return ws, (x.t().contiguous() if soa_in else x), g


def assert_dx_close(got, want, ws, x, g, dtype, soa_in):
    """MB's dx within the MB tolerance of the plain version's, but for bf16
    rows that a switched ReLU explains (``relu_flip_rows``, as
    ``chip_smoke.py`` holds config_btf's dx): a hidden pre-activation
    within one bf16 ulp of 0 may switch when a sum upstream rounds the
    other way, which moves that sample's whole row."""
    tol = mlp_bwd_tol(want.float(), dtype)
    a, b = (got.t(), want.t()) if soa_in else (got, want)
    rows = ((a.float() - b.float()).abs() > tol).any(dim=1).nonzero().flatten()
    if dtype == torch.float32 or not rows.numel():
        assert not rows.numel(), f"{rows.numel()} dx rows beyond {tol:.3e}"
        return
    explained = relu_flip_rows(ws, x, g, Activation.NONE, dtype, rows, a[rows], tol,
                               soa_in)[0]
    assert bool(explained.all()), f"{int((~explained).sum())} of {rows.numel()} dx rows " \
                                  f"beyond {tol:.3e} not explained by a switched ReLU"


def check_m_and_mb(cuda, dims, batch, dtype, seed=11, soa_in=True):
    """M and MB against their plain versions at the stated tolerances,
    ReLU hidden layers."""
    ws, x, g = mlp_inputs(cuda, dims, batch, seed, soa_in)
    relu, none = Activation.RELU, Activation.NONE
    args = (ws, x.to(dtype), relu, none, dtype, torch.float32, soa_in, False)
    got = fused_mlp_fwd(*args)
    torch.cuda.synchronize()
    tol = dict(rtol=2e-2, atol=2e-3) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, fused_mlp_plain(*args), **tol)
    bargs = (ws, x.to(dtype), g, relu, none, dtype, soa_in, False)
    got_dws, got_dx = fused_mlp_bwd(*bargs)
    torch.cuda.synchronize()
    want_dws, want_dx = fused_mlp_bwd_plain(*bargs)
    for a, b in zip(got_dws, want_dws):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) <= mlp_bwd_tol(b, dtype)
    assert got_dx.shape == want_dx.shape and got_dx.dtype == want_dx.dtype
    assert_dx_close(got_dx, want_dx, ws, x.to(dtype), g, dtype, soa_in)


# Batch rows of one tile of kernel MB and of M's fp32 path
# (csrc/mlp_common.cuh: kRows, kRowsF32).
TILE_ROWS = {torch.float32: 64, torch.bfloat16: 128}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", ["one row", "below one tile", "4133"] + [
    f"tiles just {side} {k} CTAs per SM" for k in (1, 2, 3, 4) for side in ("below", "above")])
def test_fused_mlp_kernels_at_batch_edges(cuda, dtype, edge):
    """At the SDF shape: B = 1, B inside one tile, B = 4133, and a tile
    count one below and one above the CTA count of k CTAs on every SM, for
    each k the occupancy calculator may give the persistent kernels (so
    that some CTAs walk two tiles, the last one ragged, or the grid is cut
    to the tiles)."""
    rows, n_sms = TILE_ROWS[dtype], torch.cuda.get_device_properties(cuda).multi_processor_count
    if edge.startswith("tiles"):
        side, k = edge.split()[2], int(edge.split()[3])
        batch = (k * n_sms + (1 if side == "above" else -1)) * rows - 3
    else:
        batch = {"one row": 1, "below one tile": rows - 5, "4133": 4133}[edge]
    check_m_and_mb(cuda, SDF_DIMS, batch, dtype)


F32, BF16 = torch.float32, torch.bfloat16


# The most hidden layers of width 128 that kernel MB takes at 32 -> 128 ->
# 3, ReLU (csrc/fused_mlp_bwd.cu, at half tiles): fp32 holds per hidden
# layer 128 x 36 floats, beside 18,112 floats of input, dz_out and one
# layer's weights, (232,448 / 4 - 18,112) / 4,608 = 8.7; bf16 holds
# 18,432 bytes (h_k and its act' bits), beside 43,008, 10.3.
MAX_HIDDEN_128 = {F32: 8, BF16: 10}


@pytest.mark.parametrize("dtype,width,n_hidden", [
    (F32, 128, 8), (F32, 128, 3), (F32, 128, 2), (F32, 64, 8), (F32, 64, 1), (F32, 16, 1),
    (BF16, 128, 11), (BF16, 128, 3), (BF16, 128, 2), (BF16, 64, 1), (BF16, 16, 1),
    (F32, 128, 9)])
def test_fused_mlp_kernels_at_depth(cuda, dtype, width, n_hidden):
    """Depths whose weights do not stay resident (staged per layer and
    tile, dW added in device memory) and n_hidden = 1, ReLU hidden layers.
    M takes every depth; width 128 beyond depth 4 runs MB at half tiles,
    and where one CTA of MB needs more shared memory than an SM has even
    so (fp32 beyond depth 8, bf16 beyond 10), MB raises, stating its
    limit.  bf16 stops at depth 3 (non-resident at width 128): over eight
    bf16 layers a hidden value rounded to the other bf16 neighbour
    compounds beyond the bf16 bound in M's output too, so depth 8 is held
    in fp32, and in bf16 only MB's refusal is checked."""
    from tcnn_tpu_torch.ops.cuda import kernels

    dims = [(32, width)] + [(width, width)] * (n_hidden - 1) + [(width, 3)]
    relu = list(Activation).index(Activation.RELU)
    smem = kernels().fused_mlp_bwd_smem_bytes(32, 3, width, len(dims),
                                              dtype == torch.bfloat16, relu, 0)
    if smem > 232448:
        ws, x, g = mlp_inputs(cuda, dims, 4133, 12, False)
        limit = MAX_HIDDEN_128[dtype]
        with pytest.raises(NotImplementedError, match=f"at most {limit} hidden layers"):
            fused_mlp_bwd(ws, x.to(dtype), g, Activation.RELU, Activation.NONE, dtype)
        assert width == 128 and n_hidden == limit + 1
        if dtype == torch.float32:
            args = (ws, x, Activation.RELU, Activation.NONE, dtype, torch.float32)
            torch.testing.assert_close(fused_mlp_fwd(*args), fused_mlp_plain(*args),
                                       rtol=1e-5, atol=1e-5)
        return
    check_m_and_mb(cuda, dims, 4133, dtype, seed=width + n_hidden, soa_in=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_kernels_after_a_smaller_shape_of_one_instance(cuda, dtype):
    """One kernel instance at a shape that needs more shared memory, then
    at one that needs less, then at the first again: the launchers keep
    their occupancy per shape, and each launch sets the instance's
    shared-memory budget anew (a budget left by the smaller shape made the
    launch at the larger one fail)."""
    for dims in (SDF_DIMS, [(16, 64), (64, 1)], SDF_DIMS):
        check_m_and_mb(cuda, dims, 4133, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [SDF_DIMS, BTF_DIMS], ids=["sdf", "config_btf"])
def test_fused_mlp_bwd_is_bit_identical_across_launches(cuda, dtype, dims):
    """Each dW element has one owner thread and every sum a fixed order:
    two launches on the same inputs give the same bits."""
    ws, x, g = mlp_inputs(cuda, dims, 1 << 16, 13, dims is SDF_DIMS)
    args = (ws, x.to(dtype), g, Activation.RELU, Activation.NONE, dtype, dims is SDF_DIMS,
            False)
    first_dws, first_dx = fused_mlp_bwd(*args)
    again_dws, again_dx = fused_mlp_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first_dws, again_dws))
    assert torch.equal(first_dx, again_dx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [4133, (1 << 16) - 3])
def test_fused_mlp_kernels_at_config_oneblob_shape(cuda, dtype, batch):
    """configs/config_oneblob.json's MLP, 128 -> 128 x 5 -> 3, ReLU: MB
    runs it at half tiles (64 rows in bf16, 32 in fp32; at full tiles it
    needs 260,096 and 276,608 bytes), M as for every depth; dW held as at
    the other shapes, bf16 dx rows as config_btf's (relu_flip_rows)."""
    from tcnn_tpu_torch.ops.cuda import kernels

    relu = list(Activation).index(Activation.RELU)
    bf16 = dtype == torch.bfloat16
    assert kernels().fused_mlp_bwd_smem_bytes(128, 3, 128, 6, bf16, relu, 0) == (
        164864 if bf16 else 196864)
    check_m_and_mb(cuda, [(128, 128)] * 5 + [(128, 3)], batch, dtype, seed=batch % 97,
                   soa_in=False)


# Kernel RS's geometry (csrc/row_scatter.cu): updates per CTA and the
# fp32 values of a CTA's window.
RS_CHUNK = 8192
RS_WINDOW_FLOATS = 96 * 1024 // 4


@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["one row", "window - 1 row", "window", "window + 1 row",
                                  "wide unsorted", "out of range"])
def test_row_scatter_window_edges(cuda, f, case):
    """RS where the redesign branches: every update of a chunk on one row;
    chunks whose row range is one row under, exactly at and one row over
    the shared-memory window; unsorted rows over a range wider than the
    window; indices out of range (skipped).  Each as contiguous g, as row
    10's column streams and with a bf16 result."""
    rng = np.random.default_rng(7 * f + len(case))
    win_rows = RS_WINDOW_FLOATS // f
    n_rows = 3 * win_rows + 11
    m = 3 * RS_CHUNK + 5   # three full chunks and a ragged one
    if case == "one row":
        idx = np.full(m, 17)
    elif case.startswith("window"):
        span = win_rows + {"window - 1 row": -1, "window": 0, "window + 1 row": 1}[case]
        lo = rng.integers(0, n_rows - span, m // RS_CHUNK + 1)
        idx = np.concatenate([rng.permutation(np.concatenate(
            [[l, l + span - 1], rng.integers(l, l + span, RS_CHUNK - 2)])) for l in lo])[:m]
    elif case == "wide unsorted":
        idx = rng.integers(0, n_rows, m)
    else:
        idx = rng.integers(-n_rows, 2 * n_rows, m)
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(m, f)).astype(np.float32)).to(cuda)
    scale = row_scatter_add_plain(idx, g.abs(), n_rows)
    want = row_scatter_add_plain(idx, g, n_rows)
    got = row_scatter_add(idx, g, n_rows)
    torch.cuda.synchronize()
    assert_scatter_close(got, want, scale)
    assert_scatter_close(scatter_add_cols(idx, g.t().contiguous(), n_rows), want, scale)
    bf = row_scatter_add(idx, g, n_rows, torch.bfloat16)
    assert_scatter_close(bf, row_scatter_add_plain(idx, g, n_rows, torch.bfloat16), scale)
    untouched = scale == 0
    assert bool((got[untouched] == 0).all()) and bool((bf[untouched] == 0).all())


@pytest.mark.parametrize("D", [2, 3, 4])
@pytest.mark.parametrize("F", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_encode_bwd_at_32768_row_levels(cuda, monkeypatch, D, F, dtype):
    """GB where its plan branches: hashed levels of 32,768 rows, two
    windows each at F = 2 (256 KB of fp32), direct atomics at F = 4, and
    the coarse levels in one window; B = 2^16, every level that fits
    windowed (GB_MIN_HITS 0).  Rows no sample touches stay exact zeros."""
    from tcnn_tpu_torch.ops.cuda import grid_encode as ge
    from tcnn_tpu_torch.ops.cuda.grid_encode import gb_plan

    monkeypatch.setattr(ge, "GB_MIN_HITS", 0)
    monkeypatch.setattr(ge, "_gb_plans", {})
    spec = grid_ops.make_grid_spec(D, 8, F, 15, 8, 2.0)
    assert spec.levels[-1].size == 32768
    live = list(range(spec.n_levels))
    items = gb_plan(spec, live, 1 << 16).items
    fine = items[items[:, 0] == spec.n_levels - 1]
    assert set(fine[:, 2].tolist()) == ({16384} if F == 2 else {0})
    rng = np.random.default_rng(D * F)
    x = torch.from_numpy(rng.uniform(0, 1, (1 << 16, D)).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(8 * F, 1 << 16)).astype(np.float32))
    dcols = dcols.to(dtype).to(cuda)
    flat = torch.zeros(spec.n_params, dtype=dtype, device=cuda)
    got = grid_encode_bwd(spec, flat, x, dcols, live)
    torch.cuda.synchronize()
    scale = grid_bwd_bound(spec, flat, x, dcols, live)
    assert_grid_grad_close(got, grid_encode_bwd_plain(spec, flat, x, dcols, live), scale)
    assert bool((got[scale == 0] == 0).all())


@pytest.mark.parametrize("fit", ["exactly", "one row over"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_encode_bwd_at_the_window_limit(cuda, monkeypatch, fit, dtype):
    """A level of exactly one window's rows, and one row more (then cut in
    two parts), with GB's window shrunk to the finest level of a 3-D
    Smoothstep grid (the SDF sample's geometry at 2^12-row tables); and
    dead levels (static max_level) left at exact zeros."""
    from tcnn_tpu_torch.ops.cuda import grid_encode as ge

    spec = grid_ops.make_grid_spec(3, 8, 2, 12, 4, 1.5,
                                   interpolation=InterpolationType.SMOOTHSTEP)
    size = max(lv.size for lv in spec.levels)
    rows = size if fit == "exactly" else size - 1
    monkeypatch.setattr(ge, "GB_WINDOW_BYTES", rows * 2 * 4)
    monkeypatch.setattr(ge, "GB_MIN_HITS", 0)
    monkeypatch.setattr(ge, "_gb_plans", {})
    rng = np.random.default_rng(3)
    B = 20000
    x = torch.from_numpy(rng.uniform(0, 1, (B, 3)).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(16, B)).astype(np.float32)).to(dtype).to(cuda)
    flat = torch.zeros(spec.n_params, dtype=dtype, device=cuda)
    for live in (list(range(8)), list(range(5))):
        items = ge.gb_plan(spec, live, B).items
        split = any(spec.levels[lv].size > rows for lv in live)
        assert bool((items[:, 1] > 0).any()) == split == (fit != "exactly")
        got = grid_encode_bwd(spec, flat, x, dcols, live)
        torch.cuda.synchronize()
        scale = grid_bwd_bound(spec, flat, x, dcols, live)
        assert_grid_grad_close(got, grid_encode_bwd_plain(spec, flat, x, dcols, live), scale)
        assert bool((got[scale == 0] == 0).all())

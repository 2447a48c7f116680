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


def assert_dx_close(got, want, ws, x, g, dtype, soa_in, out_act=Activation.NONE):
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
    explained = relu_flip_rows(ws, x, g, out_act, dtype, rows, a[rows], tol,
                               soa_in)[0]
    assert bool(explained.all()), f"{int((~explained).sum())} of {rows.numel()} dx rows " \
                                  f"beyond {tol:.3e} not explained by a switched ReLU"


def check_m_and_mb(cuda, dims, batch, dtype, seed=11, soa_in=True, out_act=Activation.NONE,
                   soa_out=False):
    """M and MB against their plain versions at the stated tolerances,
    ReLU hidden layers."""
    ws, x, g = mlp_inputs(cuda, dims, batch, seed, soa_in)
    if soa_out:
        g = g.t().contiguous()
    relu = Activation.RELU
    args = (ws, x.to(dtype), relu, out_act, dtype, torch.float32, soa_in, soa_out)
    got = fused_mlp_fwd(*args)
    torch.cuda.synchronize()
    tol = dict(rtol=2e-2, atol=2e-3) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, fused_mlp_plain(*args), **tol)
    bargs = (ws, x.to(dtype), g, relu, out_act, dtype, soa_in, soa_out)
    got_dws, got_dx = fused_mlp_bwd(*bargs)
    torch.cuda.synchronize()
    want_dws, want_dx = fused_mlp_bwd_plain(*bargs)
    for a, b in zip(got_dws, want_dws):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) <= mlp_bwd_tol(b, dtype)
    assert got_dx.shape == want_dx.shape and got_dx.dtype == want_dx.dtype
    if soa_out:   # relu_flip_rows takes g as the plain version does
        g = g.t()
    assert_dx_close(got_dx, want_dx, ws, x.to(dtype), g, dtype, soa_in, out_act)


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


# -- the redesigned kernels M (bf16 path) and G ------------------------------

# (width, n_hidden, d_in): every width, depths from 1 to the deepest M
# takes (csrc/mlp_common.cuh: kMaxLayers = 32 layers), config_oneblob's
# 128 -> 128 x 5 -> 3 (weights resident) and the first width-128 depth
# whose weights are staged per layer and tile; input widths that take the
# 16-byte cp.async copies (multiples of 8) and some that do not.
M_BF16_SHAPES = [(16, 1, 3), (16, 31, 19), (32, 2, 32), (32, 31, 32), (64, 3, 40),
                 (64, 31, 40), (128, 1, 128), (128, 2, 64), (128, 5, 128), (128, 6, 128),
                 (128, 31, 128)]
M_LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


def m_chain_of_shallow(ws, x, soa_in, out_dtype, soa_out):
    """The same MLP as a chain of launches of at most six layers: every
    piece but the last ends in a hidden layer (ReLU, bf16 output), which
    M computes with the same products, activation and rounding as the
    hidden layer of the deep launch, so the chain's output has the deep
    launch's bits."""
    relu, bf16 = Activation.RELU, torch.bfloat16
    h, i, first = x, 0, True
    while len(ws) - i >= 7:
        h = fused_mlp_fwd(ws[i:i + 5], h, relu, relu, bf16, bf16, soa_in and first, False)
        i, first = i + 5, False
    return fused_mlp_fwd(ws[i:], h, relu, Activation.NONE, bf16, out_dtype, soa_in and first,
                         soa_out)


@pytest.mark.parametrize("shape", M_BF16_SHAPES, ids=lambda s: f"{s[2]}-{s[0]}x{s[1]}")
@pytest.mark.parametrize("batch", [1, 127, 12345, 1 << 18])
@pytest.mark.parametrize("soa_in,soa_out", M_LAYOUTS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_bf16_kernel_coverage(cuda, shape, batch, soa_in, soa_out, out_dtype):
    """Kernel M's bf16 path at every width and layout, both output dtypes,
    batch tails and depths.  Up to five hidden layers against the plain
    version within the bf16 tolerance, rows beyond it passing only where
    ``rounding_flip_rows`` explains them (as chip_smoke.py holds
    config_oneblob); deeper, where roundings to the other bf16 neighbour
    compound beyond any bound of the plain version, bit for bit against
    the same MLP as a chain of shallow launches (``m_chain_of_shallow``),
    whose pieces the shallow cases hold against the plain version."""
    from tcnn_tpu_torch.tools.plain_path import rounding_flip_rows

    width, n_hidden, d_in = shape
    dims = [(d_in, width)] + [(width, width)] * (n_hidden - 1) + [(width, 3)]
    ws, x, _ = mlp_inputs(cuda, dims, batch, width + n_hidden + batch % 7, soa_in)
    xb = x.to(torch.bfloat16)
    args = (ws, xb, Activation.RELU, Activation.NONE, torch.bfloat16, out_dtype, soa_in, soa_out)
    got = fused_mlp_fwd(*args)
    torch.cuda.synchronize()
    assert got.shape == ((3, batch) if soa_out else (batch, 3)) and got.dtype == out_dtype
    assert bool(torch.isfinite(got.float()).all())
    if n_hidden > 5:
        assert torch.equal(got, m_chain_of_shallow(ws, xb, soa_in, out_dtype, soa_out))
        return
    want = fused_mlp_plain(*args)
    a, b = (got.t(), want.t()) if soa_out else (got, want)
    err = (a.float() - b.float()).abs()
    tol = 2e-2 * b.float().abs() + 2e-3
    rows = (err > tol).any(dim=1).nonzero().flatten()
    if rows.numel():
        explained = rounding_flip_rows(ws, xb, rows, a[rows].float(), tol[rows], soa_in)[0]
        assert bool(explained.all()), f"{int((~explained).sum())} of {rows.numel()} rows " \
                                      "beyond the bf16 bound not explained by another rounding"


def test_fused_mlp_bf16_layout(cuda):
    """Kernel M's bf16 path takes the input and output widths it took
    before its weights stayed resident (up to 432 inputs at width 128, 784
    at width 16, 600 outputs), running fewer warps a CTA where the warps'
    input slices and one layer's weights need it; config_oneblob's
    resident weights and the staged-per-layer depth after it are held by
    ``test_fused_mlp_bf16_kernel_coverage``."""
    for d_in, d_out, width in ((432, 3, 128), (784, 3, 16), (592, 3, 64), (32, 600, 128)):
        ws, x, _ = mlp_inputs(cuda, [(d_in, width), (width, width), (width, d_out)], 999, 3,
                              False)
        args = (ws, x.to(torch.bfloat16), Activation.RELU, Activation.NONE, torch.bfloat16,
                torch.float32)
        torch.testing.assert_close(fused_mlp_fwd(*args), fused_mlp_plain(*args), rtol=2e-2,
                                   atol=2e-3)


G_HASHES = [HashType.COHERENT_PRIME, HashType.COHERENT_ADD, HashType.PRIME]


def corner_order_sum(spec, flat, x, live):
    """Kernel G's arithmetic in torch ops: per live level and feature, the
    sum over corners 0 .. 2^D - 1 in order, each term w·v and each sum one
    fp32 rounding (separate multiply and add kernels), cast to the table's
    dtype; (L·F, B), zero rows for dead levels.  The plain version's
    ``sum(dim=1)`` may take the corners in another order on the card."""
    F, C, B = spec.n_features_per_level, 1 << spec.n_dims, x.shape[0]
    idx, ws = grid_ops.build_indices_weights(spec, x, live)
    rows = idx.reshape(len(live), C, B)
    ws = ws.reshape(len(live), C, B)
    table = flat.reshape(-1, F).float()
    acc = torch.zeros((len(live), B, F), device=x.device)
    for c in range(C):
        acc = acc + ws[:, c, :, None] * table[rows[:, c]]
    out = torch.zeros((spec.n_levels, F, B), device=x.device)
    out[list(live)] = acc.permute(0, 2, 1)
    return out.reshape(-1, B).to(flat.dtype)


def assert_grid_sum_close(got, want, n_dims):
    """G against the plain version where their fp32 corner sums run in
    different orders: one bf16 ulp (or rtol 1e-5 for fp32 tables) plus the
    sums' own error, (2^D + 2D)·2^-24 of Σ|w·v| <= 1 for U(±1) tables, that
    a value the terms cancel to near 0 carries (chip_smoke.py's bound at
    config_btf)."""
    atol = ((1 << n_dims) + 2 * n_dims) * 2.0 ** -24
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        bound = bf16_ulp(want) + atol
    else:
        bound = 1e-5 * want.abs() + atol
    worst = int((err / bound).argmax())
    assert bool((err <= bound).all()), (float(want.flatten()[worst]),
                                        float(got.flatten()[worst]))


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid,hash_type", [(GridType.HASH, h) for h in G_HASHES]
                         + [(GridType.DENSE, HashType.COHERENT_PRIME)])
def test_grid_encode_kernel_every_level_kind(cuda, D, F, dtype, grid, hash_type):
    """Kernel G at every D, F, table dtype and level kind (dense levels,
    whose dim-0 corner pairs lie on rows r, r + 1; CoherentAdd on r, r + 1
    mod a power of two; CoherentPrime on r, r ^ 1 from an even cell,
    elsewhere from an odd one), its rows from per-dim terms, with cells on
    both sides of 0 and of the grid's end (x in [-0.3, 1.3]), a strided
    input and an odd batch, every level live and all but the first three
    dead (zeros), SoA and AoS output (levels grouped by sector where the
    level count allows, 8 levels, and one by one where it does not, 4):
    bit for bit against its own sum order in torch ops
    (``corner_order_sum``), and against the plain version within the bound
    of two sum orders."""
    n_levels = 8 if grid == GridType.HASH else 4   # dense 4-D levels grow as res^4
    spec = grid_ops.make_grid_spec(D, n_levels, F, 12, 4, 1.7, grid_type=grid,
                                   hash_type=hash_type)
    rng = np.random.default_rng(D * 100 + F)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    wide = torch.from_numpy(rng.uniform(-0.3, 1.3, (5003, D + 2)).astype(np.float32)).to(cuda)
    x = wide[:, 1:1 + D]
    cell0 = torch.floor(x[:, 0] * spec.levels[-1].scale + 0.5).long()
    assert bool((cell0 % 2 == 0).any()) and bool((cell0 % 2 == 1).any())
    for live in (list(range(spec.n_levels)), [0, 1, 2]):
        for soa in (True, False):
            got = grid_encode_fwd(spec, flat, x, live, soa=soa)
            torch.cuda.synchronize()
            want = grid_encode_plain(spec, flat, x, live, soa=soa)
            assert got.shape == want.shape and got.dtype == want.dtype == dtype
            assert torch.equal(got if soa else got.t(), corner_order_sum(spec, flat, x, live))
            assert_grid_sum_close(got, want, D)
            if live == [0, 1, 2]:
                dead = (got if soa else got.t())[3 * F:]
                assert not bool(dead.any())


def test_grid_encode_kernel_at_the_level_wrap(cuda):
    """The 4-D dense levels of make_grid_spec(4, 4, 2, 12, 4, 1.5) with x in
    [-0.2, 1.2]: corners past the grid's end wrap to the level's first
    rows, where the dim-0 pair does not share a unit (the JAX package's
    pair route differs there, ROADMAP Queue 3; the port follows the plain
    version)."""
    spec = grid_ops.make_grid_spec(4, 4, 2, 12, 4, 1.5)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (4133, 4)).astype(np.float32)).to(cuda)
    idx, _ = grid_ops.build_indices_weights(spec, x, [0])
    rows = idx.reshape(16, -1) - spec.levels[0].offset
    assert bool(((rows[1::2] == 0) & (rows[0::2] == spec.levels[0].size - 1)).any())
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
        flat = flat.to(dtype).to(cuda)
        live = list(range(spec.n_levels))
        got = grid_encode_fwd(spec, flat, x, live)
        assert torch.equal(got.t(), corner_order_sum(spec, flat, x, live))
        assert_grid_sum_close(got, grid_encode_plain(spec, flat, x, live), 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_encode_kernel_is_bit_identical_to_plain_at_config_hash(cuda, dtype):
    """At config_hash's grid (2-D, CoherentPrime, F = 2) G sums each
    sample's four corners in the plain version's order and rounding: the
    same bits (chip_smoke.py's max_abs_err 0.0)."""
    model = create_from_config(2, 3, "configs/config_hash.json", policy=BF16_POLICY)
    spec = model.network.encoding.spec
    rng = np.random.default_rng(23)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    x = torch.from_numpy(rng.uniform(0, 1, ((1 << 16) + 5, 2)).astype(np.float32)).to(cuda)
    live = list(range(spec.n_levels))
    assert torch.equal(grid_encode_fwd(spec, flat, x, live, soa=True),
                       grid_encode_plain(spec, flat, x, live, soa=True))


# -- the NeRF field (slice 8): the per-sample level mask, the MLPs' shapes ----

NERF_BATCH = 4096 * 48   # the sample's 2^12 rays x 48 samples a step


def masked_corner_order_sum(spec, flat, x, live, frac):
    """``corner_order_sum`` with the per-sample mask: G's arithmetic, the
    masked (sample, level) pairs adding nothing."""
    F, C, B = spec.n_features_per_level, 1 << spec.n_dims, x.shape[0]
    idx, ws = grid_ops.build_indices_weights(spec, x, live, level_frac=frac)
    rows, ws = idx.reshape(len(live), C, B), ws.reshape(len(live), C, B)
    table = flat.reshape(-1, F).float()
    acc = torch.zeros((len(live), B, F), device=x.device)
    for c in range(C):
        acc = acc + ws[:, c, :, None] * table[rows[:, c]]
    out = torch.zeros((spec.n_levels, F, B), device=x.device)
    out[list(live)] = acc.permute(0, 2, 1)
    return out.reshape(-1, B).to(flat.dtype)


def spread_fractions(rng, n, n_levels):
    """Per-sample level fractions over [0, 1], a third of them on the level
    boundaries k / n_levels (0 and 1 included)."""
    frac = rng.uniform(0, 1, n).astype(np.float32)
    on = rng.random(n) < 1 / 3
    frac[on] = (rng.integers(0, n_levels + 1, int(on.sum())) / n_levels).astype(np.float32)
    return frac


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid,hash_type", [(GridType.HASH, h) for h in G_HASHES]
                         + [(GridType.DENSE, HashType.COHERENT_PRIME),
                            (GridType.TILED, HashType.COHERENT_PRIME)])
def test_grid_kernels_with_a_per_sample_mask_match_plain(cuda, D, F, dtype, grid, hash_type):
    """G, GB and GI with per-sample level fractions spread over [0, 1] (a
    third on the level boundaries), at every D, F, table dtype and level
    kind, all levels live and the static cutoff at 3 on top: G bit for bit
    against its own corner order with the masked pairs left out, in both
    layouts (8 levels of AoS bf16 F = 2 take the whole-sector stores, a
    masked level inside a sector), masked pairs exact zeros; GB and GI
    against their masked plain versions within the bounds of the unmasked
    tests, a table row only masked samples touch an exact zero."""
    n_levels = 8 if grid != GridType.DENSE else 4
    spec = grid_ops.make_grid_spec(D, n_levels, F, 12, 4, 1.7, grid_type=grid,
                                   hash_type=hash_type)
    rng = np.random.default_rng(D * 1000 + F * 10 + int(dtype == torch.bfloat16))
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    B = 5003
    x = torch.from_numpy(rng.uniform(-0.3, 1.3, (B, D)).astype(np.float32)).to(cuda)
    frac = torch.from_numpy(spread_fractions(rng, B, n_levels)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(n_levels * F, B)).astype(np.float32))
    dcols = dcols.to(dtype).to(cuda)
    check_masked_grid_kernels(cuda, spec, flat, x, frac, dcols)


def check_masked_grid_kernels(cuda, spec, flat, x, frac, dcols):
    """G, GB and GI under the mask ``frac``, all levels live and the static
    cutoff at 3 on top, held as ``test_grid_kernels_with_a_per_sample_mask_match_plain``
    says."""
    n_levels, F, D, B = spec.n_levels, spec.n_features_per_level, spec.n_dims, x.shape[0]
    keep = (torch.arange(n_levels, device=cuda)[:, None].float()
            < frac[None, :] * float(n_levels) + 1e-3)            # (L, B)
    for live in (list(range(n_levels)), [0, 1, 2]):
        dead = ~keep.clone()
        dead[len(live):] = True
        for soa in (True, False):
            got = grid_encode_fwd(spec, flat, x, live, soa=soa, level_frac=frac)
            torch.cuda.synchronize()
            cols = got if soa else got.t()
            assert torch.equal(cols, masked_corner_order_sum(spec, flat, x, live, frac))
            assert_grid_sum_close(got, grid_encode_plain(spec, flat, x, live, soa=soa,
                                                         level_frac=frac), D)
            assert not bool(cols.reshape(n_levels, F, B)[dead[:, None, :].expand(-1, F, -1)]
                            .any())
        got = grid_encode_bwd(spec, flat, x, dcols, live, level_frac=frac)
        torch.cuda.synchronize()
        want = grid_encode_bwd_plain(spec, flat, x, dcols, live, level_frac=frac)
        scale = grid_encode_bwd_plain(spec, flat.float(), x, dcols.float().abs(), live,
                                      level_frac=frac)
        assert_grid_grad_close(got, want, scale)
        assert bool((got[scale == 0] == 0).all())
        gi = grid_encode_bwd_input(spec, flat, x, dcols, live, level_frac=frac)
        torch.cuda.synchronize()
        assert_rel_close(gi, grid_encode_bwd_input_plain(spec, flat, x, dcols, live,
                                                         level_frac=frac), 1e-5)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_kernels_with_a_mask_shared_by_runs_of_samples(cuda, D, dtype):
    """G, GB and GI where runs of 512 consecutive samples share one level
    fraction, as the NeRF sample gives one to every sample of a step: whole
    warps skip a level that none of their samples keeps, next to warps
    that run it (the fractions on the level boundaries and between them)."""
    spec = grid_ops.make_grid_spec(D, 8, 2, 12, 4, 1.7)
    rng = np.random.default_rng(D * 7 + int(dtype == torch.bfloat16))
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    B = 8 * 512 + 77
    x = torch.from_numpy(rng.uniform(-0.3, 1.3, (B, D)).astype(np.float32)).to(cuda)
    runs = np.concatenate([np.arange(9) / 8, rng.uniform(0, 1, 1)]).astype(np.float32)
    frac = torch.from_numpy(np.repeat(rng.permutation(runs), 512)[:B]).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(8 * 2, B)).astype(np.float32)).to(dtype).to(cuda)
    check_masked_grid_kernels(cuda, spec, flat, x, frac, dcols)


def exact_sum_inputs(cuda, D, F, B, seed):
    """A grid and inputs whose every sum is exact in fp32 in any order: the
    scales 2^l · 4 − 1 are integers, x is a multiple of 1/16 and dcols of
    1/4, so each weight is a multiple of 1/16^D, each product w·dy of
    1/(4·16^D), and each table row's sum stays below 2^(24 − 2 − 4D)."""
    spec = grid_ops.make_grid_spec(D, 6, F, 12, 4, 2.0)
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 17, (B, D)) / 16).astype(np.float32)
    dc = (rng.integers(-4, 5, (6 * F, B)) / 4).astype(np.float32)
    return spec, torch.from_numpy(x).to(cuda), torch.from_numpy(dc).to(cuda)


@pytest.mark.parametrize("D,F", [(2, 2), (3, 2), (3, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_kernels_without_a_mask_keep_their_bits(cuda, D, F, dtype):
    """Without a mask G and GB run the code they ran before the mask came:
    G equals its corner order (``corner_order_sum``) bit for bit, as the
    unmasked design did, and with a mask that keeps every level it equals
    it too; GB on inputs whose sums are exact in any order equals
    the plain version bit for bit, which any correct order of the atomics
    gives (``tools/kernel_ablation.py --baseline`` compares both with
    another checkout's package)."""
    spec, x, dc = exact_sum_inputs(cuda, D, F, 3001, seed=D + F)
    rng = np.random.default_rng(D * F)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    live = list(range(spec.n_levels))
    ones = torch.ones(x.shape[0], device=cuda)
    for soa in (True, False):
        got = grid_encode_fwd(spec, flat, x, live, soa=soa)
        assert torch.equal(got if soa else got.t(), corner_order_sum(spec, flat, x, live))
        assert torch.equal(got, grid_encode_fwd(spec, flat, x, live, soa=soa, level_frac=ones))
    dtable = torch.zeros_like(flat)
    got = grid_encode_bwd(spec, dtable, x, dc.to(dtype), live)
    torch.cuda.synchronize()
    assert torch.equal(got, grid_encode_bwd_plain(spec, dtable, x, dc.to(dtype), live))
    assert torch.equal(got, grid_encode_bwd(spec, dtable, x, dc.to(dtype), live,
                                            level_frac=ones))


NERF_MLPS = {"density 24 -> 64 -> 16": ([(24, 64), (64, 16)], Activation.NONE),
             "colour 31 -> 64 x 2 -> 3, Sigmoid": ([(31, 64), (64, 64), (64, 3)],
                                                   Activation.SIGMOID)}


@pytest.mark.parametrize("shape", sorted(NERF_MLPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("soa_in,soa_out", [(True, False), (False, False), (False, True)])
@pytest.mark.parametrize("batch", [1, 127, 12345, NERF_BATCH])
def test_fused_mlp_kernels_at_the_nerf_shapes(cuda, shape, dtype, soa_in, soa_out, batch):
    """M and MB at the NeRF sample's two MLPs: one hidden layer and 16
    outputs (the density net, SoA grid features in), and 31 inputs, off
    the aligned input paths (async_x, 16-byte rows), with a Sigmoid output
    (the colour net, AoS in); both dtypes and layouts, at batch edges up to
    the sample's 196,608 points."""
    dims, out_act = NERF_MLPS[shape]
    check_m_and_mb(cuda, dims, batch, dtype, seed=batch % 89, soa_in=soa_in, out_act=out_act,
                   soa_out=soa_out)


def test_fused_mlp_dx_into_a_strided_slice(cuda):
    """The NeRF path's colour-net input is (h[:, 1:] of the density net's
    (B, 16) output, view direction): MB's 31-column dx flows back through
    the Composite into that strided slice, and the density net's MB takes
    it; the whole chain against the plain versions
    (``plain_nerf_field_grads``), at the fp32 policy and MB's fp32
    tolerance, 1e-4 of each gradient's largest magnitude.  (In bf16 a
    density-net ReLU that rounding switches moves a sample's whole dx row,
    and at 4133 samples a table entry takes few updates: chip_smoke.py
    holds the bf16 step on the sample's own loss at 196,608 points.)"""
    from tcnn_tpu_torch.samples import fit_nerf_field as nf

    d_net, c_net = nf.build_model(DEFAULT_POLICY, torch.Generator().manual_seed(3), cuda)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (4133, 3)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(4133, 3)).astype(np.float32)).to(cuda)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    from tcnn_tpu_torch.tools.plain_path import plain_nerf_field_grads

    def loss_of(sigma, rgb):
        return (sigma * 0.01).sum() + (rgb * torch.arange(1, 4, device=cuda)).sum()

    sigma, rgb = nf.model_field(d_net, c_net, x, v, 0.6)
    params, _ = nf.params_and_layout(d_net, c_net)
    grads = dict(zip(params, torch.autograd.grad(loss_of(sigma, rgb), list(params.values()))))
    _, want = plain_nerf_field_grads(d_net, c_net, x, v, 0.6, loss_of)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert_rel_close(g, want[name], 1e-4)

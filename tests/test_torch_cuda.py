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
  * grid input gradient (GI) and second order (GG): d_dcols and d_x
    within 1e-5 of their largest magnitude (fp32 sums over corners and
    levels in another order; for bf16 tables both read the same bf16
    values); GG's table gradient per entry within 2^-11 of S, S the sum of
    the magnitudes of the terms of its updates (``gg_table_scale``: fp32
    atomics in any order, and Σ|g| is not sound where a g's terms cancel),
    plus one bf16 ulp for bf16 tables;
  * row scatter-add (RS): per entry within 2^-11 of S = Σ|g| over its
    updates (fp32 atomics in any order), plus one bf16 ulp for bf16 output;
  * the SDF sample's eikonal step: the table gradient per entry within
    2^-11 of S = Σ|terms| (GB's and GG's atomics), the weights' gradients
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
from tcnn_tpu_torch.tools.plain_path import (gg_rows_and_g, gg_table_scale,
                                             plain_loss_and_grads, plain_sdf_loss_and_grads,
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


def assert_grid_close(got, want, sum_atol=0.0):
    """``sum_atol``: the fp32 corner sum's own error, added to a bf16
    output's ulp (``chip_smoke.py``'s grid bound)."""
    if want.dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs()
        assert bool((err <= bf16_ulp(want) + sum_atol).all()), float(err.max())
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
    # more than 8 features a level: the run-time-D instances, in groups of 8
    (3, 16, 12, 4, 1.6, GridType.HASH, HashType.COHERENT_PRIME, InterpolationType.SMOOTHSTEP),
    (2, 12, 11, 8, 1.5, GridType.HASH, HashType.COHERENT_ADD, InterpolationType.LINEAR),
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
    # more than 8 features a level: many more outputs, and where a sum's
    # corner terms cancel to near 0 the fp32 sum's own error, (2^D + 2D)·2^-24
    # with U(±1) rows, is many bf16 ulps of it (chip_smoke.py's bound)
    sum_atol = ((1 << D) + 2 * D) * 2.0 ** -24 if F > 8 else 0.0
    for live in (list(range(spec.n_levels)), [0, 1, 2]):
        got = grid_encode_fwd(spec, flat, x, live, soa=soa)
        torch.cuda.synchronize()
        want = grid_encode_plain(spec, flat, x, live, soa=soa)
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        assert_grid_close(got, want, sum_atol)


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
    4, through kernels GI and GG (which adds the table gradient itself: no
    RS); since slice 14 the second order keeps its graph under
    ``create_graph`` (a third derivative can follow): finite, and within
    1e-4 of each largest magnitude of the plain path's (the model's copy on
    the CPU)."""
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
    # GI once, for gx: the second pass goes back through the features too
    # (the loss's output gradient 2y depends on x), but autograd.grad(...,
    # params) uses no x part there, and the grid's backward asks the engine
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 0]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    kept = torch.autograd.grad(gx.square().sum(), params, create_graph=True)
    assert all(bool(torch.isfinite(g).all()) for g in kept)
    # the plain path: the same model's copy on the CPU (the plain versions)
    cpu = create_from_config(2, 3, "configs/config_hash.json", device="cpu")
    with torch.no_grad():
        for a, b in zip(cpu.network.parameters(), params):
            a.copy_(b.cpu())
    xc = x.detach().cpu().requires_grad_()
    (gxc,) = torch.autograd.grad(cpu.network(xc).square().sum(), xc, create_graph=True)
    want = torch.autograd.grad(gxc.square().sum(), list(cpu.network.parameters()),
                               create_graph=True)
    for a, b in zip(kept, want):
        assert_rel_close(a.detach().cpu(), b.detach(), 1e-4)


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


def check_second_order(spec, flat, x, dcols, ddx, live, frac=None, shard=None):
    """Kernel GG against its plain version: d_dcols and d_x within 1e-5 of
    their largest magnitude (both exact zeros where the plain ones are:
    Nearest, and Linear's d_x at one dim), the table gradient per entry
    within 2^-11·S (``gg_table_scale``) and exact zeros on the rows no
    update reaches; d_dcols and d_x bit for bit in a second launch."""
    got = grid_encode_bwd_bwd(spec, flat, x, dcols, ddx, live, level_frac=frac, shard=shard)
    again = grid_encode_bwd_bwd(spec, flat, x, dcols, ddx, live, level_frac=frac, shard=shard)
    torch.cuda.synchronize()
    want = grid_encode_bwd_bwd_plain(spec, flat, x, dcols, ddx, live, level_frac=frac,
                                     shard=shard)
    assert torch.equal(got.d_dcols, again.d_dcols) and torch.equal(got.d_x, again.d_x)
    for a, b in ((got.d_dcols, want.d_dcols), (got.d_x, want.d_x)):
        if float(b.abs().max()) == 0:
            assert float(a.abs().max()) == 0
        else:
            assert_rel_close(a, b, 1e-5)
    scale = gg_table_scale(spec, x, dcols, ddx, live, frac, shard)
    assert got.d_flat.dtype == want.d_flat.dtype == flat.dtype
    assert_scatter_close(got.d_flat, want.d_flat, scale)
    assert bool((got.d_flat[scale == 0] == 0).all())
    return got


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
            got = check_second_order(spec, flat, x, dc, ddx, live)
            if interp == InterpolationType.NEAREST:   # w' = 0: no update at all
                assert float(got.d_dcols.abs().max()) == float(got.d_flat.abs().max()) == 0
            if interp == InterpolationType.NEAREST or (
                    interp == InterpolationType.LINEAR and D == 1):
                assert float(got.d_x.abs().max()) == 0


@pytest.mark.parametrize("case", GRID_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_grid_kernels_in_shard_mode_match_plain(cuda, case, dtype, n):
    """G, GB, GI and GG in shard mode (each rank's block-cyclic shard of n)
    against their plain versions at the same shard, at the bounds above
    (GG's table gradient has the shard's rows; another shard's corners
    add nothing).  The
    shards' G and GI partials sum to the unsharded kernel's output (within
    the grid bounds, fp32 sums of other parts), and their GB gradients are
    the block-cyclic slices of the unsharded gradient's rows.  G's partial
    features are fp32 for either table dtype: within 1e-5 of the plain
    value plus the fp32 sum's own error, (2^D + 2D)·2^-24 with U(±1) rows
    (a shard's partial sums cancel near 0 more often than whole ones)."""
    D, F, hm, base, scale, gtype, htype, interp = case
    spec = grid_ops.make_grid_spec(D, 8, F, hm, base, scale, grid_type=gtype,
                                   hash_type=htype, interpolation=interp)
    assert grid_ops.shardable_levels(spec, n)
    rng = np.random.default_rng(12)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    x = torch.from_numpy(rng.uniform(0.02, 0.98, (4133, D)).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(8 * F, 4133)).astype(np.float32)).to(cuda)
    ddx = torch.from_numpy(rng.normal(size=(4133, D)).astype(np.float32)).to(cuda)
    perm = torch.from_numpy(grid_ops.block_cyclic_perm(spec, n)).to(cuda)
    shards = flat[perm].chunk(n)
    live = list(range(spec.n_levels))
    fwd_sum = torch.zeros(8 * F, 4133, device=cuda)
    dx_sum = torch.zeros(4133, D, device=cuda)
    grads = []
    sum_atol = ((1 << D) + 2 * D) * 2.0 ** -24
    for sid in range(n):
        t, sh = shards[sid].clone(), (sid, n)   # a fresh, 16-byte aligned table
        for soa in (True, False):
            got = grid_encode_fwd(spec, t, x, live, soa=soa, shard=sh)
            torch.cuda.synchronize()
            want = grid_encode_plain(spec, t, x, live, soa=soa, shard=sh)
            assert got.dtype == want.dtype == torch.float32
            assert bool(((got - want).abs() <= 1e-5 * want.abs() + sum_atol).all())
        fwd_sum += got.t()
        got = grid_encode_bwd(spec, t, x, dcols, live, shard=sh)
        torch.cuda.synchronize()
        want = grid_encode_bwd_plain(spec, t, x, dcols, live, shard=sh)
        scale_ = grid_encode_bwd_plain(spec, t.float(), x, dcols.abs(), live, shard=sh)
        assert_scatter_close(got, want, scale_)
        grads.append(got)
        got = grid_encode_bwd_input(spec, t, x, dcols, live, shard=sh)
        torch.cuda.synchronize()
        want = grid_encode_bwd_input_plain(spec, t, x, dcols, live, shard=sh)
        if interp != InterpolationType.NEAREST:
            assert_rel_close(got, want, 1e-5)
        dx_sum += got
        rows, _ = gg_rows_and_g(spec, x, dcols, ddx, live, shard=sh)
        assert bool((rows >= 0).any()) and bool((rows < 0).any())
        got = check_second_order(spec, t, x, dcols, ddx, live, shard=sh)
        assert got.d_flat.numel() == spec.n_params // n
    whole = grid_encode_fwd(spec, flat, x, live)
    if dtype == torch.bfloat16:   # the sum rounded once, as the whole kernel's
        err = (fwd_sum.t().to(dtype).float() - whole.float()).abs()
        assert bool((err <= bf16_ulp(whole) + n * sum_atol).all())
    else:
        assert bool(((fwd_sum.t() - whole).abs() <= 1e-5 * whole.abs() + n * sum_atol).all())
    if interp != InterpolationType.NEAREST:
        assert_rel_close(dx_sum, grid_encode_bwd_input(spec, flat, x, dcols, live), 1e-5)
    whole = grid_encode_bwd(spec, flat, x, dcols, live)
    scale_ = grid_encode_bwd_plain(spec, flat.float(), x, dcols.abs(), live)
    assert_scatter_close(torch.cat(grads), whole[perm], scale_[perm])


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
    it launches GI and GG once each and RS never."""
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
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 0]
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
                   soa_out=False, dw_rel_l2=False):
    """M and MB against their plain versions at the stated tolerances,
    ReLU hidden layers; ``dw_rel_l2``: a bf16 dW within 2e-2 in relative L2
    norm instead of 2e-2 of its largest magnitude."""
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
        if dw_rel_l2 and dtype == torch.bfloat16:
            assert float((a - b).norm() / b.norm()) <= 2e-2
        else:
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
    so (fp32 beyond depth 8, bf16 beyond 10), MB runs as launches over runs
    of layers (``fused_mlp_bwd_segmented``), one per run, M giving the
    activations at their boundaries.  bf16 stops at depth 3 (non-resident
    at width 128): over eight bf16 layers a hidden value rounded to the
    other bf16 neighbour compounds beyond the bf16 bound in M's output too,
    so depth 8 is held in fp32 (dx rows and dW at the MB bounds), and at
    bf16 depth 11 dW within 2e-2 of each largest magnitude and dx within
    2e-2 in relative L2 norm: a hidden value that rounds to the other bf16
    neighbour, or a ReLU it switches, moves a whole dx row, and over
    eleven layers such rows are more than a switched ReLU explains
    (chip_smoke.py holds the same at 12 hidden layers)."""
    from tcnn_tpu_torch.ops.cuda import kernels

    dims = [(32, width)] + [(width, width)] * (n_hidden - 1) + [(width, 3)]
    relu = list(Activation).index(Activation.RELU)
    smem = kernels().fused_mlp_bwd_smem_bytes(32, 3, width, len(dims),
                                              dtype == torch.bfloat16, relu, 0)
    if smem > 232448:
        assert width == 128 and n_hidden == MAX_HIDDEN_128[dtype] + 1
        ws, x, g = mlp_inputs(cuda, dims, 4133, 12, False)
        before = fused_mlp_bwd.launches
        got_dws, got_dx = fused_mlp_bwd(ws, x.to(dtype), g, Activation.RELU, Activation.NONE,
                                        dtype)
        torch.cuda.synchronize()
        assert fused_mlp_bwd.launches - before == 2
        want_dws, want_dx = fused_mlp_bwd_plain(ws, x.to(dtype), g, Activation.RELU,
                                                Activation.NONE, dtype)
        for a, b in zip(got_dws, want_dws):
            assert float((a - b).abs().max()) <= mlp_bwd_tol(b, dtype)
        assert got_dx.dtype == dtype
        if dtype == torch.float32:
            assert_dx_close(got_dx, want_dx, ws, x, g, dtype, False)
            args = (ws, x, Activation.RELU, Activation.NONE, dtype, torch.float32)
            torch.testing.assert_close(fused_mlp_fwd(*args), fused_mlp_plain(*args),
                                       rtol=1e-5, atol=1e-5)
        else:
            diff = (got_dx.float() - want_dx.float()).norm()
            assert float(diff) <= 2e-2 * float(want_dx.float().norm())
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
@pytest.mark.parametrize("F", [1, 2, 4, 8, 12, 16])
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


# -- slice 9: serving graphs, optimizers on the card --------------------------

HASH_CONFIG = "configs/config_hash.json"
_ADAM = {"otype": "Adam", "learning_rate": 1e-2, "beta2": 0.99, "epsilon": 1e-15,
         "l2_reg": 1e-6}
CARD_OPTIMIZERS = {
    "SGD": {"otype": "SGD", "learning_rate": 1e-1},
    "Novograd": {"otype": "Novograd", "learning_rate": 1e-2},
    "EMA": {"otype": "EMA", "decay": 0.9, "nested": _ADAM},
    "Average": {"otype": "Average", "n_samples": 8, "nested": _ADAM},
    "Batched": {"otype": "Batched", "batch_size_multiplier": 4, "nested": _ADAM},
    "Lookahead": {"otype": "Lookahead", "alpha": 0.5, "n_steps": 6, "nested": _ADAM},
    "ExponentialDecay": {"otype": "ExponentialDecay", "decay_base": 0.5, "decay_start": 5,
                         "decay_end": 19, "decay_interval": 7, "nested": _ADAM},
    "Composite": {"otype": "Composite", "nested": [
        _ADAM, {"otype": "SGD", "learning_rate": 1e-1, "params": "other"}]},
    "Shampoo": {"otype": "Shampoo", "learning_rate": 1e-2},
}


def _hash_config(opt):
    from tcnn_tpu_torch import load_config

    return {**load_config(HASH_CONFIG), "optimizer": opt}


def _image_batches(n, batch=4096):
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image

    sampler = ImageSampler(synthetic_image(128, 128), seed=1)
    return [sampler.sample_batch(batch) for _ in range(n)]


@pytest.mark.parametrize("policy", [BF16_POLICY, DEFAULT_POLICY])
def test_serving_graphs_match_inference_and_the_plain_path(cuda, policy):
    """Each bucket's graph replay equals ``Trainer.inference`` bit for bit
    (G and M compute each row alone) and the plain path within the model
    tolerance; a bundle written on the CPU serves the same on the card."""
    import types

    from tcnn_tpu_torch import serving
    from tcnn_tpu_torch.tools.plain_path import plain_inference

    model = create_from_config(2, 3, HASH_CONFIG, policy=policy)
    with torch.no_grad():
        model.network.encoding.grid.uniform_(-1, 1, generator=torch.Generator(cuda).manual_seed(0))
    def launches():
        return fused_mlp_fwd.launches, grid_encode_fwd.launches

    before = launches()
    srv = serving.load_inference(serving.export_inference(model.trainer,
                                                          batch_sizes=(64, 1024, 4133)))
    after = launches()
    assert (after[0] - before[0], after[1] - before[1]) == (4, 4)   # warm-up, 3 captures
    cpu_model = create_from_config(2, 3, HASH_CONFIG, policy=policy, device="cpu")
    cpu_model.trainer.deserialize(model.trainer.serialize())
    from_cpu = serving.load_inference(serving.export_inference(cpu_model.trainer,
                                                               batch_sizes=(4133,)))
    assert from_cpu.platforms == ("cpu",) and srv.platforms == ("cuda",)
    gen = torch.Generator(cuda).manual_seed(1)
    tol = (2e-2, 2e-3) if policy is BF16_POLICY else (1e-5, 1e-5)
    for b in (1, 63, 64, 65, 1000, 1024, 4133):
        x = torch.rand((b, 2), generator=gen, device=cuda)
        before = launches()
        got, got_cpu_bundle = srv(x), from_cpu(x)
        assert launches() == before   # requests replay graphs: no wrapper call
        assert torch.equal(got, model.trainer.inference(x)), b
        assert torch.equal(got_cpu_bundle, got), b
        want = plain_inference(types.SimpleNamespace(network=srv.model), x)
        torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("name", list(CARD_OPTIMIZERS))
def test_optimizer_step_on_the_card_matches_the_cpu(cuda, name):
    """One step with the same parameters, gradients and state (after two
    steps): counters equal, every float leaf within rtol 1e-5 plus 1e-6 of
    its largest magnitude (Shampoo 1e-4 plus 1e-5: fp32 matrix products).
    Shampoo's roots, refreshed on the card at t = 10, against float64 roots
    of the same matrices within ``root_error_bound``."""
    from tcnn_tpu_torch.optimizers.base import named_leaves
    from tcnn_tpu_torch.optimizers.shampoo import inverse_4th_root_psd, root_error_bound

    cfg = _hash_config(CARD_OPTIMIZERS[name])
    card = create_from_config(2, 3, cfg, policy=BF16_POLICY)
    for x, t in _image_batches(2):
        card.trainer.training_step(x, t)
    cpu = create_from_config(2, 3, cfg, policy=BF16_POLICY, device="cpu")
    cpu.trainer.deserialize(card.trainer.serialize())
    x, t = _image_batches(1)[0]
    _, grads = card.trainer.loss_value_and_grads(x, t)
    card.optimizer.step(card.trainer.opt_state, grads, card.trainer.params())
    cpu.optimizer.step(cpu.trainer.opt_state, {n: g.cpu() for n, g in grads.items()},
                       cpu.trainer.params())
    rtol, scale = (1e-4, 1e-5) if name == "Shampoo" else (1e-5, 1e-6)
    for tree in ("params", "opt_state"):
        a = card.trainer.params() if tree == "params" else card.trainer.opt_state
        b = cpu.trainer.params() if tree == "params" else cpu.trainer.opt_state
        for (n, ga), (_, gb) in zip(named_leaves(a), named_leaves(b)):
            ga = ga.detach().cpu()
            if not gb.is_floating_point():
                assert torch.equal(ga, gb), n
            else:
                gb = gb.detach()
                torch.testing.assert_close(ga, gb, rtol=rtol,
                                           atol=scale * float(gb.abs().max()) + 1e-30)
    if name == "Shampoo":
        for x, t in _image_batches(10)[3:]:
            card.trainer.training_step(x, t)
        assert int(card.trainer.opt_state["step"]) == 10
        for st in card.trainer.opt_state["mat"].values():
            for k in ("L", "R") if st else ():
                want = inverse_4th_root_psd(st[k].double(), 0.01)
                err = float((st[k + "_root"].double() - want).abs().max())
                assert err <= root_error_bound(st[k], 0.01), (k, err)


@pytest.mark.parametrize("name", [n for n in CARD_OPTIMIZERS if n != "Shampoo"])
def test_optimizer_graph_loop_equals_eager_steps(cuda, name):
    """20 replayed steps against 20 eager ones cross every period and
    boundary of the configs above: the losses within 1e-3 relative (GB's
    atomics), the step counters and ExponentialDecay's factor equal, but
    for a lazy counter's entries whose recorded gradients differ between
    the runs (GB's atomics, under Batched), where each run's counter is
    the count its own gradients give (``tools/replay_check.py``)."""
    from tcnn_tpu_torch.tools.replay_check import (counter_mismatches, nested_interval,
                                                   record_gradients)

    cfg = _hash_config(CARD_OPTIMIZERS[name])
    pair = [create_from_config(2, 3, cfg, policy=BF16_POLICY) for _ in range(2)]
    rec = [record_gradients(m.trainer, 20) for m in pair]
    batches = _image_batches(20)
    got = pair[0].trainer.make_training_loop(lambda i: batches[i], 20)()
    want = torch.stack([pair[1].trainer.training_step(x, t) for x, t in batches])
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0)
    assert [int(i) for _, i in rec] == [20, 20]
    failed, odd = counter_mismatches(pair[0].trainer.opt_state, pair[1].trainer.opt_state,
                                     rec[0][0], rec[1][0], nested_interval(pair[0].optimizer))
    assert not failed, (failed, odd)


def test_shampoo_loop_refuses_capture_on_the_card(cuda):
    model = create_from_config(2, 3, _hash_config(CARD_OPTIMIZERS["Shampoo"]),
                               policy=BF16_POLICY)
    x, t = _image_batches(1)[0]
    with pytest.raises(RuntimeError, match="cannot be captured"):
        model.trainer.make_training_loop(lambda i: (x, t), 2)()
    assert bool(torch.isfinite(model.trainer.training_step(x, t)))


def test_exported_train_step_replays_on_the_card(cuda):
    from tcnn_tpu_torch import serving

    cfg = _hash_config(CARD_OPTIMIZERS["EMA"])
    model = create_from_config(2, 3, cfg, policy=BF16_POLICY)
    live = create_from_config(2, 3, cfg, policy=BF16_POLICY)
    step = serving.load_train_step(serving.export_train_step(model.trainer, 4096))
    state = model.trainer.serialize()
    live.trainer.deserialize(state)
    batches = _image_batches(6)
    got = []
    for x, t in batches:
        state, loss = step(state, x, t)
        got.append(loss)
    want = torch.stack([live.trainer.training_step(x, t) for x, t in batches])
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-3, atol=0)
    assert state["step"] == live.trainer.step == 6


# -- slice 10: kernel GI redesigned; the torch-module bindings ---------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "strided x, AoS dcols"])
def test_grid_input_gradient_kernel_at_the_sdf_shape(cuda, dtype, masked, layout):
    """GI at the SDF sample's grid (3-D Smoothstep HashGrid 8 x 2, 2^15-row
    tables) and B = 2^18: against its plain version within 1e-5 of the
    largest magnitude (fp32 sums in another order), with and without a
    per-sample level mask, x contiguous or a column slice of a wider input
    with dcols the transpose of an AoS gradient; and bit for bit equal to
    itself across two launches (one fixed order of summation, no atomics)."""
    from tcnn_tpu_torch import Policy
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    spec = create_from_config(3, 1, sdf.CONFIG, policy=Policy()).network.encoding.spec
    live = list(range(spec.n_levels))
    B, L, F = 1 << 18, spec.n_levels, spec.n_features_per_level
    rng = np.random.default_rng(10 + int(masked) + 2 * int(dtype == torch.bfloat16))
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    x = torch.from_numpy(rng.uniform(0.05, 0.95, (B, 5)).astype(np.float32)).to(cuda)
    dc = torch.from_numpy(rng.normal(size=(B, L * F)).astype(np.float32)).to(dtype).to(cuda)
    if layout == "contiguous":
        x, dc = x[:, :3].contiguous(), dc.t().contiguous()
    else:
        x, dc = x[:, 1:4], dc.t()
    frac = (torch.from_numpy(spread_fractions(rng, B, L)).to(cuda) if masked else None)
    got = grid_encode_bwd_input(spec, flat, x, dc, live, level_frac=frac)
    again = grid_encode_bwd_input(spec, flat, x, dc, live, level_frac=frac)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert_rel_close(got, grid_encode_bwd_input_plain(spec, flat, x, dc, live, level_frac=frac),
                     1e-5)


def _binding_counts():
    return {"G": grid_encode_fwd.launches, "M": fused_mlp_fwd.launches,
            "GB": grid_encode_bwd.launches, "MB": fused_mlp_bwd.launches,
            "GI": grid_encode_bwd_input.launches, "GG": grid_encode_bwd_bwd.launches,
            "RS": row_scatter_add.launches}


def _launched(before):
    return {k: v - before[k] for k, v in _binding_counts().items() if v != before[k]}


BINDING_GRID = {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                "log2_hashmap_size": 15, "base_resolution": 4, "per_level_scale": 1.5,
                "interpolation": "Smoothstep"}
BINDING_NET = {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2,
               "activation": "ReLU", "output_activation": "None"}


def _binding_pair(cuda, kind):
    """The binding module ``kind`` on the card and the same module, holding
    the same params, on the CPU: the plain path (the CPU runs the plain
    versions of the kernels)."""
    from tcnn_tpu_torch.bindings import torch_interop as ti

    make = {"NetworkWithInputEncoding": lambda d: ti.NetworkWithInputEncoding(
                3, 1, BINDING_GRID, BINDING_NET, seed=5, device=d),
            "Network": lambda d: ti.Network(16, 1, BINDING_NET, seed=5, device=d),
            "Encoding": lambda d: ti.Encoding(3, BINDING_GRID, seed=5, device=d)}[kind]
    card, plain = make(cuda), make("cpu")
    with torch.no_grad():
        if kind != "Network":   # O(1) features in place of the U(±1e-4) initial table
            card._split(card.params)[0].uniform_(-1, 1)   # the grid, first in JAX's order
        plain.params.copy_(card.params.cpu())
    return card, plain


def assert_leaves_close(m, got, want, rel):
    """Each parameter's part of the flat gradients within ``rel`` of its
    largest magnitude."""
    for a, b in zip(m._split(got.cpu()), m._split(want)):
        assert_rel_close(a, b, rel)


@pytest.mark.parametrize("kind", ["NetworkWithInputEncoding", "Network", "Encoding"])
def test_binding_modules_match_their_plain_path(cuda, kind):
    """The three modules of ``bindings.torch_interop`` at the SDF sample's
    grid and MLP (fp32), B = 4000 (padded to 4096): forward, params.grad
    and the input gradient of a first-order backward, and params.grad and
    the input gradient of the gradient of the input gradient (the eikonal
    use), against the same module on the CPU holding the same params,
    whose wrappers run the plain versions.  Forward within 1e-5 of the
    largest magnitude, every gradient within 1e-4 of its largest magnitude
    (the fp32 MB tolerance: sums over the batch in another order).  The
    launches: forward G and M; first order GB, MB and GI; the input
    gradient MB and GI, no GB (its table gradient is not used); its
    backward GG and RS (a ReLU MLP's features get no second-order
    gradient, so no GB; a Network's input gets zeros)."""
    card, plain = _binding_pair(cuda, kind)
    rng = np.random.default_rng(3)
    x_np = rng.uniform(0.05, 0.95, (4000, card.n_input_dims)).astype(np.float32)
    has_grid, has_mlp = kind != "Network", kind != "Encoding"
    ys = []
    for m in (card, plain):
        x = torch.from_numpy(x_np).to(m.params.device).requires_grad_()
        before = _binding_counts()
        y = m(x)
        if m is card:
            torch.cuda.synchronize()
            assert _launched(before) == {k: 1 for k, on in (("G", has_grid), ("M", has_mlp))
                                         if on}
        before = _binding_counts()
        (y.float() ** 2).mean().backward()
        if m is card:
            torch.cuda.synchronize()
            assert _launched(before) == {k: 1 for k, on in (("GB", has_grid), ("MB", has_mlp),
                                                           ("GI", has_grid)) if on}
        ys.append((y.detach(), m.params.grad.clone(), x.grad.clone()))
    assert_rel_close(ys[0][0].cpu(), ys[1][0], 1e-5)
    assert_leaves_close(card, ys[0][1], ys[1][1], 1e-4)
    assert_rel_close(ys[0][2].cpu(), ys[1][2], 1e-4)

    if kind == "Encoding":
        return
    second = []
    for m in (card, plain):
        m.params.grad = None
        x = torch.from_numpy(x_np).to(m.params.device).requires_grad_()
        before = _binding_counts()
        (dydx,) = torch.autograd.grad(m(x).sum(), x, create_graph=True)
        if m is card:
            torch.cuda.synchronize()
            want = {"G": 1, "M": 1, "MB": 1, "GI": 1} if has_grid else {"M": 1, "MB": 1}
            assert _launched(before) == want
        before = _binding_counts()
        ((dydx.norm(dim=-1) - 1.0) ** 2).mean().backward()
        if m is card:
            torch.cuda.synchronize()
            assert _launched(before) == ({"GG": 1} if has_grid else {})
        second.append((m.params.grad.clone(), x.grad))
    assert_leaves_close(card, second[0][0], second[1][0], 1e-4)
    if has_grid:
        assert_rel_close(second[0][1].cpu(), second[1][1], 1e-4)
    else:   # a ReLU MLP's input gradient does not depend on x: zeros, as JAX's
        assert float(second[1][1].abs().max()) == 0
        assert torch.equal(second[0][1].cpu(), second[1][1])


def test_binding_encoding_half_output_and_pickle_on_the_card(cuda):
    """``Encoding(dtype=torch.float16)`` gives fp16 within one fp16 ulp of
    the plain path's fp32 output; a pickled NetworkWithInputEncoding comes
    back on the card and gives the same output bits (G and M are
    deterministic)."""
    import pickle

    from tcnn_tpu_torch.bindings import torch_interop as ti

    enc = ti.Encoding(3, BINDING_GRID, seed=5, dtype=torch.float16, device=cuda)
    plain = ti.Encoding(3, BINDING_GRID, seed=5, device="cpu")
    with torch.no_grad():
        enc.params.uniform_(-1, 1)
        plain.params.copy_(enc.params.cpu())
    x = torch.rand(3000, 3, device=cuda)
    got, want = enc(x), plain(x.cpu())
    assert got.dtype == torch.float16 and want.dtype == torch.float32
    a = want.abs().clamp_min(2.0 ** -14)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 10)
    assert bool(((got.cpu().float() - want).abs() <= ulp).all())

    m = ti.NetworkWithInputEncoding(3, 1, BINDING_GRID, BINDING_NET, device=cuda)
    with torch.no_grad():
        m.params.add_(0.01)
    y = m(x)
    m2 = pickle.loads(pickle.dumps(m))
    assert m2.params.device == m.params.device and torch.equal(m2(x), y)


# -- slice 11: the Rng hash, stochastic interpolation, 5 to 7 dims, GG masked,
# torch.func --------------------------------------------------------------------

def check_grid_kernels(cuda, spec, flat, x, dcols, ddx, frac=None):
    """G, GB, GI and GG against their plain versions at the bounds of the
    unmasked tests (``check_second_order``), all levels live and the static
    cutoff at 2; G also bit for bit against its corner order, the 5- to
    7-D instance too (it sums the corners in the same order)."""
    D = spec.n_dims
    for live in (list(range(spec.n_levels)), [0, 1]):
        for soa in (True, False):
            got = grid_encode_fwd(spec, flat, x, live, soa=soa, level_frac=frac)
            torch.cuda.synchronize()
            assert torch.equal(got if soa else got.t(),
                               masked_corner_order_sum(spec, flat, x, live, frac)
                               if frac is not None else corner_order_sum(spec, flat, x, live))
            assert_grid_sum_close(got, grid_encode_plain(spec, flat, x, live, soa=soa,
                                                         level_frac=frac), D)
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
        check_second_order(spec, flat, x, dcols, ddx, live, frac)


def slice11_inputs(cuda, spec, B, seed, dtype):
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0.02, 0.98, (B, spec.n_dims)).astype(np.float32))
    dcols = rng.normal(size=(spec.n_output_dims, B)).astype(np.float32)
    ddx = rng.normal(size=(B, spec.n_dims)).astype(np.float32)
    frac = spread_fractions(rng, B, spec.n_levels)
    return (flat.to(dtype).to(cuda), x.to(cuda), torch.from_numpy(dcols).to(dtype).to(cuda),
            torch.from_numpy(ddx).to(cuda), torch.from_numpy(frac).to(cuda))


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("F", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_grid_kernels_with_the_rng_hash_match_plain(cuda, D, F, dtype, masked):
    """Every grid kernel on an Rng grid (each corner's pcg32 hash in full,
    in each kernel's run-time-D instance), Smoothstep, with and without a
    per-sample mask; 2^4-row tables, so that every D hashes some level."""
    spec = grid_ops.make_grid_spec(D, 4, F, 4, 4, 1.7, hash_type=HashType.RNG,
                                   interpolation=InterpolationType.SMOOTHSTEP)
    assert any(lv.use_hash for lv in spec.levels)
    flat, x, dcols, ddx, frac = slice11_inputs(cuda, spec, 3001, D * 10 + F, dtype)
    check_grid_kernels(cuda, spec, flat, x, dcols, ddx, frac if masked else None)


@pytest.mark.parametrize("D", [5, 7])
@pytest.mark.parametrize("F", [2, 8])
@pytest.mark.parametrize("hash_type", [HashType.COHERENT_PRIME, HashType.COHERENT_ADD,
                                       HashType.PRIME])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_kernels_at_five_to_seven_dims_match_plain(cuda, D, F, hash_type, dtype):
    """The one run-time-D instance of G, GB, GI and GG at
    5 and 7 dims, the prime hashes, masked and not, and a dense grid at 5
    dims (Rng: test_grid_kernels_with_the_rng_hash_match_plain)."""
    spec = grid_ops.make_grid_spec(D, 3, F, 11, 4, 1.5, hash_type=hash_type,
                                   interpolation=InterpolationType.SMOOTHSTEP)
    flat, x, dcols, ddx, frac = slice11_inputs(cuda, spec, 2049, D * 100 + F, dtype)
    check_grid_kernels(cuda, spec, flat, x, dcols, ddx)
    check_grid_kernels(cuda, spec, flat, x, dcols, ddx, frac)
    if hash_type == HashType.PRIME and D == 5:
        dense = grid_ops.make_grid_spec(5, 2, F, 16, 2, 1.5, grid_type=GridType.DENSE)
        assert not any(lv.use_hash for lv in dense.levels)
        check_grid_kernels(cuda, dense, *slice11_inputs(cuda, dense, 1025, F, dtype)[:4])


@pytest.mark.parametrize("case", ["2^18", "2^14", "2^14 masked", "2^14 shard 1 of 2"])
def test_second_order_kernel_d_x_bits_across_launches(cuda, case):
    """Kernel GG at the SDF sample's grid (3-D Smoothstep 8 x 2, 2^15-row
    tables, fp32) and batches (the timed step's 2^18, the fit's 2^14),
    unmasked, masked and in shard mode: d_x and d_dcols equal bit for bit
    in two launches (one writer per (sample, level), the levels summed in
    one order), the table gradient within its bound of the plain one."""
    from tcnn_tpu_torch import Policy
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    spec = create_from_config(3, 1, sdf.CONFIG, policy=Policy()).network.encoding.spec
    B = 1 << int(case.split()[0][2:])
    shard = (1, 2) if "shard" in case else None
    rng = np.random.default_rng(B + len(case))
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params // (2 if shard else 1))
                            .astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.uniform(0.05, 0.95, (B, 3)).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(16, B)).astype(np.float32)).to(cuda)
    ddx = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32)).to(cuda)
    frac = (torch.from_numpy(spread_fractions(rng, B, 8)).to(cuda) if "masked" in case
            else None)
    check_second_order(spec, flat, x, dcols, ddx, list(range(8)), frac, shard)


@pytest.mark.parametrize("need", ["all", "no table", "table only", "no d_x"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_second_order_kernel_at_two_part_windows(cuda, monkeypatch, need, dtype):
    """GG on a plan with every level windowed (GB_MIN_HITS 0): the SDF
    grid's 29,792- and 32,768-row levels in two parts, whose first part
    alone writes d_dcols and d_x; each output asked for alone or with the
    others (no table gradient: no window is summed), a static max_level of
    6 (dead levels' d_dcols rows exact zeros); against the plain version."""
    from tcnn_tpu_torch import Policy
    from tcnn_tpu_torch.ops.cuda import grid_encode as ge
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    monkeypatch.setattr(ge, "GB_MIN_HITS", 0)
    monkeypatch.setattr(ge, "_gb_plans", {})
    spec = create_from_config(3, 1, sdf.CONFIG, policy=Policy()).network.encoding.spec
    B = 1 << 15
    rng = np.random.default_rng(len(need))
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    x = torch.from_numpy(rng.uniform(0.05, 0.95, (B, 3)).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(16, B)).astype(np.float32)).to(dtype).to(cuda)
    ddx = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32)).to(cuda)
    kw = {"need_dcols": need in ("all", "no table", "no d_x"),
          "need_x": need in ("all", "no table"), "need_table": need != "no table"}
    for live in (list(range(8)), list(range(6))):
        items = ge.gb_plan(spec, live, B, None, ge.gg_chunks(B)).items
        assert len({tuple(i) for i in items[items[:, 0] == 5][:, 1:3].tolist()}) == 2
        got = grid_encode_bwd_bwd(spec, flat, x, dcols, ddx, live, **kw)
        torch.cuda.synchronize()
        want = grid_encode_bwd_bwd_plain(spec, flat, x, dcols, ddx, live, **kw)
        for name, a, b in zip(("d_dcols", "d_x", "d_flat"), got, want):
            assert (a is None) == (b is None) == (not kw["need_" + {
                "d_dcols": "dcols", "d_x": "x", "d_flat": "table"}[name]]), name
        if kw["need_dcols"]:
            assert_rel_close(got.d_dcols, want.d_dcols, 1e-5)
            assert not bool(got.d_dcols[len(live) * 2:].any())
        if kw["need_x"]:
            assert_rel_close(got.d_x, want.d_x, 1e-5)
        if kw["need_table"]:
            scale = gg_table_scale(spec, x, dcols, ddx, live)
            assert_scatter_close(got.d_flat, want.d_flat, scale)
            assert bool((got.d_flat[scale == 0] == 0).all())


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_second_order_kernel_with_a_per_sample_mask_matches_plain(cuda, D, F, dtype):
    """Kernel GG under a per-sample level mask (its run-time-D instance):
    masked pairs give zero d_dcols and add nothing to d_x or the table
    gradient (a row only masked pairs reach stays an exact 0)."""
    spec = grid_ops.make_grid_spec(D, 6, F, 12, 4, 1.6,
                                   interpolation=InterpolationType.SMOOTHSTEP)
    flat, x, dcols, ddx, frac = slice11_inputs(cuda, spec, 4133, D + 10 * F, dtype)
    check_grid_kernels(cuda, spec, flat, x, dcols, ddx, frac)
    gg = grid_encode_bwd_bwd(spec, flat, x, dcols, ddx, list(range(6)), level_frac=frac)
    keep = (torch.arange(6, device=cuda)[:, None].float() < frac[None, :] * 6.0 + 1e-3)
    assert not bool(gg.d_dcols.reshape(6, F, -1)[~keep[:, None, :].expand(-1, F, -1)].any())
    reached = gg_table_scale(spec, x, dcols, ddx, list(range(6)), frac) > 0
    assert bool((gg.d_flat[~reached] == 0).all()) and bool((gg.d_flat[reached] != 0).any())


@pytest.mark.parametrize("D,F", [(2, 2), (3, 1), (4, 2), (5, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("interp", [InterpolationType.LINEAR, InterpolationType.SMOOTHSTEP])
def test_stochastic_table_gradient_matches_plain(cuda, D, F, dtype, interp):
    """GB under stochastic interpolation (the uniforms of
    ``stochastic_uniforms``, one corner per (sample, level) at weight 1),
    windows and direct atomics both (2^16 samples on 2^10-row levels,
    which the plan windows), against the plain version; the forward and
    GI are the deterministic grid's."""
    import dataclasses

    det = grid_ops.make_grid_spec(D, 6, F, 10, 4, 1.6, interpolation=interp)
    spec = dataclasses.replace(det, stochastic_interpolation=True)
    B = 1 << 16
    flat, x, dcols, _, frac = slice11_inputs(cuda, spec, B, D + F, dtype)
    live = list(range(spec.n_levels))
    for fr in (None, frac):
        got = grid_encode_bwd(spec, flat, x, dcols, live, level_frac=fr)
        torch.cuda.synchronize()
        want = grid_encode_bwd_plain(spec, flat, x, dcols, live, level_frac=fr)
        scale = grid_encode_bwd_plain(spec, flat.float(), x, dcols.float().abs(), live,
                                      level_frac=fr)
        assert_grid_grad_close(got, want, scale)
        assert not torch.equal(got, grid_encode_bwd(det, flat, x, dcols, live, level_frac=fr))
    assert torch.equal(grid_encode_fwd(spec, flat, x, live), grid_encode_fwd(det, flat, x, live))
    assert torch.equal(grid_encode_bwd_input(spec, flat, x, dcols, live),
                       grid_encode_bwd_input(det, flat, x, dcols, live))


def test_torch_func_on_the_card_matches_the_cpu(cuda):
    """torch.func.jvp, jacrev, jacfwd and vmap of a config_hash model (fp32)
    on the card against the same transforms on the CPU (plain versions),
    and jvp's reverse-mode launch counts: none of GB and MB."""
    cfg = "configs/config_hash.json"
    card = create_from_config(2, 3, cfg, policy=DEFAULT_POLICY)
    cpu = create_from_config(2, 3, cfg, policy=DEFAULT_POLICY, device="cpu")
    with torch.no_grad():
        card.network.encoding.grid.uniform_(-1, 1)
        for a, b in zip(cpu.network.parameters(), card.network.parameters()):
            a.copy_(b.cpu())
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.uniform(0, 1, (4096, 2)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(4096, 2)).astype(np.float32))
    before = (grid_encode_bwd.launches, fused_mlp_bwd.launches)
    y, t = torch.func.jvp(card.network, (x.to(cuda),), (v.to(cuda),))
    torch.cuda.synchronize()
    assert (grid_encode_bwd.launches, fused_mlp_bwd.launches) == before
    y_c, t_c = torch.func.jvp(cpu.network, (x,), (v,))
    assert_rel_close(y.cpu(), y_c, 1e-5)
    assert_rel_close(t.cpu(), t_c, 1e-4)
    xs = x[:6]
    jr = torch.func.jacrev(card.network)(xs.to(cuda))
    assert_rel_close(jr.cpu(), torch.func.jacrev(cpu.network)(xs), 1e-4)
    jf = torch.func.jacfwd(card.network)(xs.to(cuda))
    assert_rel_close(jf.cpu(), jr.cpu(), 1e-4)
    vm = torch.func.vmap(card.network)(x.to(cuda).reshape(4, 1024, 2))
    assert_rel_close(vm.reshape(4096, 3).cpu(), cpu.network(x).detach(), 1e-5)


# -- slice 14: third order (kernel GT), the stochastic gather, deep MLPs ------

GT_SHAPES = [(d, f) for d in (1, 2, 3, 4) for f in (1, 2, 3, 4, 8)] + [(3, 16), (2, 12)]


def _check_third(args, kw, dead_rows=0):
    """Kernel GT at ``args`` (spec, flat, x, dcols, v, beta, live) and
    ``kw`` against its plain version, with all outputs and with the
    curvature step's (d_dcols and the table gradient, no d_x): d_dcols and
    d_x within 1e-5 of their largest magnitude and bit for bit in a second
    launch, the table gradient per entry within 2^-11·S (``gt_table_scale``)
    and an exact 0 where S is; the last ``dead_rows`` rows of d_dcols (a
    dead level's) exact zeros; d_x alone equal to d_x among all outputs."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_third, grid_encode_third_plain
    from tcnn_tpu_torch.tools.plain_path import gt_table_scale

    spec, flat, x, dcols, v, beta, live = args
    scale = gt_table_scale(spec, x, dcols, v, beta, live, kw["level_frac"], kw["shard"])
    for need_x in (True, False):
        before = grid_encode_third.launches
        got = grid_encode_third(*args, need_x=need_x, **kw)
        again = grid_encode_third(*args, need_x=need_x, **kw)
        torch.cuda.synchronize()
        assert grid_encode_third.launches - before == 2
        want = grid_encode_third_plain(*args, need_x=need_x, **kw)
        assert torch.equal(got.d_dcols, again.d_dcols)
        assert_rel_close(got.d_dcols, want.d_dcols, 1e-5)
        if dead_rows:
            assert float(got.d_dcols[-dead_rows:].abs().max()) == 0
        if not need_x:
            assert got.d_x is None
        elif float(want.d_x.abs().max()) == 0:   # 1-D under a mask may have none
            assert float(got.d_x.abs().max()) == 0
        else:
            assert torch.equal(got.d_x, again.d_x)
            assert_rel_close(got.d_x, want.d_x, 1e-5)
        assert got.d_flat.dtype == want.d_flat.dtype == flat.dtype
        assert_scatter_close(got.d_flat, want.d_flat, scale)
        assert bool((got.d_flat[scale == 0] == 0).all())
        if need_x:
            d_x = got.d_x
    only = grid_encode_third(*args, need_dcols=False, need_table=False, **kw)
    assert only.d_dcols is None and only.d_flat is None
    assert torch.equal(only.d_x, d_x)


@pytest.mark.parametrize("d,f", GT_SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("mode", ["whole", "masked", "sharded"])
def test_grid_encode_third_kernel_matches_plain(cuda, d, f, mode):
    """Kernel GT against its plain version at every D 1-4 and F 1-4 and 8,
    Smoothstep (nonzero third derivatives), a dead level (``live`` without
    the last): unmasked in the 1- to 4-D instances, on fp32 and bf16 tables
    and dcols (within one bf16 ulp more); under a per-sample mask and in
    shard mode (shard 1 of 2) in the run-time-D instance (``_check_third``)."""
    spec = grid_ops.make_grid_spec(d, 6, f, 12, 4, 1.5, hash_type=HashType.COHERENT_PRIME,
                                   interpolation=InterpolationType.SMOOTHSTEP)
    rng = np.random.default_rng(d * 10 + f)
    B = 3001
    shard = (1, 2) if mode == "sharded" else None
    n = spec.n_params // (2 if shard else 1)
    x = torch.from_numpy(rng.uniform(0.05, 0.95, (B, d)).astype(np.float32)).to(cuda)
    frac = (torch.from_numpy(rng.uniform(0, 1, B).astype(np.float32)).to(cuda)
            if mode == "masked" else None)
    live = list(range(spec.n_levels - 1))
    for dtype in ((torch.float32, torch.bfloat16) if mode == "whole" else (torch.float32,)):
        flat = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dtype).to(cuda)
        dcols = torch.from_numpy(rng.normal(size=(spec.n_output_dims, B)).astype(np.float32))
        dcols = dcols.to(dtype).to(cuda)
        v, beta = (torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(cuda)
                   for _ in range(2))
        _check_third((spec, flat, x, dcols, v, beta, live), {"level_frac": frac, "shard": shard},
                     dead_rows=f)


@pytest.mark.parametrize("d,hash_type", [(2, HashType.RNG), (3, HashType.RNG),
                                         (5, HashType.COHERENT_PRIME), (7, HashType.PRIME)],
                         ids=lambda v: str(getattr(v, "value", v)))
@pytest.mark.parametrize("f", [2, 3])
def test_grid_encode_third_run_time_d_instance_matches_plain(cuda, d, hash_type, f):
    """Kernel GT's run-time-D instance unmasked and unsharded: Rng grids and
    5 to 7 dims, on GB's plan (windows and direct items), against its plain
    version as ``_check_third`` holds it."""
    spec = grid_ops.make_grid_spec(d, 5, f, 14, 4, 1.5, hash_type=hash_type,
                                   interpolation=InterpolationType.SMOOTHSTEP)
    rng = np.random.default_rng(d * 100 + f)
    B = 4099
    x = torch.from_numpy(rng.uniform(0.05, 0.95, (B, d)).astype(np.float32)).to(cuda)
    flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32)).to(cuda)
    dcols = torch.from_numpy(rng.normal(size=(spec.n_output_dims, B)).astype(np.float32))
    v, beta = (torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(cuda)
               for _ in range(2))
    _check_third((spec, flat, x, dcols.to(cuda), v, beta, list(range(5))),
                 {"level_frac": None, "shard": None})


def test_grid_stochastic_gather_matches_plain(cuda):
    """Kernel G's stochastic gather (the run-time-D instance with the
    uniforms of stochastic interpolation) against its plain version: each
    (level, sample) reads its one-hot corner at weight 1, so both give the
    same bits; a per-sample mask zeroes its pairs; the Rng hash and a
    4-D grid take the same instance."""
    rng = np.random.default_rng(41)
    for d, htype in ((2, HashType.COHERENT_PRIME), (2, HashType.RNG), (4, HashType.PRIME)):
        spec = grid_ops.make_grid_spec(d, 8, 2, 14, 16, 1.5, hash_type=htype,
                                       stochastic_interpolation=True)
        flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32)).to(cuda)
        x = torch.from_numpy(rng.uniform(0, 1, (5000, d)).astype(np.float32)).to(cuda)
        for frac in (None, torch.from_numpy(rng.uniform(0, 1, 5000).astype(np.float32)).to(cuda)):
            live = list(range(spec.n_levels))
            got = grid_encode_fwd(spec, flat, x, live, soa=True, level_frac=frac, stochastic=True)
            torch.cuda.synchronize()
            want = grid_encode_plain(spec, flat, x, live, soa=True, level_frac=frac,
                                     stochastic=True)
            assert torch.equal(got, want)


@pytest.mark.parametrize("n_hidden", [32, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_kernels_beyond_one_launch(cuda, n_hidden, dtype):
    """M and MB at 64 × 32 and 64 × 40 hidden layers (33 and 41 layers,
    more than one launch takes): M as two launches, bit for bit against the
    same MLP as a chain of shallow launches (each inner run ending on the
    hidden activation in the compute dtype) and, in fp32, within the fp32
    MLP bound of the plain version; MB over runs of at most 32 layers, at
    the MB bounds of the plain version in fp32; in bf16 bit for bit against
    the same backward as launches over runs of five layers
    (``fused_mlp_bwd_segmented``), whose shallow runs the other tests hold
    against the plain version: a dz that rounds to the other bf16
    neighbour moves every layer below it, and over 33 layers (on an H100)
    the plain version's dW lay 5 % apart from the kernel's in relative L2
    norm where the gradients had shrunk to 1e-9."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd_segmented,
                                                   fused_mlp_fwd_chained, mb_plan, plan_runs)

    dims = [(32, 64)] + [(64, 64)] * (n_hidden - 1) + [(64, 3)]
    ws, x, g = mlp_inputs(cuda, dims, 4133, n_hidden, True)
    xc = x.to(dtype)
    relu, none = Activation.RELU, Activation.NONE
    args = (ws, xc, relu, none, dtype, torch.float32, True, False)
    before = fused_mlp_fwd.launches
    got = fused_mlp_fwd(*args)
    torch.cuda.synchronize()
    assert fused_mlp_fwd.launches - before == len(plan_runs(len(ws), lambda a, b: True)) == 2
    shallow = [(i, i + 5) for i in range(0, len(ws) - 6, 5)]
    shallow.append((shallow[-1][1], len(ws)))   # runs of five layers, the last of 5 to 9
    assert torch.equal(got, fused_mlp_fwd_chained(*args, shallow, fwd=fused_mlp_fwd))
    if dtype == torch.float32:
        torch.testing.assert_close(got, fused_mlp_plain(*args), rtol=1e-5, atol=1e-5)
    runs = mb_plan(ws, dtype, relu, none)
    assert all(b - a <= 32 for a, b in runs)
    before = fused_mlp_bwd.launches
    got_dws, got_dx = fused_mlp_bwd(ws, xc, g, relu, none, dtype, True, False)
    torch.cuda.synchronize()
    assert fused_mlp_bwd.launches - before == len(runs) >= 2
    want_dws, want_dx = fused_mlp_bwd_plain(ws, xc, g, relu, none, dtype, True, False)
    if dtype == torch.float32:
        for a, b in zip(got_dws, want_dws):
            assert float((a - b).abs().max()) <= mlp_bwd_tol(b, dtype)
        assert_dx_close(got_dx, want_dx, ws, x, g, dtype, True)
    else:   # bf16 roundings of dz compound over the layers: the shallow runs' bits
        dws_s, dx_s = fused_mlp_bwd_segmented(ws, xc, g, relu, none, dtype, True, False, shallow)
        assert torch.equal(got_dx, dx_s)
        assert all(torch.equal(a, b) for a, b in zip(got_dws, dws_s))


@pytest.mark.parametrize("act", ["ReLU", "Softplus"])
def test_curvature_step_launches_gt_and_equals_the_plain_path(cuda, act):
    """The SDF sample's model (fp32) with a curvature regulariser
    (``fit_sdf_eikonal.curvature_loss``, a third derivative in the
    parameters) at 2^12 points: launches of G, M, GB, MB, GI, GG and GT, and
    the loss and gradients within 1e-4 of each largest magnitude of
    ``plain_path.plain_curvature_loss_and_grads`` (autograd of the plain
    forward)."""
    from tcnn_tpu_torch import Policy
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_third
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.tools.plain_path import plain_curvature_loss_and_grads

    cfg = {**sdf.CONFIG, "network": {**sdf.CONFIG["network"], "activation": act}}
    model = create_from_config(3, 1, cfg, policy=Policy())
    net = model.network
    gen = torch.Generator(cuda).manual_seed(3)
    with torch.no_grad():
        net.encoding.grid.uniform_(-1e-2, 1e-2, generator=gen)
    xs, xv = sdf.sample_points(gen, 1 << 12, cuda)
    v = sdf.sample_directions(gen, 1 << 12, cuda)
    kernels_ = (grid_encode_fwd, fused_mlp_fwd, grid_encode_bwd, fused_mlp_bwd,
                grid_encode_bwd_input, grid_encode_bwd_bwd, grid_encode_third)
    before = [k.launches for k in kernels_]
    loss, grads = sdf.curvature_loss_and_grads(net, xs, xv, v)
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kernels_, before)]
    assert all(n > 0 for n in launched), launched
    want_loss, want = plain_curvature_loss_and_grads(net, xs, xv, v)
    assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all())
        assert_rel_close(g, want[name], 1e-4)


# -- slice 16: more than 8 features a level, MLPs with wide inputs ------------

WIDE_INPUTS = [208, 256, 512, 1024]


@pytest.mark.parametrize("d_in", WIDE_INPUTS)
@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_kernels_at_wide_inputs(cuda, d_in, width, dtype):
    """M and MB at D_in in {208, 256, 512, 1024}, three layers, against
    their plain versions at the MLP bounds of ``check_m_and_mb``, but for
    bf16 dW, held within 2e-2 in relative L2 norm: 1024 fp32 terms summed
    in two orders switch a ReLU whose pre-activation lies within their
    rounding of 0 (160 of 4133 x 128 lie within 2^-16 of Σ|x·w| at
    D_in = 1024, on an H100), and each switch moves a column of the next
    layer's dW by a whole sample's term (dx rows: ``relu_flip_rows``, as
    there).  Where the first layer does not fit M's or MB's shared memory
    (``m_plan``, ``mb_plan``) it runs alone through the streamed-layer
    instances, whose launches the counters show.  A ragged batch of 4133
    rows."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_wide_bwd, fused_mlp_wide_fwd,
                                                   m_plan, mb_plan)

    dims = [(d_in, width), (width, width), (width, 1)]
    m_runs_, mb_runs = (m_plan([torch.empty(d) for d in dims], dtype, True),
                        mb_plan([torch.empty(d) for d in dims], dtype, Activation.RELU,
                                Activation.NONE))
    before = [k.launches for k in (fused_mlp_fwd, fused_mlp_wide_fwd, fused_mlp_bwd,
                                   fused_mlp_wide_bwd)]
    check_m_and_mb(cuda, dims, 4133, dtype, seed=d_in + width, dw_rel_l2=True)
    launched = [k.launches - b for k, b in zip((fused_mlp_fwd, fused_mlp_wide_fwd,
                                                fused_mlp_bwd, fused_mlp_wide_bwd), before)]
    singles = [sum(b - a == 1 for a, b in runs) for runs in (m_runs_, mb_runs)]
    # the forward: M's runs and M at MB's run boundaries
    assert launched[1] >= singles[0] and launched[3] == singles[1], (launched, m_runs_, mb_runs)
    assert launched[2] == len(mb_runs) - singles[1]
    if (width, dtype, d_in) in ((128, torch.float32, 256), (128, torch.bfloat16, 1024)):
        assert m_runs_ == [(0, 1), (1, 3)]   # past M's layouts (PERF.md)
    if (width, dtype, d_in) in ((128, torch.bfloat16, 512), (128, torch.float32, 1024)):
        assert mb_runs == [(0, 1), (1, 3)]   # past MB's layouts


@pytest.mark.parametrize("d_in", [256, 1024])
@pytest.mark.parametrize("n", [1, 3, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("soa_in,soa_out", [(True, False), (False, True)])
def test_streamed_layer_kernels_match_plain(cuda, d_in, n, dtype, soa_in, soa_out):
    """The streamed-layer instances of M and MB alone, one layer (D_in, n)
    with a Sigmoid (any activation: the last layer of a run takes the
    output activation), both layouts, a ragged batch: y within the MLP
    bound, dW within 1e-4 (fp32) or 2e-2 (bf16) of its largest magnitude,
    dx at the MB bound (one layer: no ReLU upstream to switch), dW bit for
    bit in a second launch."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_wide_bwd, fused_mlp_wide_fwd

    ws, x, g = mlp_inputs(cuda, [(d_in, n)], 4133, d_in + n, soa_in)
    if soa_out:
        g = g.t().contiguous()
    act = Activation.SIGMOID
    xc = x.to(dtype)
    got = fused_mlp_wide_fwd(ws[0], xc, act, dtype, torch.float32, soa_in, soa_out)
    torch.cuda.synchronize()
    want = fused_mlp_plain(ws, xc, act, act, dtype, torch.float32, soa_in, soa_out)
    tol = dict(rtol=2e-2, atol=2e-3) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)
    dw, dx = fused_mlp_wide_bwd(ws[0], xc, g, act, dtype, soa_in, soa_out)
    dw2, dx2 = fused_mlp_wide_bwd(ws[0], xc, g, act, dtype, soa_in, soa_out)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)
    want_dws, want_dx = fused_mlp_bwd_plain(ws, xc, g, act, act, dtype, soa_in, soa_out)
    assert dw.shape == want_dws[0].shape and dx.dtype == want_dx.dtype == dtype
    assert float((dw - want_dws[0]).abs().max()) <= mlp_bwd_tol(want_dws[0], dtype)
    assert float((dx.float() - want_dx.float()).abs().max()) <= mlp_bwd_tol(want_dx.float(),
                                                                           dtype)


def test_no_cuda_call_at_wide_shapes_reaches_a_plain_version(cuda, monkeypatch):
    """Grids at F = 16 and 12 (forward, table gradient, input gradient,
    second and third order) and a FusedMLP at 512 inputs (forward and
    backward, both dtypes) on the card with every plain version of the
    grid kernels and of M and MB replaced by one that raises: each call
    launches its kernel (the counters) and none takes a plain version."""
    from tcnn_tpu_torch.ops.cuda import fused_mlp as mlp_mod
    from tcnn_tpu_torch.ops.cuda import grid_encode as grid_mod
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_third

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version was called on the card")

    for name in ("grid_encode_plain", "grid_encode_bwd_plain", "grid_encode_bwd_input_plain",
                 "grid_encode_bwd_bwd_plain", "grid_encode_third_plain"):
        monkeypatch.setattr(grid_mod, name, refuse)
    for name in ("fused_mlp_plain", "fused_mlp_bwd_plain"):
        monkeypatch.setattr(mlp_mod, name, refuse)
    rng = np.random.default_rng(16)
    for d, f in ((3, 16), (2, 12)):
        spec = grid_ops.make_grid_spec(d, 6, f, 12, 4, 1.5,
                                       interpolation=InterpolationType.SMOOTHSTEP)
        B = 3001
        x = torch.from_numpy(rng.uniform(0.05, 0.95, (B, d)).astype(np.float32)).to(cuda)
        flat = torch.from_numpy(rng.uniform(-1, 1, spec.n_params).astype(np.float32)).to(cuda)
        dcols = torch.from_numpy(rng.normal(size=(spec.n_output_dims, B))
                                 .astype(np.float32)).to(cuda)
        v = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(cuda)
        live = list(range(spec.n_levels))
        calls = ((grid_encode_fwd, lambda: grid_encode_fwd(spec, flat, x, live, soa=True)),
                 (grid_encode_bwd, lambda: grid_encode_bwd(spec, flat, x, dcols, live)),
                 (grid_encode_bwd_input,
                  lambda: grid_encode_bwd_input(spec, flat, x, dcols, live)),
                 (grid_encode_bwd_bwd,
                  lambda: grid_encode_bwd_bwd(spec, flat, x, dcols, v, live)),
                 (grid_encode_third,
                  lambda: grid_encode_third(spec, flat, x, dcols, v, v, live)))
        for kernel, call in calls:
            before = kernel.launches
            call()
            assert kernel.launches == before + 1
    torch.cuda.synchronize()
    dims = [(512, 128), (128, 128), (128, 3)]
    for dtype in (torch.float32, torch.bfloat16):
        ws, x, g = mlp_inputs(cuda, dims, 4133, 5, True)
        counters = (fused_mlp_fwd, mlp_mod.fused_mlp_wide_fwd, fused_mlp_bwd,
                    mlp_mod.fused_mlp_wide_bwd)
        before = sum(k.launches for k in counters)
        y = fused_mlp_fwd(ws, x.to(dtype), Activation.RELU, Activation.NONE, dtype,
                          torch.float32, True, False)
        dws, dx = fused_mlp_bwd(ws, x.to(dtype), g, Activation.RELU, Activation.NONE, dtype,
                                True, False)
        torch.cuda.synchronize()
        assert sum(k.launches for k in counters) > before + 1
        assert all(bool(torch.isfinite(t).all()) for t in (y, dx, *dws))


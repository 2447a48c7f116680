"""``tcnn_tpu_torch.tools.plain_path`` on the CPU: the plain path that
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernel path
against on the card.

  * On the CPU the model's own path takes the same plain versions, so the
    trainer's loss and gradients, and its answers, equal the plain path's
    to the last bit, for config_hash, a config_btf-structured model and
    config_oneblob (a parameter-free encoding alone).
  * ``relu_flip_rows`` finds a fused-MLP input-gradient row that differs
    from the plain one by a switched ReLU near 0, only while that ReLU's
    pre-activation lies within the bound of its compute dtype
    (``FLIP_NEAR`` for bf16, ``FLIP_NEAR_F32`` for fp32), and no row that
    differs in another way.  Rows are held within 2e-2 (bf16) or 1e-4
    (fp32) of the gradient's largest magnitude, as ``chip_smoke.py`` holds
    them.
  * ``rounding_flip_rows`` explains a deep bf16 MLP's output row computed
    with a hidden value on a rounding boundary rounded the other way, and
    no row moved otherwise.
"""

import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.common import Activation
from tcnn_tpu_torch.ops.activations import activation_derivative
from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd_plain
from tcnn_tpu_torch.tools import plain_path
from tcnn_tpu_torch.tools.plain_path import (FLIP_NEAR, FLIP_NEAR_F32, grid_parts,
                                             plain_inference, plain_loss_and_grads,
                                             relu_flip_rows)

from test_torch_slice import CONFIG, small_btf_config


def _model(which, policy):
    if which == "config_hash":
        model = tcnn.create_from_config(2, 3, CONFIG, policy=policy, device="cpu")
    elif which == "config_oneblob":
        model = tcnn.create_from_config(2, 3, CONFIG.replace("config_hash", "config_oneblob"),
                                        policy=policy, device="cpu")
    else:
        model = tcnn.create_from_config(6, 3, small_btf_config(), policy=policy,
                                        device="cpu")
    gen = torch.Generator().manual_seed(3)
    n_in = model.network.n_input_dims
    with torch.no_grad():
        for _, grid, _, _ in grid_parts(model, torch.zeros((1, n_in))):
            grid.grid.uniform_(-1, 1, generator=gen)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (1024, n_in)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (1024, 3)).astype(np.float32))
    return model, x, target


@pytest.mark.parametrize("which", ["config_hash", "config_btf", "config_oneblob"])
@pytest.mark.parametrize("policy", [tcnn.BF16_POLICY, tcnn.DEFAULT_POLICY],
                         ids=["bf16", "fp32"])
def test_plain_path_equals_the_model_on_the_cpu(which, policy):
    model, x, target = _model(which, policy)
    loss, grads = model.trainer.loss_value_and_grads(x, target)
    want_loss, want = plain_loss_and_grads(model, x, target)
    assert torch.equal(loss, want_loss)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == want[name].dtype == torch.float32
        assert torch.equal(g, want[name]), name
    with torch.inference_mode():
        assert torch.equal(model.trainer.inference(x), plain_inference(model, x))


def _mlp(dtype, seed=5, batch=2048):
    rng = np.random.default_rng(seed)
    dims = [(40, 64), (64, 64), (64, 64), (64, 3)]
    ws = [torch.from_numpy(rng.uniform(-1, 1, d).astype(np.float32) * np.sqrt(6.0 / sum(d)))
          for d in dims]
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, 40)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(batch, 3)).astype(np.float32))
    return ws, x, g


def _flipped_bwd(ws, x, g, dtype, sample, layer, unit):
    """MB's plain version, written out again, with the ReLU mask of one
    hidden pre-activation of one sample flipped."""
    ws = [w.to(dtype).float() for w in ws]
    hs, zs = [x.to(dtype).float()], []
    for w in ws[:-1]:
        zs.append(hs[-1] @ w)
        hs.append(torch.relu(zs[-1]).to(dtype).float())
    dz = g.to(dtype).float()
    for i in range(len(ws) - 1, -1, -1):
        if i < len(ws) - 1:
            mask = activation_derivative(zs[i], Activation.RELU)
            if i == layer:
                mask[sample, unit] = 1 - mask[sample, unit]
            dz = (dh * mask).to(dtype).float()
        dh = dz @ ws[i].t()
    return dh.to(x.dtype), zs, hs


def _bounds(dtype):
    """(the row tolerance relative to the largest magnitude, the flip
    bound) of a compute dtype."""
    return (2e-2, FLIP_NEAR) if dtype == torch.bfloat16 else (1e-4, FLIP_NEAR_F32)


def _nearest_zero(ws, zs, hs, dtype):
    """Per sample, (layer, unit, |z| / Σ|h·w|) of the pre-activation
    nearest 0."""
    ratios = torch.stack([z.abs() / (h.abs() @ w.to(dtype).float().abs())
                          for z, h, w in zip(zs, hs, ws)], dim=1)   # (B, L, W)
    flat = ratios.flatten(1).min(dim=1)
    width = zs[0].shape[1]
    return flat.indices // width, flat.indices % width, flat.values


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relu_flip_rows_finds_a_switched_relu(dtype):
    rel, bound = _bounds(dtype)
    ws, x, g = _mlp(dtype)
    _, want = fused_mlp_bwd_plain(ws, x, g, Activation.RELU, Activation.NONE, dtype)
    tol = rel * float(want.float().abs().max())
    _, zs, hs = _flipped_bwd(ws, x, g, dtype, 0, -1, 0)
    layer, unit, near = _nearest_zero(ws, zs, hs, dtype)
    # the sample whose nearest-zero ReLU, flipped, moves its row the most
    best = None
    for s in torch.nonzero(near <= bound).flatten()[:64].tolist():
        got, _, _ = _flipped_bwd(ws, x, g, dtype, s, int(layer[s]), int(unit[s]))
        off = float((got[s].float() - want[s].float()).abs().max())
        if best is None or off > best[1]:
            best = (s, off, got)
    s, off, got = best
    assert off > tol, "the flip must move the row beyond the bound for the test to bite"
    rows = torch.tensor([s])
    explained, variants, flipped, nearest = relu_flip_rows(
        ws, x, g, Activation.NONE, dtype, rows, got[rows], tol)
    assert bool(explained.all())
    assert float((variants[0] - got[s].float()).abs().max()) <= tol
    assert 0 < float(flipped[0, 0]) <= bound and bool(flipped[0, 1].isnan())
    assert float(nearest[0]) <= float(flipped[0, 0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relu_flip_rows_rejects_rows_wrong_in_another_way(dtype):
    """Rows of samples with a pre-activation within the flip bound, so
    that only the comparison of the rows can reject them."""
    rel, bound = _bounds(dtype)
    ws, x, g = _mlp(dtype)
    _, want = fused_mlp_bwd_plain(ws, x, g, Activation.RELU, Activation.NONE, dtype)
    tol = rel * float(want.float().abs().max())
    _, zs, hs = _flipped_bwd(ws, x, g, dtype, 0, -1, 0)
    near_zero = torch.nonzero(_nearest_zero(ws, zs, hs, dtype)[2] <= bound).flatten()
    mags = want[near_zero].float().abs().max(dim=1).values
    big = near_zero[mags.argsort(descending=True)[:4]]
    wrong = torch.stack([torch.zeros_like(want[big[0]]),     # a row left unwritten
                         want[big[2]],                       # another sample's row
                         want[big[2]] * 1.5,                 # a row scaled
                         want[big[3]].roll(1)])              # a row shifted by a column
    rows = torch.stack([big[0], big[1], big[2], big[3]])
    assert bool(((wrong.float() - want[rows].float()).abs() > tol).any(dim=1).all())
    explained, _, flipped, nearest = relu_flip_rows(ws, x, g, Activation.NONE, dtype, rows,
                                                    wrong, tol)
    assert bool((nearest <= bound).all())
    assert not bool(explained.any())
    assert bool(flipped.isnan().all())


def test_relu_flip_rows_flips_only_near_zero(monkeypatch):
    """A switched ReLU explains its row only while its |z| / Σ|h·w| lies
    within ``FLIP_NEAR``."""
    ws, x, g = _mlp(torch.bfloat16)
    _, want = fused_mlp_bwd_plain(ws, x, g, Activation.RELU, Activation.NONE, torch.bfloat16)
    tol = 2e-2 * float(want.float().abs().max())
    _, zs, hs = _flipped_bwd(ws, x, g, torch.bfloat16, 0, -1, 0)
    layer, unit, near = _nearest_zero(ws, zs, hs, torch.bfloat16)
    for s in torch.nonzero(near <= FLIP_NEAR).flatten().tolist():
        got, _, _ = _flipped_bwd(ws, x, g, torch.bfloat16, s, int(layer[s]), int(unit[s]))
        if float((got[s].float() - want[s].float()).abs().max()) > tol:
            break
    rows = torch.tensor([s])
    kw = dict(weights=ws, x=x, g=g, output_activation=Activation.NONE,
              compute_dtype=torch.bfloat16, rows=rows, got_rows=got[rows], tol=tol)
    explained, _, flipped, nearest = relu_flip_rows(**kw)
    assert bool(explained.all()) and float(nearest[0]) == float(near[s])
    monkeypatch.setattr(plain_path, "FLIP_NEAR", float(flipped[0, 0]) / 2)
    assert not bool(relu_flip_rows(**kw)[0].any())


def test_relu_flip_rows_fp32_flips_only_within_its_bound(monkeypatch):
    """In fp32 a switched ReLU whose |z| / Σ|h·w| lies beyond
    ``FLIP_NEAR_F32`` (but within bf16's ``FLIP_NEAR``) explains nothing;
    with the bound moved out to that ratio it explains the row."""
    dtype = torch.float32
    rel, bound = _bounds(dtype)
    ws, x, g = _mlp(dtype)
    _, want = fused_mlp_bwd_plain(ws, x, g, Activation.RELU, Activation.NONE, dtype)
    tol = rel * float(want.float().abs().max())
    _, zs, hs = _flipped_bwd(ws, x, g, dtype, 0, -1, 0)
    layer, unit, near = _nearest_zero(ws, zs, hs, dtype)
    beyond = torch.nonzero((near > 4 * bound) & (near <= FLIP_NEAR)).flatten()
    for s in beyond.tolist():
        got, _, _ = _flipped_bwd(ws, x, g, dtype, s, int(layer[s]), int(unit[s]))
        if float((got[s].float() - want[s].float()).abs().max()) > tol:
            break
    else:
        pytest.fail("no flip beyond the fp32 bound moves its row beyond the tolerance")
    rows = torch.tensor([s])
    kw = dict(weights=ws, x=x, g=g, output_activation=Activation.NONE,
              compute_dtype=dtype, rows=rows, got_rows=got[rows], tol=tol)
    explained, _, flipped, nearest = relu_flip_rows(**kw)
    assert not bool(explained.any()) and bool(flipped.isnan().all())
    assert float(nearest[0]) == pytest.approx(float(near[s]), rel=1e-4)   # another sum order
    assert float(nearest[0]) > bound
    monkeypatch.setattr(plain_path, "FLIP_NEAR_F32", float(nearest[0]))
    assert bool(relu_flip_rows(**kw)[0].all())


def test_rounding_flip_rows_explains_another_rounding_only():
    """``rounding_flip_rows`` at config_oneblob's MLP (128 -> 128 x 5 -> 3,
    bf16): an output row computed with the hidden value nearest a bf16
    rounding midpoint rounded the other way is explained, within a bound
    far below the change; the plain row itself is (no flip); a row moved
    by anything else is not."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_plain
    from tcnn_tpu_torch.tools.plain_path import (SUM_SLACK, _bf16_other,
                                                 rounding_flip_rows)

    rng = np.random.default_rng(9)
    dims = [(128, 128)] * 5 + [(128, 3)]
    ws = [torch.from_numpy(rng.uniform(-1, 1, d).astype(np.float32) * np.sqrt(6 / sum(d)))
          for d in dims]
    x = torch.from_numpy(rng.uniform(-1, 1, (512, 128)).astype(np.float32))
    bf16 = torch.bfloat16
    y = fused_mlp_plain(ws, x, Activation.RELU, Activation.NONE, bf16, torch.float32)
    # the other rounding of the first layer's value nearest a midpoint
    wb = [w.to(bf16).float() for w in ws]
    h0 = x.to(bf16).float()
    r = torch.relu(h0 @ wb[0])
    down = r.to(bf16).float()
    near = (r - (down + _bf16_other(r, down)) / 2).abs() / (h0.abs() @ wb[0].abs())
    near[r == 0] = float("inf")
    s, u = divmod(int(near.argmin()), 128)
    assert float(near[s, u]) <= SUM_SLACK
    h = down[s:s + 1].clone()
    h[0, u] = _bf16_other(r[s:s + 1], down[s:s + 1])[0, u]
    for w in wb[1:-1]:
        h = torch.relu(h @ w).to(bf16).float()
    variant = h @ wb[-1]
    moved = float((variant - y[s]).abs().max())
    assert moved > 0
    tol = torch.full((1, 3), moved / 4)
    rows = torch.tensor([s])
    assert bool(rounding_flip_rows(ws, x, rows, variant, tol)[0].all())
    assert bool(rounding_flip_rows(ws, x, rows, y[s:s + 1], tol)[0].all())
    assert not bool(rounding_flip_rows(ws, x, rows, y[s:s + 1] + 4 * moved, tol)[0].any())

"""The plain path of a model: its forward and one training step's gradients
through the plain PyTorch versions of kernels G, M, MB and GB, on the
tensors the model holds, the SDF sample's eikonal step through those
and the plain versions of GI and GG (``plain_sdf_loss_and_grads``),
and the NeRF sample's step, two nets and a per-sample level mask
(``plain_nerf_loss_and_grads``).  ``gg_rows_and_g`` (from the plain
version of GG, ``ops/cuda/grid_encode.py``) gives kernel GG's
table-gradient updates as (rows, g), the layout kernel RS is checked and
timed on, and ``gg_table_scale`` the S of the sound bound on GG's table
gradient (``gg_term_magnitudes`` per update, also RS's S over them).
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernel path
(``model.trainer``, ``samples/fit_sdf_eikonal.py``,
``samples/fit_nerf_field.py``) against it on the
card; on the CPU the wrappers take these same plain versions.

Handles a grid alone (SoA features, config_hash), a concatenating
Composite of grids and parameter-free encodings (AoS features in the
compute dtype, config_btf) and a parameter-free encoding alone (AoS,
config_oneblob).  ``relu_flip_rows`` names the samples whose
fused-MLP input gradient differs from the plain one by a ReLU that lies
within rounding of 0 and switched; ``rounding_flip_rows`` the rows of a
deep bf16 MLP's output that a hidden value rounded to its other bf16
neighbour, where it lies on a rounding boundary, explains.
``spanning_psd`` draws the Shampoo preconditioners kernel SR is held
against float64 roots on, ``float64_root`` is that reference and
``root_error`` the error held to ``ROOT_TOL``.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..common import Activation
from ..ops.activations import activation_derivative
from ..ops.cuda.fused_mlp import (fused_mlp_bwd_bwd_plain, fused_mlp_bwd_plain,
                                  fused_mlp_plain)
from ..ops.cuda.grid_encode import (gg_rows_and_g, grid_encode_bwd_bwd_plain,
                                    grid_encode_bwd_input_plain, grid_encode_bwd_plain,
                                    grid_encode_plain)
from ..ops.cuda.scatter import row_scatter_add_plain
from ..ops import grid_ops
from ..ops.grid_ops import live_levels


def grid_parts(model, x: torch.Tensor) -> List[tuple]:
    """(parameter-name prefix, grid encoding, its input, first feature
    column) of each grid of the model's encoding: the encoding itself, or
    the nested grids of a Composite; none for another encoding."""
    enc = model.network.encoding
    if hasattr(enc, "spec"):
        return [("encoding.", enc, x, 0)]
    if not hasattr(enc, "nested"):
        return []
    parts, col = [], 0
    for i, (e, (begin, nd)) in enumerate(zip(enc.nested, enc.slices)):
        if hasattr(e, "spec"):
            parts.append((f"encoding.{i}.", e, x[:, begin:begin + nd], col))
        col += e.n_output_dims
    return parts


def plain_features(model, x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(features, soa): the encoding's output through kernel G's plain
    version, in the layout the model hands the MLP: SoA (L·F, B) for a grid
    alone, (B, n_features) in the compute dtype for a Composite (its other
    encodings are plain PyTorch in the model too)."""
    enc, cdt = model.network.encoding, model.network.policy.compute_dtype

    def grid(e, xs, soa):
        return grid_encode_plain(e.spec, e.grid.detach().to(cdt), xs,
                                 list(range(e.spec.n_levels)), soa=soa).to(cdt)

    if hasattr(enc, "spec"):
        return grid(enc, x, True), True
    if not hasattr(enc, "nested"):   # parameter-free, plain PyTorch in the model too
        return enc(x).to(cdt), False
    parts = [grid(e, x[:, b:b + nd], False) if hasattr(e, "spec") else e(x[:, b:b + nd])
             for e, (b, nd) in zip(enc.nested, enc.slices)]
    return torch.cat([p.to(cdt) for p in parts], dim=1), False


def plain_inference(model, x: torch.Tensor) -> torch.Tensor:
    """The serving path through the plain versions."""
    net, pol = model.network.network, model.network.policy
    feats, soa = plain_features(model, x)
    return fused_mlp_plain([w.detach() for w in net.layers], feats, net.activation,
                           net.output_activation, pol.compute_dtype, pol.output_dtype,
                           input_soa=soa)


class StepParts(NamedTuple):
    """The tensors of one plain training step."""
    feats: torch.Tensor     # the MLP's input
    soa: bool               # feats is (n_features, B)
    loss: torch.Tensor
    dy: torch.Tensor        # the loss gradient at the MLP's output, (B, D_out)
    dws: List[torch.Tensor]
    dfeats: torch.Tensor    # the MLP's input gradient, feats' layout


def plain_step_parts(model, x: torch.Tensor, target: torch.Tensor) -> StepParts:
    net, pol = model.network.network, model.network.policy
    cdt = pol.compute_dtype
    ws = [w.detach() for w in net.layers]
    feats, soa = plain_features(model, x)
    pred = fused_mlp_plain(ws, feats, net.activation, net.output_activation,
                           cdt, pol.output_dtype, soa, False)
    pred = pred.float().requires_grad_()
    loss = model.loss(pred, target)
    (dy,) = torch.autograd.grad(loss, pred)
    dws, dfeats = fused_mlp_bwd_plain(ws, feats, dy, net.activation,
                                      net.output_activation, cdt, soa, False)
    return StepParts(feats, soa, loss.detach(), dy, dws, dfeats)


def plain_grid_grads(model, x: torch.Tensor, dfeats: torch.Tensor,
                     soa: bool) -> Dict[str, torch.Tensor]:
    """Each grid's table gradient (fp32, by parameter name) through GB's
    plain version, from the MLP's input gradient ``dfeats``."""
    cdt = model.network.policy.compute_dtype
    grads = {}
    for prefix, e, xs, col in grid_parts(model, x):
        cols = slice(col, col + e.n_output_dims)
        dcols = dfeats[cols] if soa else dfeats[:, cols].t()
        grads[prefix + "grid"] = grid_encode_bwd_plain(
            e.spec, e.grid.detach().to(cdt), xs, dcols,
            list(range(e.spec.n_levels))).float()
    return grads


def plain_loss_and_grads(model, x: torch.Tensor, target: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss and its gradients, by the trainer's parameter
    names, through the plain versions of G, M, MB and GB."""
    p = plain_step_parts(model, x, target)
    grads = plain_grid_grads(model, x, p.dfeats, p.soa)
    grads.update({f"network.layers.{i}": d for i, d in enumerate(p.dws)})
    return p.loss, grads


def plain_training_step(model, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """One training step through the plain versions (and the port's Adam)."""
    loss, grads = plain_loss_and_grads(model, x, target)
    model.optimizer.step(model.trainer.opt_state, grads, model.trainer.params())
    return loss


def plain_sdf_loss_and_grads(net, x_surf: torch.Tensor, x_vol: torch.Tensor,
                             table_scale: bool = False, mlp_bwd=fused_mlp_bwd_plain,
                             level_frac=None):
    """The SDF sample's loss, mean f(x_surf)² + 0.1 · the eikonal loss of
    ∇x f(x_vol), and its gradients by parameter name, for ``net`` a grid
    alone feeding a fused MLP (``samples/fit_sdf_eikonal.py``).  Each
    kernel of the step is replaced by its plain version, in the order the
    kernel path runs them: the surface term through G, M, MB and GB; the
    input gradient through G, MB and GI; its backward through GG, MB's
    second order and GB.  With ``table_scale`` it also returns S, per
    table entry the sum of the magnitudes of the terms its gradient sums
    (the scale of that sum's rounding in another order).  ``mlp_bwd`` is
    MB's plain version, called for the surface term, then for x_vol; a
    caller may substitute rows that a switched ReLU explains.
    ``level_frac`` is a per-sample level fraction (B,), the same for both
    point sets, as the model's ``max_level_per_element``."""
    from ..samples.fit_sdf_eikonal import EIKONAL_WEIGHT, eikonal_loss

    enc, mlp, pol = net.encoding, net.network, net.policy
    spec, cdt, odt = enc.spec, pol.compute_dtype, pol.output_dtype
    live = live_levels(spec, enc.max_level)
    table = enc.grid.detach().to(cdt)
    ws = [w.detach() for w in mlp.layers]
    act, out_act = mlp.activation, mlp.output_activation
    B = x_surf.shape[0]

    def features(x):
        return grid_encode_plain(spec, table, x, live, soa=True, level_frac=level_frac).to(cdt)

    def table_grad(x, dcols):   # GB
        return grid_encode_bwd_plain(spec, table, x, dcols, live, level_frac=level_frac).float()

    def output_grad(y):   # a gradient in column 0 of the (B, D_out) output
        dy = torch.zeros_like(y)
        dy[:, 0] = y[:, 0]
        return dy

    # the surface term: G, M, MB, GB
    fs = features(x_surf)
    ys = fused_mlp_plain(ws, fs, act, out_act, cdt, odt, True, False).float()
    surf = torch.mean(ys[:, 0] ** 2)
    dws, dfs = mlp_bwd(ws, fs, output_grad(ys) * (2.0 / B), act, out_act, cdt, True, False)
    dtable = table_grad(x_surf, dfs)
    scale = table_grad(x_surf, dfs.abs()) if table_scale else None
    # the input gradient at x_vol: G, MB, GI
    fv = features(x_vol)
    ones = output_grad(torch.ones((B, mlp.n_output_dims), device=x_vol.device))
    _, dfv = mlp_bwd(ws, fv, ones, act, out_act, cdt, True, False)
    gx = grid_encode_bwd_input_plain(spec, table, x_vol, dfv, live,
                                     level_frac=level_frac).requires_grad_()
    with torch.enable_grad():
        eik = eikonal_loss(gx)
        (ddx,) = torch.autograd.grad(EIKONAL_WEIGHT * eik, gx)
    # its backward: GG (the table), MB's second order (the weights and the
    # features), GB (the table again, unless the features' gradient
    # vanishes: it does for ReLU layers, piecewise linear in x)
    bb = grid_encode_bwd_bwd_plain(spec, table, x_vol, dfv, ddx, live, need_x=False,
                                   level_frac=level_frac)
    dtable = dtable + bb.d_flat.float()
    if table_scale:   # S over the terms of GG's updates (Σ|g| is not sound)
        scale = scale + gg_table_scale(spec, x_vol, dfv, ddx, live, level_frac)
    d_fv, _, dws2 = fused_mlp_bwd_bwd_plain(ws, fv, ones, bb.d_dcols.to(dfv.dtype),
                                            [None] * len(ws), act, out_act, cdt, odt,
                                            True, False)
    if d_fv is not None:
        dtable = dtable + table_grad(x_vol, d_fv)
        if table_scale:
            scale = scale + table_grad(x_vol, d_fv.abs())
    grads = {"encoding.grid": dtable}
    grads.update({f"network.layers.{i}": a + b for i, (a, b) in enumerate(zip(dws, dws2))})
    loss = (surf + EIKONAL_WEIGHT * eik).detach()
    return (loss, grads, scale) if table_scale else (loss, grads)


def plain_curvature_loss_and_grads(net, x_surf: torch.Tensor, x_vol: torch.Tensor,
                                   v: torch.Tensor, weight: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``samples.fit_sdf_eikonal.curvature_loss`` of ``net`` (a grid
    alone feeding a fused MLP) and its gradients by parameter name, with
    the model's forward written as the plain versions of G and M in torch
    operations (``grid_encode_plain``, ``fused_mlp_plain``), which autograd
    differentiates to the third order itself: no kernel's backward and no
    plain version of GB, GI, GG, GT or MB takes part, so the kernels' third
    order is held against an independent derivation."""
    from ..samples.fit_sdf_eikonal import CURVATURE_WEIGHT, curvature_loss

    enc, mlp, pol = net.encoding, net.network, net.policy
    spec, cdt = enc.spec, pol.compute_dtype
    live = live_levels(spec, enc.max_level)
    names = [n for n, _ in net.named_parameters()]
    params = [p.detach().requires_grad_() for _, p in net.named_parameters()]
    by_name = dict(zip(names, params))
    layers = [by_name[f"network.layers.{i}"] for i in range(len(mlp.layers))]

    def f(x):
        feats = grid_encode_plain(spec, by_name["encoding.grid"].to(cdt), x, live, soa=True)
        return fused_mlp_plain(layers, feats.to(cdt), mlp.activation, mlp.output_activation, cdt,
                               pol.output_dtype, input_soa=True).float()

    with torch.enable_grad():
        loss = curvature_loss(f, x_surf, x_vol, v,
                              CURVATURE_WEIGHT if weight is None else weight)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def plain_nerf_field_grads(density_net, color_net, x: torch.Tensor, d: torch.Tensor,
                           max_level_frac, loss_of) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The NeRF sample's field (``samples/fit_nerf_field.py::model_field``)
    at points x viewed from d, a loss ``loss_of(sigma, rgb)`` of it, and the
    loss's gradients by the sample's parameter names, with each kernel of
    the step replaced by its plain version: G (with the per-sample level
    mask) and M of the density net, M of the colour net, then MB of the
    colour net, whose input gradient autograd carries through the
    Composite encoding into the density net's output, MB of the density
    net and GB.  What lies between the kernels (the heads, the encodings,
    ``loss_of``) runs under autograd, as on the kernel path."""
    from ..samples.fit_nerf_field import density_heads, per_sample_frac

    denc, dmlp, cmlp, pol = density_net.encoding, density_net.network, color_net.network, \
        density_net.policy
    cdt, odt, spec = pol.compute_dtype, pol.output_dtype, denc.spec
    live = live_levels(spec, denc.max_level)
    table = denc.grid.detach().to(cdt)
    frac = (per_sample_frac(max_level_frac, x.shape[0], x.device)
            if max_level_frac is not None else None)
    wd = [w.detach() for w in dmlp.layers]
    wc = [w.detach() for w in cmlp.layers]
    feats = grid_encode_plain(spec, table, x, live, soa=True, level_frac=frac).to(cdt)
    h = fused_mlp_plain(wd, feats, dmlp.activation, dmlp.output_activation, cdt, odt, True,
                        False).requires_grad_()
    with torch.enable_grad():
        sigma, color_in = density_heads(h, d)
        cfeat = color_net.encoding(color_in)
        y = fused_mlp_plain(wc, cfeat.detach(), cmlp.activation, cmlp.output_activation, cdt,
                            odt, False, False).requires_grad_()
        loss = loss_of(sigma, y.float())
        dh, dy = torch.autograd.grad(loss, [h, y], retain_graph=True)
        dwc, dcfeat = fused_mlp_bwd_plain(wc, cfeat.detach(), dy, cmlp.activation,
                                          cmlp.output_activation, cdt, False, False)
        (dh_color,) = torch.autograd.grad(cfeat, h, dcfeat.to(cfeat.dtype))
    dwd, dfeats = fused_mlp_bwd_plain(wd, feats, dh + dh_color, dmlp.activation,
                                      dmlp.output_activation, cdt, True, False)
    grads = {"density.encoding.grid": grid_encode_bwd_plain(spec, table, x, dfeats, live,
                                                            level_frac=frac).float()}
    grads.update({f"density.network.layers.{i}": g for i, g in enumerate(dwd)})
    grads.update({f"color.network.layers.{i}": g for i, g in enumerate(dwc)})
    return loss.detach(), grads


def plain_nerf_loss_and_grads(density_net, color_net, rays_o: torch.Tensor,
                              rays_d: torch.Tensor, n_samples: int, jitter=None,
                              max_level_frac=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The NeRF sample's training loss (``loss_fn``) and its gradients
    through the plain versions (``plain_nerf_field_grads``), on the same
    rays and jitter."""
    from ..samples.fit_nerf_field import render, true_field

    pts = {}

    def record(x, d):   # the sample points render hands the field
        pts["x"], pts["d"] = x, d
        return x.new_zeros(x.shape[0]), x.new_zeros((x.shape[0], 3))

    with torch.no_grad():
        gt = render(lambda x, d: true_field(x), rays_o, rays_d, n_samples)
        render(record, rays_o, rays_d, n_samples, jitter)

    def loss_of(sigma, rgb):
        pred = render(lambda x, d: (sigma, rgb), rays_o, rays_d, n_samples, jitter)
        return torch.mean((pred - gt) ** 2)

    return plain_nerf_field_grads(density_net, color_net, pts["x"], pts["d"], max_level_frac,
                                  loss_of)


# A sum of n fp32 products taken in another order moves by at most
# n·2^-24 of Σ|h·w| (first order); at the widths of the repo (n <= 128),
# 2^-17, and a factor 2 of margin.  A bf16 hidden value whose fp32
# pre-activation lies this near a rounding midpoint may round either way
# in two correct sums.
SUM_SLACK = 2.0 ** -16


def gt_table_scale(spec, x: torch.Tensor, dcols: torch.Tensor, ddx: torch.Tensor,
                   ct_dx: torch.Tensor, live: Sequence[int], level_frac=None,
                   shard=None) -> torch.Tensor:
    """The flat S of kernel GT's table gradient (its shard's rows with
    ``shard``): per entry, over its updates u_c · dcols, the sum of the
    magnitudes of their terms, Σ_{d,e} |β_d · ∂²w_c/∂x_d∂x_e · v_e| ·
    |dcols| (β = ``ct_dx``, v = ``ddx``).  GT's d_flat lies within 2^-11·S
    of the plain one per entry (fp32 atomics in any order), and is an exact
    0 where S is."""
    L, C, (B, _) = len(live), 1 << spec.n_dims, x.shape
    F = spec.n_features_per_level
    idx, _, _, d2ws = grid_ops.build_indices_weights(spec, x, live, order=2,
                                                     level_frac=level_frac, shard=shard)
    u = torch.einsum("nbde,bd,be->nb", d2ws.abs(), ct_dx.float().abs(),
                     ddx.float().abs()).reshape(L, C, B)
    rows = torch.tensor([l * F + f for l in live for f in range(F)], device=x.device)
    dy = dcols.float().abs()[rows].reshape(L, F, B).permute(0, 2, 1)[:, None]
    n_rows = spec.n_entries // (shard[1] if shard else 1)
    acc = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    acc.index_add_(0, idx.reshape(-1).clamp_min(0), (u[..., None] * dy).reshape(-1, F))
    return acc.reshape(-1)


def gg_term_magnitudes(spec, x: torch.Tensor, dcols: torch.Tensor, ddx: torch.Tensor,
                       live: Sequence[int], level_frac=None, shard=None) -> torch.Tensor:
    """(L·C·B, F), in ``gg_rows_and_g``'s order: per update the sum of the
    magnitudes of the terms of its g, Σ_d |∂w_c/∂x_d · ddx_d| · |dcols|.
    Their scatter-add at those rows (plain RS) is the S of the sound bound
    2^-11·S on kernel GG's table gradient against the plain one, and on RS
    over the updates: Σ|g| is not sound where g's terms cancel."""
    L, C, (B, _) = len(live), 1 << spec.n_dims, x.shape
    F = spec.n_features_per_level
    _, _, dws = grid_ops.build_indices_weights(spec, x, live, order=1, level_frac=level_frac,
                                               shard=shard)
    wp = (dws.abs() * ddx.float().abs()[None]).sum(-1).reshape(L, C, B)
    rows = torch.tensor([l * F + f for l in live for f in range(F)], device=x.device)
    dy = dcols.float().abs()[rows].reshape(L, F, B).permute(0, 2, 1)[:, None]
    return (wp[..., None] * dy).reshape(L * C * B, F)


def gg_table_scale(spec, x: torch.Tensor, dcols: torch.Tensor, ddx: torch.Tensor,
                   live: Sequence[int], level_frac=None, shard=None) -> torch.Tensor:
    """The flat S of kernel GG's table gradient (its shard's rows with
    ``shard``): ``gg_term_magnitudes`` scattered at the rows of
    ``gg_rows_and_g``.  GG's d_flat lies within 2^-11·S of the plain one
    per entry, and is an exact 0 where S is."""
    rows, _ = gg_rows_and_g(spec, x, dcols, ddx, live, level_frac, shard)
    n_rows = spec.n_entries // (shard[1] if shard else 1)
    return row_scatter_add_plain(
        rows, gg_term_magnitudes(spec, x, dcols, ddx, live, level_frac, shard), n_rows)


def _bf16_other(r: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """For r >= 0 and its bf16 rounding, the bf16 neighbour of ``rounded``
    on r's side (above it where r equals it): the other value r may round
    to.  Bits of non-negative bf16 values grow with the value."""
    bits = rounded.to(torch.bfloat16).view(torch.int16)
    step = torch.where(r < rounded, -1, 1).to(torch.int16)
    return (bits + step).view(torch.bfloat16).float()


def rounding_flip_rows(weights: Sequence[torch.Tensor], x: torch.Tensor,
                       rows: torch.Tensor, got_rows: torch.Tensor, tol: torch.Tensor,
                       input_soa: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which rows of a bf16 ReLU MLP's output (``fused_mlp_plain``, output
    activation None, fp32 output) another correct rounding explains.

    Over several bf16 layers a hidden value whose fp32 pre-activation lies
    on a rounding boundary rounds either way in two correct sums, and the
    sample's whole output row moves.  For each sample in ``rows`` the plain
    forward is rerun for these rows alone, as it is and with one or two of
    its ``FLIP_CANDIDATES`` hidden values nearest a bf16 rounding midpoint
    (by distance / Σ|h·w|, all layers) rounded to their other neighbour,
    each flipped one within ``SUM_SLACK``.  A row is explained when some
    variant lies within ``tol`` (its (n, D_out) bound) of ``got_rows`` in
    every entry.  Returns (explained (n,) bool, the distance of each
    sample's hidden value nearest a midpoint (n,))."""
    cdt, n = torch.bfloat16, rows.numel()
    ws = [w.to(cdt).float() for w in weights]
    h0 = (x.t() if input_soa else x)[rows].to(cdt).float()
    h, dists = h0, []
    for w in ws[:-1]:
        r = torch.relu(h @ w)
        down = r.to(cdt).float()
        mid = (down + _bf16_other(r, down)) / 2
        d = (r - mid).abs() / (h.abs() @ w.abs()).clamp_min(1e-30)
        dists.append(torch.where(r > 0, d, torch.full_like(d, float("inf"))))
        h = down
    near_val, near_idx = torch.cat(dists, dim=1).topk(FLIP_CANDIDATES, dim=1, largest=False)
    variants = [()] + [c for k in (1, 2) for c in combinations(range(FLIP_CANDIDATES), k)]
    width = ws[0].shape[1]
    flips = torch.zeros((len(variants), n, width * (len(ws) - 1)), dtype=torch.bool,
                        device=h0.device)
    ok = torch.ones((len(variants), n), dtype=torch.bool, device=h0.device)
    for v, cand in enumerate(variants):
        for c in cand:
            flips[v].scatter_(1, near_idx[:, c:c + 1], True)
            ok[v] &= near_val[:, c] <= SUM_SLACK
    h = h0[None].expand(len(variants), -1, -1)
    for i, w in enumerate(ws[:-1]):
        r = torch.relu(h @ w)
        down = r.to(cdt).float()
        h = torch.where(flips[..., i * width:(i + 1) * width], _bf16_other(r, down), down)
    y = h @ ws[-1]
    match = ((y - got_rows.float()[None]).abs() <= tol[None]).all(dim=2) & ok
    return match.any(dim=0), near_val[:, 0]


# Flipped ReLUs may lie this far from 0, relative to Σ|h·w| of their
# pre-activation: one bf16 ulp of the terms' magnitude, as far as z moves
# when each input of its layer rounds to its other bf16 neighbour.  In
# fp32 compute, 2^-16: a sum of 64 fp32 products in another order moves z
# by up to 64·2^-24 = 2^-18 of Σ|h·w|, with a factor 4 of margin.
FLIP_NEAR = 2.0 ** -7
FLIP_NEAR_F32 = 2.0 ** -16
FLIP_CANDIDATES = 6


def relu_flip_rows(weights: Sequence[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                   output_activation: Activation, compute_dtype: torch.dtype,
                   rows: torch.Tensor, got_rows: torch.Tensor, tol: float,
                   input_soa: bool = False, output_soa: bool = False):
    """Which rows of an MLP input gradient a switched ReLU explains.

    For each sample in ``rows`` (B indices), MB's plain version
    (``fused_mlp_bwd_plain``, ReLU hidden layers) is rerun for these rows
    alone, as it is and with the ReLU mask of one or two of its
    ``FLIP_CANDIDATES`` hidden pre-activations nearest 0 flipped.  The
    forward is kept: a pre-activation that close to 0 moves the layers
    after it by less than their rounding.  A row is explained when some
    variant lies within ``tol`` of ``got_rows`` (the other side's rows,
    (len(rows), D_in)) in every entry, and the sample has a pre-activation
    near 0 (by |z| / Σ|h·w|: within ``FLIP_NEAR`` for a bf16
    ``compute_dtype``, ``FLIP_NEAR_F32`` for fp32), each flipped one included.
    The variant with nothing flipped can match where the full batch's
    plain row does not: a product over fewer rows may sum in another
    order, and that alone moves such a pre-activation across 0.

    Returns (explained (n,) bool, the matching variant's rows (n, D_in)
    fp32 (the plain row where none matched), |z| / Σ|h·w| of the flipped
    pre-activations (n, 2), NaN where none, and of the pre-activation
    nearest 0 (n,))."""
    cdt, n = compute_dtype, rows.numel()
    near = FLIP_NEAR if cdt == torch.bfloat16 else FLIP_NEAR_F32
    ws = [w.to(cdt).float() for w in weights]
    h = (x.t() if input_soa else x)[rows].to(cdt).float()
    gg = (g.t() if output_soa else g)[rows].float()
    zs, ratios = [], []
    for w in ws[:-1]:
        zs.append(h @ w)
        ratios.append(zs[-1].abs() / (h.abs() @ w.abs()).clamp_min(1e-30))
        h = torch.relu(zs[-1]).to(cdt).float()
    z_out = h @ ws[-1]
    width = ws[0].shape[1]
    near_val, near_idx = torch.cat(ratios, dim=1).topk(FLIP_CANDIDATES, dim=1, largest=False)
    variants = [()] + [c for k in (1, 2)
                       for c in combinations(range(FLIP_CANDIDATES), k)]
    masks = torch.cat([(z > 0).float() for z in zs], dim=1)        # (n, L·W)
    flips = torch.zeros((len(variants), n, masks.shape[1]), device=masks.device)
    ok_near = (near_val[:, 0] <= near)[None].repeat(len(variants), 1)
    for v, cand in enumerate(variants):
        for c in cand:
            flips[v].scatter_(1, near_idx[:, c:c + 1], 1.0)
            ok_near[v] &= near_val[:, c] <= near
    m = (masks[None] - flips).abs()                                # (V, n, L·W)
    dz = (gg * activation_derivative(z_out, output_activation)).to(cdt).float()
    dz = dz[None].expand(len(variants), -1, -1)
    for i in range(len(ws) - 1, -1, -1):
        if i < len(ws) - 1:
            dz = (dh * m[..., i * width:(i + 1) * width]).to(cdt).float()
        dh = dz @ ws[i].t()
    dx = dh.to(x.dtype).float()                                    # (V, n, D_in)
    match = ((dx - got_rows.float()[None]).abs() <= tol).all(dim=2) & ok_near
    explained = match.any(dim=0)
    first = match.float().argmax(dim=0)                            # fewest flips first
    chosen = dx[first, torch.arange(n, device=dx.device)]
    flipped = torch.full((n, 2), float("nan"), device=dx.device)
    for s in explained.nonzero().flatten().tolist():
        for j, c in enumerate(variants[int(first[s])]):
            flipped[s, j] = near_val[s, c]
    return explained, chosen, flipped, near_val[:, 0]


def spanning_psd(n: int, device, span: float = 1e5, identity: float = 0.01) -> torch.Tensor:
    """A random symmetric positive semi-definite (n, n) float32 L, drawn
    from a generator seeded by n, whose regularised S = L·(1 − s) + s·I
    (s = ``identity``) has eigenvalues s to s·span, spaced geometrically:
    a preconditioner's spread, as a trained MLP's spans 10^5."""
    gen = torch.Generator().manual_seed(n)
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=torch.float64))
    w = identity * torch.logspace(0, torch.log10(torch.tensor(span)).item(), n,
                                  dtype=torch.float64) - identity
    return ((q * (w / (1 - identity))) @ q.t()).float().to(device)



# Kernel SR's limit on ``root_error``: 32 fp32 ulps of the root's largest
# entry.  SR diagonalises in fp64 and rounds the root once: under one ulp
# on config_hash's and config_oneblob's trained preconditioners and
# spanning_psd's at n = 256-600 in chip_smoke.py, where float32 eigh (the
# plain version) reads up to 35,000 ulps and SR stopped at half its sweeps
# 430 or more (PERF.md, slice 23).
ROOT_TOL = 32 * torch.finfo(torch.float32).eps


def float64_root(a: torch.Tensor, identity_strength: float) -> torch.Tensor:
    """The float64 root, on the CPU, of the float32 S = sym(A)·(1 − s) +
    s·I that JAX, the plain version and kernel SR all form (the same
    float32 operations, so the same bits): eigh in float64."""
    a = a.detach().cpu()
    m = a.shape[-1]
    sym = 0.5 * (a + a.t()) * (1.0 - identity_strength)
    sym = sym + identity_strength * torch.eye(m, dtype=a.dtype)
    w, v = torch.linalg.eigh(sym.double())
    return (v * w.clamp_min(1e-12) ** -0.25) @ v.t()


def root_error(root: torch.Tensor, a: torch.Tensor, identity_strength: float) -> float:
    """The largest error of ``root`` against ``float64_root(a)``, over
    that root's largest entry."""
    want = float64_root(a, identity_strength)
    return float((root.detach().cpu().double() - want).abs().max() / want.abs().max())

"""The plain path of a model: its forward and one training step's gradients
through the plain PyTorch versions of kernels G, M, MB and GB, on the
tensors the model holds.  ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernel path (``model.trainer``) against it on the card; on the
CPU the wrappers take these same plain versions.

Handles a grid alone (SoA features, config_hash) and a concatenating
Composite of grids and parameter-free encodings (AoS features in the
compute dtype, config_btf).  ``relu_flip_rows`` names the samples whose
fused-MLP input gradient differs from the plain one by a ReLU that lies
within rounding of 0 and switched.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from ..common import Activation
from ..ops.activations import activation_derivative
from ..ops.cuda.fused_mlp import fused_mlp_bwd_plain, fused_mlp_plain
from ..ops.cuda.grid_encode import grid_encode_bwd_plain, grid_encode_plain


def grid_parts(model, x: torch.Tensor) -> List[tuple]:
    """(parameter-name prefix, grid encoding, its input, first feature
    column) of each grid of the model's encoding: the encoding itself, or
    the nested grids of a Composite."""
    enc = model.network.encoding
    if hasattr(enc, "spec"):
        return [("encoding.", enc, x, 0)]
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


# Flipped ReLUs may lie this far from 0, relative to Σ|h·w| of their
# pre-activation: one bf16 ulp of the terms' magnitude, as far as z moves
# when each input of its layer rounds to its other bf16 neighbour.
FLIP_NEAR = 2.0 ** -7
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
    within ``FLIP_NEAR`` of 0 (by |z| / Σ|h·w|), each flipped one included.
    The variant with nothing flipped can match where the full batch's
    plain row does not: a product over fewer rows may sum in another
    order, and that alone moves such a pre-activation across 0.

    Returns (explained (n,) bool, the matching variant's rows (n, D_in)
    fp32 (the plain row where none matched), |z| / Σ|h·w| of the flipped
    pre-activations (n, 2), NaN where none, and of the pre-activation
    nearest 0 (n,))."""
    cdt, n = compute_dtype, rows.numel()
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
    ok_near = (near_val[:, 0] <= FLIP_NEAR)[None].repeat(len(variants), 1)
    for v, cand in enumerate(variants):
        for c in cand:
            flips[v].scatter_(1, near_idx[:, c:c + 1], 1.0)
            ok_near[v] &= near_val[:, c] <= FLIP_NEAR
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

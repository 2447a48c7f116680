"""Losses.

PyTorch counterpart of ``tcnn_tpu/losses.py`` (the reference's ten
losses, src/loss.cu:57-65 and losses/*.h).  A loss maps predictions and targets to
per-element ``values``, already divided by the element count, so the
scalar loss is their sum.  Its autograd gradient equals the reference's
hand-written one: where the reference treats a normaliser as a constant
(relative_l2.h:74 differentiates diff²/(pred²+ε) through ``diff`` only),
the normaliser is ``detach``ed, JAX's ``stop_gradient``.

A loss that treats each element alike is ``channel_agnostic``: a (B, D)
prediction and its (D, B) transpose give the same value.  The trainer
calls a loss as ``loss(prediction, target, pdf)``, which sums
``values``, so a loss that overrides ``values`` (ConstantGradient) keeps
its override.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from .registry import losses as _registry
from .registry import register_loss


class Loss:
    """Base class (``tcnn_tpu/losses.py:37-74``).  Subclasses implement
    ``elementwise(prediction, target, pdf)``."""

    channel_agnostic = True

    def elementwise(self, prediction, target, pdf):
        raise NotImplementedError

    def values(self, prediction: torch.Tensor, target: torch.Tensor,
               pdf: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-element values divided by n_total = B·D (l2.h:63-71)."""
        prediction = prediction.float()
        target = target.float()
        if pdf is None:
            pdf = torch.ones_like(target)
        n_total = prediction.shape[0] * prediction.shape[1]
        return self.elementwise(prediction, target, pdf) / n_total

    def __call__(self, prediction: torch.Tensor, target: torch.Tensor,
                 pdf: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.values(prediction, target, pdf).sum()

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": type(self).__name__.replace("Loss", "")}

    def update_hyperparams(self, cfg: Dict[str, Any]) -> None:
        """Losses are stateless; only ``otype`` may appear."""
        cfg = {k: v for k, v in cfg.items() if k.lower() != "otype"}
        if cfg:
            raise NotImplementedError(
                f"{type(self).__name__} cannot update {list(cfg)}")


class L2Loss(Loss):
    """diff²/pdf (l2.h:40-75; ``tcnn_tpu/losses.py:77-82``)."""

    def elementwise(self, prediction, target, pdf):
        diff = prediction - target
        return diff * diff / pdf


class RelativeL2Loss(Loss):
    """diff²/(pred²+0.01)/pdf with the denominator held constant
    (relative_l2.h:67-74; ``tcnn_tpu/losses.py:85-91``)."""

    def elementwise(self, prediction, target, pdf):
        diff = prediction - target
        denom = prediction.detach() ** 2 + 0.01
        return diff * diff / denom / pdf


class RelativeL2LuminanceLoss(Loss):
    """diff²/(lum²+0.01)/pdf with the prediction's luminance held
    constant (relative_l2_luminance.h:39-90; ``tcnn_tpu/losses.py:94-113``).
    For 6 or more outputs the twin RGB triples are summed first."""

    channel_agnostic = False          # mixes RGB channels along dim 1

    def elementwise(self, prediction, target, pdf):
        r, g, b = prediction[:, 0], prediction[:, 1], prediction[:, 2]
        if prediction.shape[1] >= 6:
            r = r + prediction[:, 3]
            g = g + prediction[:, 4]
            b = b + prediction[:, 5]
        lum = 0.299 * r + 0.587 * g + 0.114 * b
        denom = lum.detach() ** 2 + 0.01
        diff = prediction - target
        return diff * diff / denom[:, None] / pdf


class L1Loss(Loss):
    """|diff|/pdf (l1.h:71; ``tcnn_tpu/losses.py:116-120``)."""

    def elementwise(self, prediction, target, pdf):
        return torch.abs(prediction - target) / pdf


class RelativeL1Loss(Loss):
    """|diff|/(|pred|+1e-2)/pdf, the denominator held constant
    (relative_l1.h:71-73; ``tcnn_tpu/losses.py:123-128``)."""

    def elementwise(self, prediction, target, pdf):
        denom = torch.abs(prediction.detach()) + 1e-2
        return torch.abs(prediction - target) / denom / pdf


class MapeLoss(Loss):
    """|diff|/(|target|+1e-2)/pdf (mape.h:72-74; ``tcnn_tpu/losses.py:131-135``)."""

    def elementwise(self, prediction, target, pdf):
        return torch.abs(prediction - target) / (torch.abs(target) + 1e-2) / pdf


class SmapeLoss(Loss):
    """|diff|/(½(|pred|+|target|)+1e-2)/pdf, the denominator held constant
    (smape.h:72-74; ``tcnn_tpu/losses.py:138-143``)."""

    def elementwise(self, prediction, target, pdf):
        denom = (0.5 * (torch.abs(prediction) + torch.abs(target))).detach() + 1e-2
        return torch.abs(prediction - target) / denom / pdf


class CrossEntropyLoss(Loss):
    """−target·log(pred)/pdf; the prediction must be a PDF
    (cross_entropy.h:69-73; ``tcnn_tpu/losses.py:146-151``)."""

    def elementwise(self, prediction, target, pdf):
        return -target * torch.log(prediction) / pdf


class VarianceLoss(Loss):
    """Importance-sampling variance (variance_is.h:69-76;
    ``tcnn_tpu/losses.py:154-160``): value t²/pdf·(1/pred − 1/pdf),
    gradient −t²/pdf/pred²."""

    def elementwise(self, prediction, target, pdf):
        factor = target * target / pdf
        return factor / prediction - (factor / pdf).detach()


class ConstantGradientLoss(Loss):
    """A fixed per-dim gradient with values of zero (losses/constant.h:42-70;
    ``tcnn_tpu/losses.py:163-186``).  Not in the registry, as in the
    reference (internal use only)."""

    channel_agnostic = False          # (D,)-vector broadcast along dim 1

    def __init__(self, constant_gradient: Sequence[float]):
        self.constant_gradient = torch.as_tensor(constant_gradient, dtype=torch.float32)

    def elementwise(self, prediction, target, pdf):
        # value 0 with d/dpred = constant_gradient/pdf: g·pred − sg(g·pred)
        g = self.constant_gradient.to(prediction.device)[None, :] / pdf
        contrib = g * prediction
        return contrib - contrib.detach()

    def values(self, prediction, target, pdf=None):
        # Not divided by n_total: the reference's gradient is
        # loss_scale·g/pdf with no /n (constant.h:68).
        prediction = prediction.float()
        if pdf is None:
            pdf = torch.ones_like(prediction)
        return self.elementwise(prediction, prediction, pdf)


def create_loss(cfg: Dict[str, Any]) -> Loss:
    """≈ create_loss<T> (src/loss.cu:85-105); default RelativeL2."""
    return _registry.create(cfg.get("otype", "RelativeL2"), cfg)


register_loss(["L2", "MSE"], lambda cfg: L2Loss())
register_loss(["RelativeL2"], lambda cfg: RelativeL2Loss())
register_loss(["RelativeL2Luminance"], lambda cfg: RelativeL2LuminanceLoss())
register_loss(["L1", "MAE"], lambda cfg: L1Loss())
register_loss(["RelativeL1"], lambda cfg: RelativeL1Loss())
register_loss(["MAPE"], lambda cfg: MapeLoss())
register_loss(["SMAPE"], lambda cfg: SmapeLoss())
register_loss(["CrossEntropy"], lambda cfg: CrossEntropyLoss())
register_loss(["Variance"], lambda cfg: VarianceLoss())

__all__ = [
    "ConstantGradientLoss", "CrossEntropyLoss", "L1Loss", "L2Loss", "Loss",
    "MapeLoss", "RelativeL1Loss", "RelativeL2Loss", "RelativeL2LuminanceLoss",
    "SmapeLoss", "VarianceLoss", "create_loss",
]

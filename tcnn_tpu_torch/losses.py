"""Losses.

PyTorch counterpart of ``tcnn_tpu/losses.py`` (the reference's
src/loss.cu and losses/*.h).  A loss maps predictions and targets to
per-element ``values``, already divided by the element count, so the
scalar loss is their sum.  Its autograd gradient equals the reference's
hand-written one: where the reference treats a normaliser as a constant
(relative_l2.h:74 differentiates diff²/(pred²+ε) through ``diff`` only),
the normaliser is ``detach``ed, JAX's ``stop_gradient``.

Every loss here treats each element alike (``channel_agnostic``), so a
(B, D) prediction and its (D, B) transpose give the same value.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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


def create_loss(cfg: Dict[str, Any]) -> Loss:
    """≈ create_loss<T> (src/loss.cu:85-105); default RelativeL2."""
    return _registry.create(cfg.get("otype", "RelativeL2"), cfg)


register_loss(["L2", "MSE"], lambda cfg: L2Loss())
register_loss(["RelativeL2"], lambda cfg: RelativeL2Loss())

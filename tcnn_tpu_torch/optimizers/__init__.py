"""Optimizer registry and JSON factory (≈ src/optimizer.cu:49-83).

PyTorch counterpart of ``tcnn_tpu/optimizers/__init__.py``.  Adam is
ported; the other optimizers of the JAX package follow in a later slice.
"""

from __future__ import annotations

from typing import Any, Dict

from ..registry import optimizers as _registry
from ..registry import register_optimizer
from .adam import Adam
from .base import Optimizer


def create_optimizer(cfg: Dict[str, Any]) -> Optimizer:
    return _registry.create(cfg.get("otype", "Adam"), cfg)


register_optimizer("Adam", lambda cfg: Adam(
    learning_rate=cfg.get("learning_rate", 1e-3),
    beta1=cfg.get("beta1", 0.9),
    beta2=cfg.get("beta2", 0.999),
    epsilon=cfg.get("epsilon", 1e-8),
    l2_reg=cfg.get("l2_reg", 1e-8),
    relative_decay=cfg.get("relative_decay", 0.0),
    absolute_decay=cfg.get("absolute_decay", 0.0),
    adabound=cfg.get("adabound", False),
    non_matrix_learning_rate_factor=cfg.get(
        "non_matrix_learning_rate_factor", 1.0),
    optimize_matrix_params=cfg.get("optimize_matrix_params", True),
    optimize_non_matrix_params=cfg.get("optimize_non_matrix_params", True),
    clipping_magnitude=cfg.get("clipping_magnitude", 0.0),
))

__all__ = ["Adam", "Optimizer", "create_optimizer"]

"""Optimizer registry and JSON factory (≈ src/optimizer.cu:49-83).

PyTorch counterpart of ``tcnn_tpu/optimizers/__init__.py``: every
optimizer of the JAX package, with its config name, defaults and
``hyperparams()``.
"""

from __future__ import annotations

from typing import Any, Dict

from ..registry import optimizers as _registry
from ..registry import register_optimizer
from .adam import Adam
from .base import Optimizer
from .sgd import SGD, Novograd
from .shampoo import Shampoo
from .wrappers import EMA, Average, Batched, Composite, ExponentialDecay, Lookahead


def create_optimizer(cfg: Dict[str, Any]) -> Optimizer:
    return _registry.create(cfg.get("otype", "Adam"), cfg)


def _nested(cfg):
    return create_optimizer(cfg.get("nested", {}))


def _composite(cfg):
    nested_cfgs = cfg["nested"]
    opts = [create_optimizer(c) for c in nested_cfgs]
    lrf = cfg.get("learning_rate_factor", 1.0)
    if any("n_params_to_optimize" in c for c in nested_cfgs):
        return Composite(opts, n_params_each=[
            int(c.get("n_params_to_optimize", 0)) for c in nested_cfgs],
            learning_rate_factor=lrf)
    return Composite(opts, kinds_each=[
        c.get("params", "matrix" if i == 0 else "other")
        for i, c in enumerate(nested_cfgs)], learning_rate_factor=lrf)


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
register_optimizer("SGD", lambda cfg: SGD(
    learning_rate=cfg.get("learning_rate", 1e-3),
    l2_reg=cfg.get("l2_reg", 1e-8),
))
register_optimizer("Novograd", lambda cfg: Novograd(
    learning_rate=cfg.get("learning_rate", 1e-3),
    beta1=cfg.get("beta1", 0.9),
    beta2=cfg.get("beta2", 0.999),
    epsilon=cfg.get("epsilon", 1e-8),
    relative_decay=cfg.get("relative_decay", 0.0),
    absolute_decay=cfg.get("absolute_decay", 0.0),
))
register_optimizer("EMA", lambda cfg: EMA(
    _nested(cfg), decay=cfg.get("decay", 0.99),
    full_precision=cfg.get("full_precision", False)))
register_optimizer("Average", lambda cfg: Average(
    _nested(cfg), n_samples=cfg.get("n_samples", 128)))
register_optimizer("Batched", lambda cfg: Batched(
    _nested(cfg), batch_size_multiplier=cfg.get("batch_size_multiplier", 16)))
register_optimizer("Lookahead", lambda cfg: Lookahead(
    _nested(cfg), alpha=cfg.get("alpha", 0.5), n_steps=cfg.get("n_steps", 16)))
register_optimizer("ExponentialDecay", lambda cfg: ExponentialDecay(
    _nested(cfg),
    decay_base=cfg.get("decay_base", 0.1),
    decay_start=cfg.get("decay_start", 10000),
    decay_end=cfg.get("decay_end", 10000000),
    decay_interval=cfg.get("decay_interval", 10000),
))
register_optimizer("Composite", _composite)
register_optimizer("Shampoo", lambda cfg: Shampoo(
    learning_rate=cfg.get("learning_rate", 1e-3),
    beta1=cfg.get("beta1", 0.9),
    beta2=cfg.get("beta2", 0.99),
    beta3=cfg.get("beta3", 0.9),
    beta_shampoo=cfg.get("beta_shampoo", 0.9),
    epsilon=cfg.get("epsilon", 1e-8),
    identity=cfg.get("identity", 0.01),
    cg_on_momentum=cfg.get("cg_on_momentum", True),
    l2_reg=cfg.get("l2_reg", 1e-5),
    relative_decay=cfg.get("relative_decay", 0.0),
    absolute_decay=cfg.get("absolute_decay", 0.0),
    frobenius_normalization=cfg.get("frobenius_normalization", True),
))

__all__ = [
    "Adam", "Average", "Batched", "Composite", "EMA", "ExponentialDecay",
    "Lookahead", "Novograd", "Optimizer", "SGD", "Shampoo", "create_optimizer",
]

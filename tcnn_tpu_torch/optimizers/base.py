"""Optimizer protocol.

PyTorch counterpart of ``tcnn_tpu/optimizers/base.py`` (the reference's
optimizer.h:39-63).  The JAX package's optimizers are pure functions
over parameter pytrees; here, in PyTorch's idiom, they update in place:

    state = opt.init(params, layout)     # dicts keyed by parameter name
    opt.step(state, grads, params)       # updates params and state in place
    opt.custom_weights(state, params)    # inference weights, or None

``params`` and ``grads`` map a parameter's dotted name to its tensor;
``layout`` maps it to ``"matrix"`` or ``"other"`` (``Module.param_layout``):
the reference treats weight matrices and everything else (hash tables)
differently in L2 regularisation, learning rate and lazy stepping
(adam.h:76-118).  ``step`` allocates nothing that depends on the step, so
a training step can be captured in a CUDA graph and replayed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]


def weight_decay(relative, absolute, weight: torch.Tensor) -> torch.Tensor:
    """(1−rel)·w − copysign(abs, w) (common_device.h:870-873)."""
    return (1.0 - relative) * weight - torch.copysign(absolute, weight)


class Optimizer:
    def init(self, params: Params, layout: Dict[str, str]) -> State:
        raise NotImplementedError

    def step(self, state: State, grads: Params, params: Params,
             lr_scale: float = 1.0) -> None:
        raise NotImplementedError

    def custom_weights(self, state: State, params: Params) -> Optional[Params]:
        """Weights to use for inference if different from the trained
        ones (≈ Optimizer::custom_weights, optimizer.h:52)."""
        return None

    @property
    def learning_rate(self) -> float:
        return 0.0

    def hyperparams(self) -> Dict[str, Any]:
        raise NotImplementedError

    #: json key -> attribute name; drives :meth:`update_hyperparams`.
    _HYPERPARAM_ATTRS: Dict[str, str] = {}

    def update_hyperparams(self, cfg: Dict[str, Any]) -> None:
        """Runtime hyperparameter update (≈ Object::update_hyperparams,
        object.h:56-61).  A captured training graph holds the old values:
        ``Trainer.update_hyperparams`` drops it."""
        for k, v in cfg.items():
            if k.lower() == "otype":
                continue
            attr = self._HYPERPARAM_ATTRS.get(k)
            if attr is None:
                raise NotImplementedError(
                    f"{type(self).__name__} does not support updating {k!r}")
            cur = getattr(self, attr)
            setattr(self, attr, type(cur)(v))

    @property
    def name(self) -> str:
        return str(self.hyperparams().get("otype", type(self).__name__))

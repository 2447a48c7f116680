"""SGD and Novograd.

PyTorch counterpart of ``tcnn_tpu/optimizers/sgd.py:12-128`` (the
reference's optimizers/sgd.h:44-70 and novograd.h:45-150).  In place,
into scratch buffers made at ``init``, in the JAX package's order of
operations.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .base import (Optimizer, Params, ParamTree, State, state_device, step_scalar,
                   weight_decay)


class SGD(Optimizer):
    """p − lr·(g + l2·p), L2 on "matrix" parameters only (sgd.h:58)."""

    _HYPERPARAM_ATTRS = {"learning_rate": "lr", "l2_reg": "l2_reg"}  # sgd.h:116-124

    def __init__(self, learning_rate: float = 1e-3, l2_reg: float = 1e-8):
        self.lr = float(learning_rate)
        self.l2_reg = float(l2_reg)
        self._layout: Dict[str, str] = {}
        self._scratch: Dict[str, torch.Tensor] = {}

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        self._layout = dict(layout)
        self._scratch = {n: torch.empty_like(p, dtype=torch.float32)
                         for n, p in params.items()}
        return {"step": step_scalar(params, device)}

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        lr = self.lr * lr_scale
        for name, p in params.items():
            s = self._scratch[name]
            if self._layout[name] == "matrix":
                torch.mul(p, self.l2_reg, out=s)
                s.add_(grads[name])
            else:
                s.copy_(grads[name])
            p.sub_(s.mul_(lr))
        state["step"].add_(1)

    @property
    def learning_rate(self):
        return self.lr

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "SGD", "learning_rate": self.lr, "l2_reg": self.l2_reg}


class Novograd(Optimizer):
    """Per-layer second moment v = EMA of Σg² over the layer, per-element
    m = β1·m + (1−β1)·g/(√v+ε), p ← decay(p) − lr·m (novograd.h:45-120).
    Only "matrix" parameters step, as in the reference."""

    _HYPERPARAM_ATTRS = {
        "learning_rate": "lr", "beta1": "beta1", "beta2": "beta2",
        "epsilon": "epsilon", "relative_decay": "relative_decay",
        "absolute_decay": "absolute_decay",
    }  # novograd.h:187-213

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 relative_decay: float = 0.0, absolute_decay: float = 0.0):
        self.lr = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.relative_decay = float(relative_decay)
        self.absolute_decay = float(absolute_decay)
        self._layout: Dict[str, str] = {}
        self._scratch: Dict[str, torch.Tensor] = {}

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        self._layout = dict(layout)
        self._scratch = {n: torch.empty_like(p, dtype=torch.float32)
                         for n, p in params.items() if layout[n] == "matrix"}
        dev = state_device(params, device)
        return {
            "mu": ParamTree({n: torch.zeros_like(p, dtype=torch.float32)
                             for n, p in params.items()}),
            "v": ParamTree({n: torch.zeros((), dtype=torch.float32, device=dev)
                            for n in params}),
            "step": step_scalar(params, dev),
        }

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        lr = self.lr * lr_scale
        for name, p in params.items():
            if self._layout[name] != "matrix":
                continue
            g, mu, v, s = grads[name], state["mu"][name], state["v"][name], self._scratch[name]
            torch.mul(g, g, out=s)
            v.mul_(self.beta2).add_(s.sum().mul_(1 - self.beta2))
            torch.mul(g, 1 - self.beta1, out=s)
            s.div_(v.sqrt().add_(self.epsilon))
            mu.mul_(self.beta1).add_(s)
            torch.mul(mu, lr, out=s)
            if self.relative_decay or self.absolute_decay:
                p.copy_(weight_decay(self.relative_decay * lr, self.absolute_decay * lr, p))
            p.sub_(s)
        state["step"].add_(1)

    @property
    def learning_rate(self):
        return self.lr

    def hyperparams(self) -> Dict[str, Any]:
        return {
            "otype": "Novograd",
            "learning_rate": self.lr,
            "beta1": self.beta1,
            "beta2": self.beta2,
            "epsilon": self.epsilon,
            "relative_decay": self.relative_decay,
            "absolute_decay": self.absolute_decay,
        }

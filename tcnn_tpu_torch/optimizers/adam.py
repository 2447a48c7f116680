"""Adam / AdaBound optimizer.

PyTorch counterpart of ``tcnn_tpu/optimizers/adam.py:31-174`` (the
reference's fused adam_step kernel, optimizers/adam.h:48-180), in plain
PyTorch: the JAX package leaves this elementwise update to XLA, not to a
Pallas kernel.  Every behaviour is kept:

  * per-element step counters: "other" parameters (hash-table entries)
    advance only where their gradient is nonzero (adam.py:97, :101), and
    each element is debiased by its own count (:108-109).  A never-stepped
    element computes 0/0 there, which the final ``where`` masks;
  * L2 regularisation on "matrix" parameters only (:93-95);
  * ``non_matrix_learning_rate_factor``;
  * AdaBound bounds from the global step; relative and absolute decay;
    clipping.

State, by parameter name: fp32 ``mu`` and ``nu`` and the step counters
``param_steps``, plus the global ``step``.  The counters are int32, where
JAX keeps uint32: PyTorch has few uint32 operations, and int32 holds
2^31 − 1 steps.  Every update is in place, into the state and into
scratch buffers made at ``init``, so a step allocates nothing (except
with decay or AdaBound on) and can be captured in a CUDA graph.  The
operations run in the JAX package's order, so the results agree to
float32 rounding.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .base import Optimizer, Params, State, weight_decay

_F32_MAX = float(torch.finfo(torch.float32).max)


class Adam(Optimizer):
    def __init__(
        self,
        learning_rate: float = 1e-3,
        beta1: float = 0.9,
        beta2: float = 0.999,
        epsilon: float = 1e-8,
        l2_reg: float = 1e-8,
        relative_decay: float = 0.0,
        absolute_decay: float = 0.0,
        adabound: bool = False,
        non_matrix_learning_rate_factor: float = 1.0,
        optimize_matrix_params: bool = True,
        optimize_non_matrix_params: bool = True,
        clipping_magnitude: float = 0.0,
    ):
        self.lr = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.l2_reg = float(l2_reg)
        self.relative_decay = float(relative_decay)
        self.absolute_decay = float(absolute_decay)
        self.adabound = bool(adabound)
        self.non_matrix_lr_factor = float(non_matrix_learning_rate_factor)
        self.optimize_matrix = bool(optimize_matrix_params)
        self.optimize_non_matrix = bool(optimize_non_matrix_params)
        self.clipping_magnitude = float(clipping_magnitude)
        self._layout: Dict[str, str] = {}
        self._scratch: Dict[str, Dict[str, torch.Tensor]] = {}

    def init(self, params: Params, layout: Dict[str, str]) -> State:
        if set(layout) != set(params):
            raise ValueError(f"layout names {sorted(layout)} != parameter "
                             f"names {sorted(params)}")
        self._layout = dict(layout)
        self._scratch = {
            n: {"g": torch.empty_like(p, dtype=torch.float32),
                "a": torch.empty_like(p, dtype=torch.float32),
                "b": torch.empty_like(p, dtype=torch.float32),
                "upd": torch.empty_like(p, dtype=torch.bool)}
            for n, p in params.items()}
        any_p = next(iter(params.values()))
        return {
            "mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "param_steps": {n: torch.zeros_like(p, dtype=torch.int32)
                            for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=any_p.device),
        }

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params,
             lr_scale: float = 1.0) -> None:
        if not self._layout:
            raise RuntimeError("Adam.step called before init(params, layout)")
        state["step"].add_(1)
        if self.adabound:
            # AdaBound lr bounds from the global step (adam.h:152-159).
            tf = state["step"].float()
            lower = 0.1 - 0.1 / ((1.0 - self.beta2) * tf + 1.0)
            upper = 0.1 + 0.1 / ((1.0 - self.beta2) * tf)
        else:
            lower, upper = 0.0, _F32_MAX
        for name, p in params.items():
            self._leaf_step(p, grads[name], state["mu"][name],
                            state["nu"][name], state["param_steps"][name],
                            self._layout[name] == "matrix",
                            self._scratch[name], lr_scale, lower, upper)

    def _leaf_step(self, p, g, mu, nu, steps, is_matrix, s, lr_scale,
                   lower, upper):
        if is_matrix and not self.optimize_matrix:
            return        # update is False everywhere: nothing changes
        g32, a, b, upd = s["g"], s["a"], s["b"], s["upd"]
        if is_matrix:
            torch.mul(p, self.l2_reg, out=g32)
            g32.add_(g)                                  # g + l2·p
        else:
            g32.copy_(g)
            torch.ne(g32, 0, out=upd)
            if not self.optimize_non_matrix:
                upd.zero_()

        def masked(new, old):
            # where(update, new, old), written into old
            if is_matrix:
                old.copy_(new)
            else:
                torch.where(upd, new, old, out=old)

        torch.mul(mu, self.beta1, out=a)
        torch.mul(g32, 1 - self.beta1, out=b)
        masked(a.add_(b), mu)
        torch.mul(nu, self.beta2, out=a)
        torch.mul(g32, 1 - self.beta2, out=b)
        masked(a.add_(b.mul_(g32)), nu)
        steps.add_(1 if is_matrix else upd)

        lr = self.lr * lr_scale
        if not is_matrix:
            lr = lr * self.non_matrix_lr_factor
        # Debiasing by each element's own step count (adam.h:106-108):
        # b = lr·sqrt(1 − β2^t)/(1 − β1^t), 0/0 where t = 0.
        a.copy_(steps)
        torch.pow(self.beta2, a, out=b)
        b.neg_().add_(1).sqrt_().mul_(lr)
        torch.pow(self.beta1, a, out=a)
        b.div_(a.neg_().add_(1))
        # a = clip(b/(sqrt(nu) + ε), lower, upper)
        torch.sqrt(nu, out=a)
        a.add_(self.epsilon)
        torch.div(b, a, out=a)
        a.clamp_(lower, upper)
        a.mul_(mu)
        if self.relative_decay or self.absolute_decay:
            decayed = weight_decay(self.relative_decay * b,
                                   self.absolute_decay * b, p)
            torch.sub(decayed, a, out=a)
        else:
            torch.sub(p, a, out=a)
        if self.clipping_magnitude != 0.0:
            a.clamp_(-self.clipping_magnitude, self.clipping_magnitude)
        masked(a, p)

    @property
    def learning_rate(self):
        return self.lr

    # Runtime-updatable knobs (adam.h:240-270).
    _HYPERPARAM_ATTRS = {
        "learning_rate": "lr", "beta1": "beta1", "beta2": "beta2",
        "epsilon": "epsilon", "l2_reg": "l2_reg",
        "relative_decay": "relative_decay",
        "absolute_decay": "absolute_decay",
        "non_matrix_learning_rate_factor": "non_matrix_lr_factor",
        "clipping_magnitude": "clipping_magnitude",
    }

    def hyperparams(self) -> Dict[str, Any]:
        return {
            "otype": "Adam",
            "learning_rate": self.lr,
            "beta1": self.beta1,
            "beta2": self.beta2,
            "epsilon": self.epsilon,
            "l2_reg": self.l2_reg,
            "relative_decay": self.relative_decay,
            "absolute_decay": self.absolute_decay,
            "adabound": self.adabound,
            "non_matrix_learning_rate_factor": self.non_matrix_lr_factor,
            "optimize_matrix_params": self.optimize_matrix,
            "optimize_non_matrix_params": self.optimize_non_matrix,
            "clipping_magnitude": self.clipping_magnitude,
        }

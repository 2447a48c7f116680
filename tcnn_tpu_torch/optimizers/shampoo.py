"""Shampoo second-order optimizer.

PyTorch counterpart of ``tcnn_tpu/optimizers/shampoo.py`` (the
reference's optimizers/shampoo.h).  Per weight matrix G (m×n):

    m_t = debiased-EMA_β1(g);  v_t = debiased-EMA_β2(g²)
    momentum = m_t/(√v_t+ε)
    L = debiased-EMA_β3(P Pᵀ), R = debiased-EMA_β3(Pᵀ P)
        where P = momentum if cg_on_momentum else g
    at t = 1 and every 10 steps below t = 100, every 200 after:
        L_root = (sym(L)·(1−id)+id·I)^(−1/4), the same for R
    shampoo_momentum = debiased-EMA_β_shampoo(L_root · momentum · R_root)
    lr_eff = lr·‖momentum‖_F/‖shampoo_momentum‖_F   (frobenius_normalization)
    w ← weight_decay(w) − lr_eff·shampoo_momentum

Other parameters (hash tables) take the plain momentum update.

The refresh is JAX's ``lax.cond`` on the device counter
(``shampoo.py:140-141``, ``:166-176``): ``refresh_due(t)`` is its
predicate on a counter tensor.  After the L and R updates of a step, one
call of ``ops/cuda/shampoo_root.py::shampoo_refresh_roots`` takes every
matrix's L and R.  On the card that is kernel SR, which reads the counter
from device memory and, on a refresh step, diagonalises each matrix by
Jacobi rotations and writes its root; on the CPU it is the plain version,
``inverse_4th_root_psd`` (``torch.linalg.eigh``, as JAX's
``jnp.linalg.eigh``, ``shampoo.py:43-50``) under the same predicate.  The
products ``src @ src.T`` and ``L_root @ momentum @ R_root`` are
``torch.matmul``, as JAX leaves them to XLA.  Eigenvectors differ by sign
and order between solvers; the root does not depend on them.

A step reads nothing back from the device (the learning rate, the decays
and the norms stay tensors), so it can be captured in a CUDA graph:
``Trainer.make_training_loop``, ``make_training_step`` and the parallel
layers' compiled steps replay it, refreshing on the steps JAX refreshes.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .base import (Optimizer, Params, ParamTree, State, state_device, step_scalar,
                   weight_decay)


def refresh_due(t: torch.Tensor) -> torch.Tensor:
    """Whether step ``t`` (the counter after this step's increment, any
    integer tensor) refreshes the roots: t = 1, then every 10 steps below
    t = 100 and every 200 from there (shampoo.h:832-838), elementwise."""
    return (t == 1) | (t % torch.where(t < 100, 10, 200) == 0)


def inverse_4th_root_psd(a: torch.Tensor, identity_strength: float) -> torch.Tensor:
    """(sym(A)·(1−s) + s·I)^(−1/4) by eigendecomposition: the plain
    version of kernel SR."""
    m = a.shape[-1]
    sym = 0.5 * (a + a.t()) * (1.0 - identity_strength)
    sym = sym + identity_strength * torch.eye(m, dtype=a.dtype, device=a.device)
    w, v = torch.linalg.eigh(sym)
    w = torch.clamp_min(w, 1e-12)
    return (v * (w ** -0.25)[None, :]) @ v.t()


class Shampoo(Optimizer):
    _HYPERPARAM_ATTRS = {
        "learning_rate": "lr", "beta1": "beta1", "beta2": "beta2",
        "beta3": "beta3", "beta_shampoo": "beta_shampoo",
        "epsilon": "epsilon", "identity": "identity_strength",
        "cg_on_momentum": "cg_on_momentum", "l2_reg": "l2_reg",
        "relative_decay": "relative_decay",
        "absolute_decay": "absolute_decay",
        "frobenius_normalization": "frobenius_normalization",
    }  # shampoo.h update_hyperparams

    def __init__(
        self,
        learning_rate: float = 1e-3,
        beta1: float = 0.9,
        beta2: float = 0.99,
        beta3: float = 0.9,
        beta_shampoo: float = 0.9,
        epsilon: float = 1e-8,
        identity: float = 0.01,
        cg_on_momentum: bool = True,
        l2_reg: float = 1e-5,
        relative_decay: float = 0.0,
        absolute_decay: float = 0.0,
        frobenius_normalization: bool = True,
    ):
        self.lr = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.beta3 = float(beta3)
        self.beta_shampoo = float(beta_shampoo)
        self.epsilon = float(epsilon)
        self.identity_strength = float(identity)
        self.cg_on_momentum = bool(cg_on_momentum)
        self.l2_reg = float(l2_reg)
        self.relative_decay = float(relative_decay)
        self.absolute_decay = float(absolute_decay)
        self.frobenius_normalization = bool(frobenius_normalization)

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        mat = ParamTree()
        for name, p in params.items():
            if layout[name] == "matrix" and p.dim() == 2:
                m, n = p.shape
                kw = {"dtype": torch.float32, "device": p.device}
                mat[name] = {"L": torch.zeros((m, m), **kw), "R": torch.zeros((n, n), **kw),
                             "L_root": torch.eye(m, **kw), "R_root": torch.eye(n, **kw),
                             "shampoo_mu": torch.zeros(p.shape, **kw)}
            else:
                mat[name] = {}
        zeros = ParamTree({n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                           for n, p in params.items()})
        return {"mu": zeros, "nu": ParamTree({n: torch.zeros_like(z) for n, z in zeros.items()}),
                "mat": mat, "step": step_scalar(params, state_device(params, device))}

    @staticmethod
    def _debias(beta: float, t: torch.Tensor):
        """(alpha, beta) of the reference's debiased EMA: the stored value
        is bias-corrected at every step."""
        bt = torch.pow(beta, t)
        bt1 = torch.pow(beta, torch.clamp_min(t - 1.0, 0.0))
        alpha = (1 - beta) / (1 - bt)
        scaled_beta = beta * (1 - bt1) / (1 - bt)
        return alpha, scaled_beta

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        from ..ops.cuda.shampoo_root import shampoo_refresh_roots

        state["step"].add_(1)
        t = state["step"]
        tf = t.float()
        a1, b1 = self._debias(self.beta1, tf)
        a2, b2 = self._debias(self.beta2, tf)
        a3, b3 = self._debias(self.beta3, tf)
        a_s, b_s = self._debias(self.beta_shampoo, tf)
        lr = self.lr * lr_scale

        # The momenta and preconditioners of every parameter, then one
        # refresh of all roots, then the matrices' preconditioned updates.
        matrices = []   # (parameter, momentum, preconditioner state)
        for name, p in params.items():
            g = grads[name].float() + self.l2_reg * p
            mu, nu, st = state["mu"][name], state["nu"][name], state["mat"][name]
            mu.copy_(b1 * mu + a1 * g)
            nu.copy_(b2 * nu + a2 * g * g)
            momentum = mu / (torch.sqrt(nu) + self.epsilon)
            if not st:
                self._update(p, lr, momentum)
                continue
            src = momentum if self.cg_on_momentum else g
            st["L"].copy_(b3 * st["L"] + a3 * (src @ src.t()))
            st["R"].copy_(b3 * st["R"] + a3 * (src.t() @ src))
            matrices.append((p, momentum, st))
        shampoo_refresh_roots(t, [st[k] for _, _, st in matrices for k in ("L", "R")],
                              [st[k + "_root"] for _, _, st in matrices for k in ("L", "R")],
                              self.identity_strength)
        for p, momentum, st in matrices:
            precond = st["L_root"] @ momentum @ st["R_root"]
            sh_mu = st["shampoo_mu"]
            sh_mu.copy_(b_s * sh_mu + a_s * precond)
            lr_eff = lr
            if self.frobenius_normalization:
                adam_norm = torch.sqrt(torch.sum(momentum * momentum))
                sh_norm = torch.sqrt(torch.sum(sh_mu * sh_mu)) + 1e-30
                lr_eff = lr * adam_norm / sh_norm
            self._update(p, lr_eff, sh_mu)

    def _update(self, p: torch.Tensor, lr_eff, update: torch.Tensor) -> None:
        decayed = weight_decay(self.relative_decay * lr_eff, self.absolute_decay * lr_eff, p)
        p.copy_(decayed - lr_eff * update)

    @property
    def learning_rate(self):
        return self.lr

    def hyperparams(self) -> Dict[str, Any]:
        return {
            "otype": "Shampoo",
            "learning_rate": self.lr,
            "beta1": self.beta1,
            "beta2": self.beta2,
            "beta3": self.beta3,
            "beta_shampoo": self.beta_shampoo,
            "epsilon": self.epsilon,
            "identity": self.identity_strength,
            "cg_on_momentum": self.cg_on_momentum,
            "l2_reg": self.l2_reg,
            "relative_decay": self.relative_decay,
            "absolute_decay": self.absolute_decay,
            "frobenius_normalization": self.frobenius_normalization,
        }

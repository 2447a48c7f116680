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

Other parameters (hash tables) take the plain momentum update.  The
inverse 4th root is an eigendecomposition (``torch.linalg.eigh``), as in
the JAX package (``shampoo.py:43-50``).  Eigenvectors differ by sign and
order between LAPACK and XLA; the root does not depend on them.

A step reads the device once: whether this is a refresh step.  And
``torch.linalg.eigh`` checks its LAPACK/cuSOLVER status on the host.
So a Shampoo step cannot be captured in a CUDA graph: ``capturable`` is
False, and ``Trainer.make_training_loop`` raises ``capture_error`` on the
card rather than run the steps eagerly unasked.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .base import (Optimizer, Params, ParamTree, State, state_device, step_scalar,
                   weight_decay)


def inverse_4th_root_psd(a: torch.Tensor, identity_strength: float) -> torch.Tensor:
    """(sym(A)·(1−s) + s·I)^(−1/4) by eigendecomposition."""
    m = a.shape[-1]
    sym = 0.5 * (a + a.t()) * (1.0 - identity_strength)
    sym = sym + identity_strength * torch.eye(m, dtype=a.dtype, device=a.device)
    w, v = torch.linalg.eigh(sym)
    w = torch.clamp_min(w, 1e-12)
    return (v * (w ** -0.25)[None, :]) @ v.t()


def root_error_bound(a: torch.Tensor, identity_strength: float) -> float:
    """A bound on the float32 root's error, for holding one eigensolver
    against another: an eigensolver's backward error is at most about
    n·ε·‖S‖ (S the regularised matrix), and the inverse 4th root moves by
    at most ¼·λ_min(S)^(−5/4) times that.  The matrices of a trained MLP
    span 10^5 in eigenvalue, so float32 roots of cuSOLVER and LAPACK differ
    by 1e-2 where their entries are about 1."""
    m = a.shape[-1]
    sym = (0.5 * (a + a.t()) * (1.0 - identity_strength)).double()
    sym = sym + identity_strength * torch.eye(m, dtype=sym.dtype, device=sym.device)
    w = torch.linalg.eigvalsh(sym)
    eps = torch.finfo(torch.float32).eps
    return float(0.25 * m * eps * w.abs().max() * w.min().clamp_min(1e-12) ** -1.25)


class Shampoo(Optimizer):
    capturable = False
    capture_error = (
        "Shampoo cannot be captured in a CUDA graph: its root refresh "
        "(torch.linalg.eigh) and the test for a refresh step read back from "
        "the device; train it with Trainer.training_step")

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
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(self.capture_error)
        state["step"].add_(1)
        t = state["step"]
        tf = t.float()
        a1, b1 = self._debias(self.beta1, tf)
        a2, b2 = self._debias(self.beta2, tf)
        a3, b3 = self._debias(self.beta3, tf)
        a_s, b_s = self._debias(self.beta_shampoo, tf)
        lr = self.lr * lr_scale
        # Root refresh cadence (shampoo.h:832-838).
        interval = 10 if int(t) < 100 else 200
        refresh = int(t) == 1 or int(t) % interval == 0

        for name, p in params.items():
            g = grads[name].float() + self.l2_reg * p
            mu, nu, st = state["mu"][name], state["nu"][name], state["mat"][name]
            mu.copy_(b1 * mu + a1 * g)
            nu.copy_(b2 * nu + a2 * g * g)
            momentum = mu / (torch.sqrt(nu) + self.epsilon)
            if st:
                src = momentum if self.cg_on_momentum else g
                st["L"].copy_(b3 * st["L"] + a3 * (src @ src.t()))
                st["R"].copy_(b3 * st["R"] + a3 * (src.t() @ src))
                if refresh:
                    st["L_root"].copy_(inverse_4th_root_psd(st["L"], self.identity_strength))
                    st["R_root"].copy_(inverse_4th_root_psd(st["R"], self.identity_strength))
                precond = st["L_root"] @ momentum @ st["R_root"]
                sh_mu = st["shampoo_mu"]
                sh_mu.copy_(b_s * sh_mu + a_s * precond)
                if self.frobenius_normalization:
                    adam_norm = torch.sqrt(torch.sum(momentum * momentum))
                    sh_norm = torch.sqrt(torch.sum(sh_mu * sh_mu)) + 1e-30
                    lr_eff = lr * adam_norm / sh_norm
                else:
                    lr_eff = lr
                update = sh_mu
            else:
                lr_eff, update = lr, momentum
            decayed = weight_decay(self.relative_decay * lr_eff,
                                   self.absolute_decay * lr_eff, p)
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

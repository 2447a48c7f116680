"""Module base classes.

PyTorch counterpart of ``tcnn_tpu/module.py``.  Where the JAX package
keeps parameters in a pytree passed to pure functions, a module here is
an ``nn.Module`` holding ``nn.Parameter``s in the JAX layout (weights
(fan_in, fan_out), grid tables flat), so that ``utils.jax_params`` can
carry a JAX parameter tree across one to one.

The explicit-derivative methods ``backward_backward_input`` and
``input_gradient`` (``tcnn_tpu/module.py:102-136``) run autograd twice
over the module's forward: the grid and fused-MLP functions carry their
own second-order backward (kernels GI, GG, RS and MB).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .common import DEFAULT_POLICY, Policy


class Module(nn.Module):
    """Base module (≈ DifferentiableObject, object.h:121)."""

    n_input_dims: int
    n_output_dims: int

    def __init__(self, policy: Optional[Policy] = None):
        super().__init__()
        self.policy = policy or DEFAULT_POLICY

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_layout(self) -> Dict[str, str]:
        """{parameter name: "matrix" | "other"} (``tcnn_tpu/module.py:53-61``).

        ``"matrix"`` marks weight matrices (L2 regularisation and the full
        learning rate in Adam, adam.h:76-91); ``"other"`` everything else
        (hash tables: ``non_matrix_learning_rate_factor`` and lazy
        stepping)."""
        return {name: "matrix" for name, _ in self.named_parameters()}

    def inference(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """Forward without gradient bookkeeping (≈ object.h:147)."""
        return self(x, **kwargs)

    def backward_backward_input(self, x: torch.Tensor, dL_dy: torch.Tensor,
                                dL_ddLdx: torch.Tensor
                                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """Second order (≈ object.h:270-340; ``tcnn_tpu/module.py:102-129``):
        the gradients of ⟨dL/dx, dL_ddLdx⟩, where dL/dx is the input
        gradient of the module at x under the output gradient dL_dy, with
        respect to dL_dy, the parameters and x.  Returns (ddLdy,
        {name: dparam}, dx); a gradient that does not flow is zero."""
        x = x.detach().requires_grad_()
        g = dL_dy.detach().requires_grad_()
        params = dict(self.named_parameters())
        with torch.enable_grad():
            y = self(x)
            (dx1,) = torch.autograd.grad(y, x, grad_outputs=g.to(y.dtype),
                                         create_graph=True)
            grads = torch.autograd.grad(dx1, [g, *params.values(), x],
                                        grad_outputs=dL_ddLdx.to(dx1.dtype),
                                        allow_unused=True)
        ddLdy, *dparams, dx = [torch.zeros_like(t) if d is None else d
                               for d, t in zip(grads, [g, *params.values(), x])]
        return ddLdy, dict(zip(params, dparams)), dx

    def input_gradient(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """d y[:, dim] / d x, (B, n_input_dims), by a one-hot output
        gradient (≈ object.h:342-366; ``tcnn_tpu/module.py:131-136``)."""
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            y = self(x)
            onehot = torch.zeros_like(y)
            onehot[:, dim] = 1.0
            (dx,) = torch.autograd.grad(y, x, grad_outputs=onehot)
        return dx

    def hyperparams(self) -> Dict[str, Any]:
        raise NotImplementedError


class Encoding(Module):
    """Input encoding base (≈ encoding.h:39-73)."""


class Network(Module):
    """Network base (≈ network.h:40-57)."""

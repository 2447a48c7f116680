"""Activation functions.

PyTorch counterpart of ``tcnn_tpu/ops/activations.py``: the nine
activations of the reference (common_device.h:103-304).  The fused-MLP
kernel (``csrc/fused_mlp.cu``) applies the same maps in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import Activation

K_ACT = 10.0


def apply_activation(x: torch.Tensor, act: Activation) -> torch.Tensor:
    if act == Activation.NONE:
        return x
    if act == Activation.RELU:
        return torch.clamp_min(x, 0)
    if act == Activation.LEAKY_RELU:
        return torch.clamp_min(x, 0) + 0.01 * torch.clamp_max(x, 0)
    if act == Activation.EXPONENTIAL:
        return torch.exp(x)
    if act == Activation.SINE:
        return torch.sin(x)
    if act == Activation.SIGMOID:
        return torch.sigmoid(x)
    if act == Activation.SQUAREPLUS:
        # X = K_ACT*x; 0.5*(X + sqrt(X^2+4))/K_ACT
        xk = x * K_ACT
        return 0.5 * (xk + torch.sqrt(xk * xk + 4.0)) / K_ACT
    if act == Activation.SOFTPLUS:
        # X = K_ACT*x; log(exp(X)+1)/K_ACT  (numerically stable form)
        return F.softplus(x * K_ACT) / K_ACT
    if act == Activation.TANH:
        return torch.tanh(x)
    raise ValueError(f"Unsupported activation: {act}")


def activation_derivative(x: torch.Tensor, act: Activation) -> torch.Tensor:
    """d(act)/dx at the pre-activation ``x``, for the explicit backward of
    the fused MLP (``tcnn_tpu/ops/activations.py:47-74``)."""
    if act == Activation.NONE:
        return torch.ones_like(x)
    if act == Activation.RELU:
        return (x > 0).to(x.dtype)
    if act == Activation.LEAKY_RELU:
        return torch.where(x > 0, 1.0, 0.01).to(x.dtype)
    if act == Activation.EXPONENTIAL:
        return torch.exp(x)
    if act == Activation.SINE:
        return torch.cos(x)
    if act == Activation.SIGMOID:
        s = torch.sigmoid(x)
        return s * (1 - s)
    if act == Activation.SQUAREPLUS:
        xk = x * K_ACT
        return 0.5 * (1.0 + xk / torch.sqrt(xk * xk + 4.0))
    if act == Activation.SOFTPLUS:
        return torch.sigmoid(x * K_ACT)
    if act == Activation.TANH:
        t = torch.tanh(x)
        return 1 - t * t
    raise ValueError(f"Unsupported activation: {act}")

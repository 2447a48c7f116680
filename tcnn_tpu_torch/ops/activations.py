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


def apply_activation(x: torch.Tensor, act: Activation,
                     graph_in_x: bool = True) -> torch.Tensor:
    """``act(x)``.  ReLU and LeakyReLU take their derivative at 0 from the
    side below, as ``activation_derivative`` and the kernels do (z > 0).
    With ``graph_in_x`` their derivative stays a function of x
    (``torch.relu``), so a second derivative gives x a gradient of zeros,
    as JAX does; without it the derivative is a constant mask, and a
    second derivative builds no graph of zeros through it (x gets none)."""
    if act == Activation.NONE:
        return x
    if act == Activation.RELU:
        return torch.relu(x) if graph_in_x else torch.where(x > 0, x, 0.0)
    if act == Activation.LEAKY_RELU:
        return F.leaky_relu(x, 0.01) if graph_in_x else torch.where(x > 0, x, 0.01 * x)
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


def is_invertible(act: Activation) -> bool:
    """Whether act' can be computed from the output value alone
    (``tcnn_tpu/ops/activations.py:77``; warp_activation_backward,
    common_device.h:171-236)."""
    return act in (Activation.NONE, Activation.RELU, Activation.LEAKY_RELU,
                   Activation.EXPONENTIAL, Activation.SIGMOID, Activation.TANH)

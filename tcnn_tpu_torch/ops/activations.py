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

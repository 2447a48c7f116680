"""Module base classes.

PyTorch counterpart of ``tcnn_tpu/module.py``.  Where the JAX package
keeps parameters in a pytree passed to pure functions, a module here is
an ``nn.Module`` holding ``nn.Parameter``s in the JAX layout (weights
(fan_in, fan_out), grid tables flat), so that ``utils.jax_params`` can
carry a JAX parameter tree across one to one.

The explicit-derivative methods (``backward_backward_input``,
``input_gradient``) arrive with the second-order slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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

    def inference(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """Forward without gradient bookkeeping (≈ object.h:147)."""
        return self(x, **kwargs)

    def hyperparams(self) -> Dict[str, Any]:
        raise NotImplementedError


class Encoding(Module):
    """Input encoding base (≈ encoding.h:39-73)."""


class Network(Module):
    """Network base (≈ network.h:40-57)."""

"""Trainer, inference half.

PyTorch counterpart of the inference methods of ``tcnn_tpu/trainer.py``
(:281-299).  The model's ``nn.Parameter``s are the state; the training
step, the loss and the optimizer arrive in slice 2.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .common import Policy
from .module import Module


class Trainer:
    def __init__(self, model: Module, optimizer=None, loss=None,
                 seed: int = 1337, policy: Optional[Policy] = None):
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.policy = policy or model.policy
        self.seed = seed

    def inference_params(self) -> Dict[str, torch.Tensor]:
        """Parameters used for inference, by name.  The optimizer's
        custom weights (EMA/Average, trainer.h:329-333) take their place
        once optimizers are ported; until then, the model's own."""
        return dict(self.model.named_parameters())

    def inference(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_input_dims) → (B, n_output_dims) in the policy's output
        dtype, without gradient bookkeeping."""
        with torch.inference_mode():
            return self.model.inference(x)

"""FusedMLP: the counterpart of FullyFusedMLP.

PyTorch counterpart of ``tcnn_tpu/models/networks/fused_mlp.py``.  On a
CUDA device the whole forward is one launch of kernel M and the whole
backward one launch of kernel MB (``ops/cuda/fused_mlp.py``,
``FusedMLPFunction``; its second and third order through
``FusedMLPBackwardFunction``) at every batch size, at any depth and at any
input width: a chain of launches over runs of layers beyond what one launch
takes (``m_plan``, ``mb_plan``; a first layer whose weights and input tile
do not fit one CTA's shared memory runs alone through the instances of M
and MB that stream it in chunks of its inputs, ``fused_mlp_wide_fwd`` and
``fused_mlp_wide_bwd``), as JAX caps only widths.  The JAX package's batch
threshold for its Pallas kernels was a TPU measurement and is not
carried over.  With 0 hidden layers the network is the plain single
matmul under autograd, as in the JAX package.  Widths are restricted to
{16, 32, 64, 128} (fully_fused_mlp.cu:893-896).
"""

from __future__ import annotations

import torch

from ...common import Activation
from ...ops.cuda.fused_mlp import SUPPORTED_WIDTHS, FusedMLPFunction
from ...registry import register_network
from .mlp import MLP, make_mlp


class FusedMLP(MLP):
    SUPPORTED_WIDTHS = SUPPORTED_WIDTHS

    def __init__(self, *args, **kwargs):
        kwargs["otype"] = "FullyFusedMLP"
        super().__init__(*args, **kwargs)
        if self.n_neurons not in self.SUPPORTED_WIDTHS:
            raise ValueError(
                f"FullyFusedMLP only supports widths {self.SUPPORTED_WIDTHS} "
                f"(got {self.n_neurons}); use otype=MLP/CutlassMLP for "
                "arbitrary widths")

    # Takes (D_in, B) feature-major input, the grid encoding's layout.
    accepts_soa_input = True
    # Can emit (D_out, B) feature-major output.
    supports_soa_output = True

    def forward(self, x: torch.Tensor, input_soa: bool = False,
                output_soa: bool = False) -> torch.Tensor:
        if self._n_hidden_layers == 0:
            return super().forward(x, input_soa, output_soa)
        return FusedMLPFunction.apply(x, self.activation,
                                      self.output_activation,
                                      self.policy.compute_dtype,
                                      self.policy.output_dtype, input_soa,
                                      output_soa, *self.layers)


# "MegakernelMLP" is the reference's legacy alias (src/network.cu:50).
register_network(
    ["FullyFusedMLP", "MegakernelMLP"],
    lambda cfg, n_in, n_out, policy=None, **kw: make_mlp(
        cfg, n_in, n_out, policy, cls=FusedMLP, **kw))

"""Encoding ∘ Network composition (network_with_input_encoding.h:41-190).

PyTorch counterpart of
``tcnn_tpu/models/network_with_input_encoding.py``.  Parameters are the
two submodules ``encoding`` and ``network``, which mirror the JAX tree
{"encoding": ..., "network": ...}.  When the encoding prefers SoA
output and the network accepts SoA input, the (L·F, B) features flow
straight from the grid kernel into the MLP kernel with no transpose, and
the gradients back the same way: the MLP's input gradient, in the SoA
layout, is the grid's output gradient, for the table and, where x needs
one, for x (kernel GI), to second order under ``create_graph``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..common import Policy
from ..module import Encoding, Module, Network


class NetworkWithInputEncoding(Module):
    def __init__(self, encoding: Encoding, network: Network,
                 policy: Optional[Policy] = None):
        super().__init__(policy or network.policy)
        if network.n_input_dims != encoding.n_output_dims:
            raise ValueError(
                f"network n_input_dims ({network.n_input_dims}) must equal "
                f"encoding n_output_dims ({encoding.n_output_dims})")
        self.encoding = encoding
        self.network = network
        self.n_input_dims = encoding.n_input_dims
        self.n_output_dims = network.n_output_dims

    def param_layout(self) -> Dict[str, str]:
        return {**{f"encoding.{n}": k
                   for n, k in self.encoding.param_layout().items()},
                **{f"network.{n}": k
                   for n, k in self.network.param_layout().items()}}

    def grid_specs(self, prefix: str = "") -> Dict[str, Any]:
        return self.encoding.grid_specs(prefix + "encoding.")

    @property
    def _use_soa(self) -> bool:
        return (getattr(self.encoding, "prefers_soa", False)
                and getattr(self.network, "accepts_soa_input", False))

    @property
    def supports_soa_output(self) -> bool:
        return getattr(self.network, "supports_soa_output", False)

    def forward(self, x: torch.Tensor, output_soa: bool = False,
                **enc_kwargs) -> torch.Tensor:
        net_kwargs = ({"output_soa": True}
                      if output_soa and self.supports_soa_output else {})
        if self._use_soa:
            feats = self.encoding(x, soa=True, **enc_kwargs)
            y = self.network(feats, input_soa=True, **net_kwargs)
        else:
            feats = self.encoding(x, **enc_kwargs)
            y = self.network(feats, **net_kwargs)
        if output_soa and not net_kwargs:
            y = y.t()
        return y

    def hyperparams(self) -> Dict[str, Any]:
        return {
            "otype": "NetworkWithInputEncoding",
            "encoding": self.encoding.hyperparams(),
            "network": self.network.hyperparams(),
        }

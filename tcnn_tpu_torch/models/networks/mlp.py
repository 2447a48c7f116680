"""MLP network: the plain bias-free layer chain.

PyTorch counterpart of ``tcnn_tpu/models/networks/mlp.py`` (the
reference's CutlassMLP):

    h_0 = act(x W_0);  h_i = act(h_{i-1} W_i);  y = out_act(h_n W_out)

Weights are ``nn.Parameter``s of shape (fan_in, fan_out), the JAX
layout.  The total number of matmuls is n_hidden_layers + 1;
n_hidden_layers = 0 is a single input→output matmul.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ...common import Activation, Policy, resolve_device
from ...module import Network
from ...ops.cuda.fused_mlp import fused_mlp_plain
from ...registry import register_network


def xavier_uniform(fan_in: int, fan_out: int, generator=None,
                   scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """U(±scale·√(6/(fan_in+fan_out))) (gpu_matrix.h:284-299)."""
    a = scale * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(fan_in, fan_out, dtype=dtype).uniform_(
        -a, a, generator=generator)


def siren_uniform(fan_in: int, fan_out: int, generator=None,
                  scale: float = 1.0, first: bool = False,
                  dtype=torch.float32) -> torch.Tensor:
    """SIREN init (gpu_matrix.h:335-370): U(±scale·√(6/fan_in)); the
    first layer U(±scale·30/fan_in)."""
    a = scale * (30.0 / fan_in if first else math.sqrt(6.0 / fan_in))
    return torch.empty(fan_in, fan_out, dtype=dtype).uniform_(
        -a, a, generator=generator)


class MLP(Network):
    def __init__(
        self,
        n_input_dims: int,
        n_output_dims: int,
        n_neurons: int = 128,
        n_hidden_layers: int = 5,
        activation: Activation = Activation.RELU,
        output_activation: Activation = Activation.NONE,
        policy: Optional[Policy] = None,
        otype: str = "MLP",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__(policy)
        self.n_input_dims = n_input_dims
        self.n_output_dims = n_output_dims
        self.n_neurons = int(n_neurons)
        self._n_hidden_layers = int(n_hidden_layers)
        self.activation = activation
        self.output_activation = output_activation
        self.otype = otype
        # Initialised on the CPU from the generator, so that a seed gives
        # the same weights on every device.
        device = resolve_device(device)
        ws = []
        for i, (fi, fo) in enumerate(self._layer_dims()):
            if activation == Activation.SINE:
                w = siren_uniform(fi, fo, generator, first=(i == 0),
                                  dtype=self.policy.param_dtype)
            else:
                w = xavier_uniform(fi, fo, generator,
                                   dtype=self.policy.param_dtype)
            ws.append(nn.Parameter(w.to(device)))
        self.layers = nn.ParameterList(ws)

    @property
    def width(self) -> int:
        return self.n_neurons

    @property
    def n_hidden_layers(self) -> int:
        return self._n_hidden_layers

    def _layer_dims(self) -> List[tuple]:
        H, W = self._n_hidden_layers, self.n_neurons
        if H == 0:
            return [(self.n_input_dims, self.n_output_dims)]
        return ([(self.n_input_dims, W)] + [(W, W)] * (H - 1)
                + [(W, self.n_output_dims)])

    def forward(self, x: torch.Tensor, input_soa: bool = False,
                output_soa: bool = False) -> torch.Tensor:
        return fused_mlp_plain(list(self.layers), x, self.activation,
                               self.output_activation,
                               self.policy.compute_dtype,
                               self.policy.output_dtype, input_soa, output_soa)

    def hyperparams(self) -> Dict[str, Any]:
        return {
            "otype": self.otype,
            "activation": self.activation.value,
            "output_activation": self.output_activation.value,
            "n_neurons": self.n_neurons,
            "n_hidden_layers": self._n_hidden_layers,
        }


def make_mlp(cfg: Dict[str, Any], n_input_dims: int, n_output_dims: int,
             policy: Optional[Policy] = None, otype: str = "MLP",
             cls=MLP, **kwargs) -> MLP:
    return cls(
        n_input_dims=n_input_dims,
        n_output_dims=n_output_dims,
        n_neurons=cfg.get("n_neurons", 128),
        n_hidden_layers=cfg.get("n_hidden_layers", 5),
        activation=Activation.from_string(cfg.get("activation", "ReLU")),
        output_activation=Activation.from_string(
            cfg.get("output_activation", "None")),
        policy=policy,
        otype=otype,
        **kwargs,
    )


# "CutlassMLP" is accepted for config compatibility: the same chain.
register_network(
    ["MLP", "CutlassMLP"],
    lambda cfg, n_in, n_out, policy=None, **kw: make_mlp(
        cfg, n_in, n_out, policy, **kw))

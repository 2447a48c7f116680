"""tcnn_tpu_torch: the PyTorch and CUDA port of ``tcnn_tpu``.

The same models and JSON configs as the JAX package, run on an NVIDIA
Hopper card through kernels written by hand for it (``csrc/``).  Plain
PyTorch versions of those kernels run for CPU tensors, when the caller
asks for the CPU.  This package imports neither jax nor ``tcnn_tpu``.

    import tcnn_tpu_torch as tcnn
    model = tcnn.create_from_config(2, 3, "configs/config_hash.json",
                                    policy=tcnn.BF16_POLICY)
    loss = model.trainer.training_step(xy, rgb)   # xy (B, 2), rgb (B, 3) on cuda
    rgb = model.trainer.inference(xy)
"""

from .common import (BF16_POLICY, DEFAULT_POLICY, Activation, GridType,
                     HashType, InterpolationType, Policy, ReductionType)
from .config import (TrainableModel, create_encoding, create_from_config,
                     create_network, create_network_with_input_encoding,
                     load_config)
from .losses import L2Loss, Loss, RelativeL2Loss, create_loss
from .models.encodings.basic import (CompositeEncoding, EmptyEncoding,
                                     FrequencyEncoding, IdentityEncoding,
                                     OneBlobEncoding, SphericalHarmonicsEncoding,
                                     TriangleWaveEncoding)
from .models.encodings.grid import GridEncoding
from .models.network_with_input_encoding import NetworkWithInputEncoding
from .models.networks.fused_mlp import FusedMLP
from .models.networks.mlp import MLP
from .module import Encoding, Module, Network
from .optimizers import Adam, Optimizer, create_optimizer
from .registry import (register_encoding, register_loss, register_network,
                       register_optimizer)
from .trainer import Trainer
from .utils.jax_params import load_jax_opt_state, load_jax_params

__all__ = [
    "Activation", "Adam", "BF16_POLICY", "CompositeEncoding", "DEFAULT_POLICY",
    "EmptyEncoding", "Encoding", "FrequencyEncoding", "FusedMLP", "GridEncoding",
    "GridType", "HashType", "IdentityEncoding", "InterpolationType", "L2Loss",
    "Loss", "MLP", "Module", "Network", "NetworkWithInputEncoding",
    "OneBlobEncoding", "Optimizer", "Policy", "ReductionType", "RelativeL2Loss",
    "SphericalHarmonicsEncoding", "TriangleWaveEncoding",
    "TrainableModel", "Trainer", "create_encoding", "create_from_config",
    "create_loss", "create_network", "create_network_with_input_encoding",
    "create_optimizer", "load_config", "load_jax_opt_state",
    "load_jax_params", "register_encoding", "register_loss",
    "register_network", "register_optimizer",
]

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
    state = model.trainer.serialize()             # the JAX package's trainer dict
    bundle = tcnn.serving.export_inference(model.trainer)
"""

from .common import (BATCH_SIZE_GRANULARITY, BF16_POLICY, DEFAULT_POLICY, Activation,
                     GridType, HashType, InterpolationType, Policy, ReductionType)
from .config import (TrainableModel, create_encoding, create_from_config,
                     create_network, create_network_with_input_encoding,
                     load_config)
from .losses import (ConstantGradientLoss, CrossEntropyLoss, L1Loss, L2Loss, Loss,
                     MapeLoss, RelativeL1Loss, RelativeL2Loss, RelativeL2LuminanceLoss,
                     SmapeLoss, VarianceLoss, create_loss)
from .models.encodings.basic import (CompositeEncoding, EmptyEncoding,
                                     FrequencyEncoding, IdentityEncoding,
                                     OneBlobEncoding, SphericalHarmonicsEncoding,
                                     TriangleWaveEncoding)
from .models.encodings.grid import GridEncoding
from .models.network_with_input_encoding import NetworkWithInputEncoding
from .models.networks.fused_mlp import FusedMLP
from .models.networks.mlp import MLP
from .module import Encoding, Module, Network
from .optimizers import (EMA, SGD, Adam, Average, Batched, Composite, ExponentialDecay,
                         Lookahead, Novograd, Optimizer, Shampoo, create_optimizer)
from .registry import (register_encoding, register_loss, register_network,
                       register_optimizer)
from . import serving
from .trainer import Trainer
from .utils.jax_params import load_jax_flat_params, load_jax_opt_state, load_jax_params

__all__ = [
    "Activation", "Adam", "Average", "BATCH_SIZE_GRANULARITY", "BF16_POLICY", "Batched", "Composite",
    "CompositeEncoding", "ConstantGradientLoss", "CrossEntropyLoss", "DEFAULT_POLICY",
    "EMA", "EmptyEncoding", "Encoding", "ExponentialDecay", "FrequencyEncoding",
    "FusedMLP", "GridEncoding", "GridType", "HashType", "IdentityEncoding",
    "InterpolationType", "L1Loss", "L2Loss", "Lookahead", "Loss", "MLP", "MapeLoss",
    "Module", "Network", "NetworkWithInputEncoding", "Novograd", "OneBlobEncoding",
    "Optimizer", "Policy", "ReductionType", "RelativeL1Loss", "RelativeL2Loss",
    "RelativeL2LuminanceLoss", "SGD", "Shampoo", "SmapeLoss",
    "SphericalHarmonicsEncoding", "TriangleWaveEncoding", "TrainableModel", "Trainer",
    "VarianceLoss", "create_encoding", "create_from_config", "create_loss",
    "create_network", "create_network_with_input_encoding", "create_optimizer",
    "load_config", "load_jax_flat_params", "load_jax_opt_state", "load_jax_params",
    "register_encoding", "register_loss", "register_network", "register_optimizer", "serving",
]

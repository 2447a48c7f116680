"""JSON config → model factory (≈ include/tiny-cuda-nn/config.h:46-63).

PyTorch counterpart of ``tcnn_tpu/config.py``: the same JSON schema,
``//`` comments included.  ``create_from_config`` returns a
``TrainableModel``: loss, optimizer, network and the trainer that owns
them (``tcnn_tpu/config.py:86-104``).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Optional, Union

import torch

from .common import Policy, resolve_device
from .losses import Loss, create_loss
from .models.network_with_input_encoding import NetworkWithInputEncoding
from .module import Encoding, Module, Network
from .optimizers import Optimizer, create_optimizer
from .registry import encodings as _encodings
from .registry import networks as _networks
from .trainer import Trainer

# Imported for their registrations.
from .models.encodings import basic as _basic_encodings  # noqa: F401
from .models.encodings import grid as _grid_encoding  # noqa: F401
from .models.networks import fused_mlp as _fused_mlp  # noqa: F401
from .models.networks import mlp as _mlp  # noqa: F401


def load_config(path_or_json: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Load a JSON config, tolerating // comments like the reference
    sample does (mlp_learning_an_image.cu:151)."""
    if isinstance(path_or_json, dict):
        return path_or_json
    with open(path_or_json) as f:
        text = f.read()
    return json.loads(re.sub(r"//[^\n]*", "", text))


def create_encoding(n_input_dims: int, cfg: Dict[str, Any],
                    policy: Optional[Policy] = None, generator=None,
                    device=None) -> Encoding:
    """≈ create_encoding<T> (src/encoding.cu:132-159); a missing otype
    is OneBlob, as in the reference."""
    otype = cfg.get("otype", "OneBlob")
    return _encodings.create(otype, n_input_dims, cfg, policy=policy,
                             generator=generator, device=device)


def create_network(cfg: Dict[str, Any], n_input_dims: int, n_output_dims: int,
                   policy: Optional[Policy] = None, generator=None,
                   device=None) -> Network:
    """≈ create_network<T> (src/network.cu:97-138)."""
    otype = cfg.get("otype", "MLP")
    return _networks.create(otype, cfg, n_input_dims, n_output_dims,
                            policy=policy, generator=generator, device=device)


def create_network_with_input_encoding(
    n_input_dims: int, n_output_dims: int,
    encoding_cfg: Dict[str, Any], network_cfg: Dict[str, Any],
    policy: Optional[Policy] = None, generator=None, device=None,
) -> NetworkWithInputEncoding:
    enc = create_encoding(n_input_dims, encoding_cfg, policy=policy,
                          generator=generator, device=device)
    net = create_network(network_cfg, enc.n_output_dims, n_output_dims,
                         policy=policy, generator=generator, device=device)
    return NetworkWithInputEncoding(enc, net, policy=policy)


@dataclasses.dataclass
class TrainableModel:
    """≈ TrainableModel (config.h:46-51)."""
    loss: Loss
    optimizer: Optimizer
    network: Module          # NetworkWithInputEncoding
    trainer: Trainer


def create_from_config(
    n_input_dims: int,
    n_output_dims: int,
    config: Union[str, Dict[str, Any]],
    policy: Optional[Policy] = None,
    seed: int = 1337,
    device=None,
) -> TrainableModel:
    """Build the model of a JSON config on ``device``.

    ``device=None`` means ``cuda`` and raises where there is no CUDA
    device; the plain PyTorch path runs on the CPU only when
    ``device="cpu"`` is asked for.  Parameters are drawn from a CPU
    ``torch.Generator`` seeded with ``seed``, encoding first.
    """
    device = resolve_device(device)
    cfg = load_config(config)
    loss = create_loss(cfg.get("loss", {}))
    optimizer = create_optimizer(cfg.get("optimizer", {}))
    generator = torch.Generator().manual_seed(seed)
    model = create_network_with_input_encoding(
        n_input_dims, n_output_dims,
        cfg.get("encoding", {"otype": "Identity"}),
        cfg.get("network", {}),
        policy=policy, generator=generator, device=device,
    )
    trainer = Trainer(model, optimizer, loss, seed=seed, policy=policy)
    return TrainableModel(loss=loss, optimizer=optimizer, network=model,
                          trainer=trainer)

"""tiny-cuda-nn's PyTorch modules over the port.

PyTorch counterpart of ``tcnn_tpu/bindings/torch_interop.py``, with the
surface of the CUDA original's ``bindings/torch/tinycudann/modules.py``:
``NetworkWithInputEncoding``, ``Network`` and ``Encoding`` are
``torch.nn.Module``s whose weights live in one flat fp32 ``nn.Parameter``,
``params``, so that code written for tinycudann runs on them unchanged:

    model = NetworkWithInputEncoding(2, 3, encoding_config, network_config)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    loss = ((model(xy) - rgb) ** 2).mean()      # xy (B, 2) on cuda
    loss.backward(); optimizer.step()

Where the JAX package crosses into JAX through two autograd Functions of
its own, here the port's modules compute, in PyTorch's idiom: ``params``
is split into one view per parameter of the port's module (built by
``create_network_with_input_encoding``, ``create_network`` or
``create_encoding``) and the module runs on those views through
``torch.func.functional_call``.  The module's autograd functions (the
grid's ``GridEncodeFunction`` and ``GridEncodeBackwardFunction``, the
fused MLP's ``FusedMLPFunction`` and ``FusedMLPBackwardFunction``) give
the first and second derivatives: on the card through kernels G and M
forward, GB and MB backward and, under double backward
(``torch.autograd.grad(..., create_graph=True)``), GI, GG and MB's
differentiable backward; on the CPU through their plain versions.  The
views' backward (one ``split``) brings each leaf's gradient into
``params.grad``.  Under ``torch.autograd.grad(y, x)`` the views are not
on the engine's path, so no table gradient is computed
(``ops/grid_ops.py::_engine_will_use``).

Layout of ``params``: the port's parameter names are the JAX parameter
tree's paths, so the leaves are laid out in ``jax.tree_util.tree_flatten``
order (``optimizers.base.jax_order``), as the JAX class lays out its own
(``_FlatModel``): ``utils.jax_params.load_jax_flat_params(port,
jax_module.params.detach().numpy())`` carries the weights across.  A leaf whose offset is not
a multiple of four floats would break the grid kernels' 16-byte alignment:
it is handed to the module as a copy (whose backward brings its gradient
back), never to a plain path.

Initial values are drawn from a CPU ``torch.Generator`` seeded with
``seed`` by the port's initialisers, with the JAX package's distributions
(grid tables U(−1e-4, 1e-4), the networks' Xavier uniform): the same seed
gives the same ``params`` on every device, another seed others.  JAX's
``jax.random.key(seed)`` bits are not reproduced.

Precision: fp32 throughout (``DEFAULT_POLICY``), as in the JAX bindings,
whose modules take no policy.  The original's fp16 ``loss_scale`` protocol
(modules.py:126-157) does not exist here; ``loss_scale = 1.0`` is kept for
its API.  ``Encoding``'s ``dtype`` selects the output's precision.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn
from torch.func import functional_call

from ..common import BATCH_SIZE_GRANULARITY, DEFAULT_POLICY, resolve_device
from ..config import create_encoding, create_network, create_network_with_input_encoding
from ..module import Module
from ..optimizers.base import jax_order

# The original pads every batch up to batch_size_granularity and slices the
# result (modules.py:181-192), as the JAX bindings do (their name for it).
BATCH_GRANULARITY = BATCH_SIZE_GRANULARITY


class _Leaf(NamedTuple):
    """One parameter of the port's module inside ``params``."""
    name: str            # the port's dotted name, the JAX tree's path
    shape: torch.Size
    copy: bool           # its offset is not 16-byte aligned: handed over as a copy


def _layout(native: Module) -> List[_Leaf]:
    """The leaves of ``native`` in JAX's flatten order, each with its
    alignment inside the flat vector."""
    named = dict(native.named_parameters())
    leaves, offset = [], 0
    for name in jax_order(named):
        leaves.append(_Leaf(name, named[name].shape, offset % 4 != 0))
        offset += named[name].numel()
    return leaves


class TorchModule(nn.Module):
    """A port module behind one flat parameter vector
    (≈ tinycudann.modules.Module)."""

    def __init__(self, seed: int = 1337, device=None):
        super().__init__()
        self.seed = seed
        self.dtype = torch.float32
        self.loss_scale = 1.0
        device = resolve_device(device)
        native = self._make_native(torch.Generator().manual_seed(seed), device)
        self.n_input_dims = native.n_input_dims
        self.n_output_dims = native.n_output_dims
        self._leaves = _layout(native)
        named = dict(native.named_parameters())
        flat = [named[leaf.name].detach().reshape(-1).float() for leaf in self._leaves]
        self.params = nn.Parameter(torch.cat(flat) if flat else torch.zeros(0, device=device))
        self._attach(native)

    def _make_native(self, generator: torch.Generator, device: torch.device) -> Module:
        raise NotImplementedError

    def _attach(self, native: Module) -> None:
        """Hold ``native`` outside the module tree, so that ``params`` is the
        one parameter (``parameters()``, ``state_dict()``), and let its
        parameters share ``params``' storage."""
        self.__dict__["native"] = native
        named = dict(native.named_parameters())
        for leaf, view in zip(self._leaves, self._split(self.params.data)):
            named[leaf.name].data = view

    def _split(self, flat: torch.Tensor) -> List[torch.Tensor]:
        sizes = [leaf.shape.numel() for leaf in self._leaves]
        return [v.view(leaf.shape) for leaf, v in zip(self._leaves, flat.split(sizes))]

    def _views(self) -> Dict[str, torch.Tensor]:
        """{name: the leaf as a view of ``params``} for ``functional_call``."""
        return {leaf.name: v.clone() if leaf.copy else v
                for leaf, v in zip(self._leaves, self._split(self.params))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.n_input_dims:
            raise ValueError(f"expected {self.n_input_dims} input dims, got {x.shape[-1]}")
        b = x.shape[0]
        pb = -(-b // BATCH_GRANULARITY) * BATCH_GRANULARITY
        xp = x if b == pb else nn.functional.pad(x, [0, 0, 0, pb - b])
        y = functional_call(self.native, self._views(), (xp.to(torch.float32),))
        return y[:b].to(self.dtype)

    def __getstate__(self) -> Dict[str, Any]:
        # As the original (modules.py:194-199): the native module stays out
        # of the pickle; params travel in the nn.Module state.
        state = self.__dict__.copy()
        del state["native"]
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._attach(self._make_native(torch.Generator().manual_seed(self.seed),
                                       self.params.device))

    def extra_repr(self) -> str:
        return (f"otype={self.native.hyperparams()['otype']}, "
                f"n_params={self.params.numel()}, seed={self.seed}, dtype={self.dtype}")


class NetworkWithInputEncoding(TorchModule):
    """An encoding followed by a network (≈ tinycudann.NetworkWithInputEncoding)."""

    def __init__(self, n_input_dims: int, n_output_dims: int, encoding_config: Dict[str, Any],
                 network_config: Dict[str, Any], seed: int = 1337, device=None):
        self._n_in, self._n_out = n_input_dims, n_output_dims
        self.encoding_config = encoding_config
        self.network_config = network_config
        super().__init__(seed=seed, device=device)

    def _make_native(self, generator, device):
        return create_network_with_input_encoding(
            self._n_in, self._n_out, self.encoding_config, self.network_config,
            policy=DEFAULT_POLICY, generator=generator, device=device)


class Network(TorchModule):
    """A network alone (≈ tinycudann.Network)."""

    def __init__(self, n_input_dims: int, n_output_dims: int, network_config: Dict[str, Any],
                 seed: int = 1337, device=None):
        self._n_in, self._n_out = n_input_dims, n_output_dims
        self.network_config = network_config
        super().__init__(seed=seed, device=device)

    def _make_native(self, generator, device):
        return create_network(self.network_config, self._n_in, self._n_out,
                              policy=DEFAULT_POLICY, generator=generator, device=device)


class Encoding(TorchModule):
    """An encoding alone (≈ tinycudann.Encoding).  ``dtype`` selects the
    output's precision (modules.py:311-326): None, the one that performs
    best, is fp32 here, as in the JAX bindings; or float32, float16."""

    def __init__(self, n_input_dims: int, encoding_config: Dict[str, Any],
                 seed: int = 1337, dtype: Optional[torch.dtype] = None, device=None):
        if dtype not in (None, torch.float32, torch.float16):
            raise ValueError(f"Encoding only supports fp32 or fp16 precision, but got {dtype}")
        self._n_in = n_input_dims
        self.encoding_config = encoding_config
        super().__init__(seed=seed, device=device)
        if dtype is not None:
            self.dtype = dtype

    def _make_native(self, generator, device):
        return create_encoding(self._n_in, self.encoding_config, policy=DEFAULT_POLICY,
                               generator=generator, device=device)


def free_temporary_memory() -> None:
    """≈ tinycudann.free_temporary_memory (modules.py:77-81): collects
    Python garbage, dropping the last references to freed tensors, then
    returns the caching allocator's unused blocks to the card."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()

"""Weight and optimizer-state carry from the JAX package.

``load_jax_params(model, params)`` copies a JAX ``state.params`` tree,
given as numpy arrays, into the port's parameters:

    {"encoding": {"grid": (N·F,)},
     "network": {"layers": [(32, 64), (64, 64), (64, 3)]}}

A parameter's dotted name is its path in the tree ("encoding.grid",
"network.layers.0"): the port keeps the JAX names and layouts, so the
copy is one to one.  ``load_jax_opt_state(trainer, opt_state)`` does the
same for the state of any optimizer, leaf by leaf in JAX's flatten order,
and ``load_jax_flat_params(module, flat)`` for the one flat vector of a
binding module (``bindings.torch_interop``).
Nothing here imports JAX: the trees hold numpy arrays
(``jax.tree_util.tree_map(np.asarray, state.params)``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(tree: Any, name: str):
    node = tree
    for part in name.split("."):
        if isinstance(node, dict):
            if part not in node:
                raise KeyError(f"JAX params have no entry '{name}'")
            node = node[part]
        elif isinstance(node, (list, tuple)):
            if not part.isdigit() or int(part) >= len(node):
                raise KeyError(f"JAX params have no entry '{name}'")
            node = node[int(part)]
        else:
            raise KeyError(f"JAX params have no entry '{name}'")
    return node


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_leaves(v) for v in tree)
    return 1


def load_jax_params(model, params: Any) -> None:
    """Copy ``params`` into ``model``: a TrainableModel (its network) or a
    module, such as one NetworkWithInputEncoding of a model of several.

    Raises ValueError on any shape mismatch and KeyError on a missing or
    an extra entry; nothing is copied unless every entry matches.
    """
    module = model if isinstance(model, torch.nn.Module) else model.network
    named = dict(module.named_parameters())
    pairs = []
    for name, p in named.items():
        value = np.asarray(_leaf(params, name))
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"'{name}': JAX shape {value.shape} != port "
                             f"shape {tuple(p.shape)}")
        pairs.append((p, value))
    n_leaves = _count_leaves(params)
    if n_leaves != len(named):
        raise KeyError(f"JAX params have {n_leaves} entries, the model "
                       f"{len(named)}: {sorted(named)}")
    with torch.no_grad():
        for p, value in pairs:
            p.copy_(torch.from_numpy(np.array(value, dtype=np.float32))
                    .to(p.dtype))


def load_jax_flat_params(module, flat: np.ndarray) -> None:
    """Copy the JAX bindings' flat parameter vector (``tcnn_tpu.bindings.
    torch_interop``'s ``params``, as numpy) into the ``params`` of one of
    the port's binding modules (``bindings.torch_interop``): both lay out
    the leaves in ``jax.tree_util`` flatten order.  Raises ValueError on a
    vector of another length; nothing is copied then."""
    value = np.asarray(flat, dtype=np.float32)
    n = module.params.numel()
    if value.shape != (n,):
        raise ValueError(f"flat params of shape {value.shape}, the module has ({n},)")
    with torch.no_grad():
        module.params.copy_(torch.from_numpy(value.copy()))


def _np_leaves(tree: Any) -> list:
    """The leaves of a numpy tree in ``jax.tree_util``'s flatten order:
    dict keys sorted, lists and tuples in order, None empty."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _np_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _np_leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def load_jax_opt_state(trainer, opt_state: Any) -> None:
    """Copy a JAX optimizer state, of any optimizer of the package
    (wrappers and Composite included), into ``trainer.opt_state``.

    ``opt_state`` is the JAX state as numpy (``jax.tree_util.tree_map(
    np.asarray, state.opt_state)``); its leaves are matched to the port's
    in JAX's flatten order (``optimizers.base.named_leaves``).  The uint32
    step counters become the port's int32 ones (they must be below 2^31).
    Raises KeyError on another number of leaves and ValueError on a shape
    mismatch; nothing is copied unless every leaf matches.
    """
    from ..optimizers.base import named_leaves
    from .serialization import copy_leaves

    dst = list(named_leaves(trainer.opt_state))
    src = _np_leaves(opt_state)
    if len(src) != len(dst):
        raise KeyError(f"the JAX state has {len(src)} leaves, the port's "
                       f"{len(dst)}: {[n for n, _ in dst]}")
    for (name, t), v in zip(dst, src):
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"'{name}': JAX shape {v.shape} != port shape "
                             f"{tuple(t.shape)}")
    copy_leaves(dst, src)

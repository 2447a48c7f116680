"""Weight carry from the JAX package.

``load_jax_params(model, params)`` copies a JAX ``state.params`` tree,
given as numpy arrays, into the port's parameters:

    {"encoding": {"grid": (N·F,)},
     "network": {"layers": [(32, 64), (64, 64), (64, 3)]}}

A parameter's dotted name is its path in the tree ("encoding.grid",
"network.layers.0"): the port keeps the JAX names and layouts, so the
copy is one to one.  Nothing here imports JAX: the tree holds numpy
arrays (``jax.tree_util.tree_map(np.asarray, state.params)``).
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
    """Copy ``params`` into ``model`` (a TrainableModel or a module).

    Raises ValueError on any shape mismatch and KeyError on a missing or
    an extra entry; nothing is copied unless every entry matches.
    """
    module = getattr(model, "network", model)
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

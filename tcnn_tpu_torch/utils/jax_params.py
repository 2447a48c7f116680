"""Weight and optimizer-state carry from the JAX package.

``load_jax_params(model, params)`` copies a JAX ``state.params`` tree,
given as numpy arrays, into the port's parameters:

    {"encoding": {"grid": (N·F,)},
     "network": {"layers": [(32, 64), (64, 64), (64, 3)]}}

A parameter's dotted name is its path in the tree ("encoding.grid",
"network.layers.0"): the port keeps the JAX names and layouts, so the
copy is one to one.  ``load_jax_opt_state(trainer, opt_state)`` does the
same for an Adam state (``mu``, ``nu``, ``param_steps``, ``step``).
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


def load_jax_opt_state(trainer, opt_state: Any) -> None:
    """Copy a JAX Adam state into ``trainer.opt_state``.

    ``opt_state`` is {"mu": tree, "nu": tree, "param_steps": tree,
    "step": scalar} with trees shaped like the parameters, as numpy.  The
    uint32 step counters become the port's int32 ones (they must be below
    2^31).  Raises like ``load_jax_params``; nothing is copied unless every
    entry matches.
    """
    state = trainer.opt_state
    pairs = []
    for key in ("mu", "nu", "param_steps"):
        for name, dst in state[key].items():
            value = np.asarray(_leaf(opt_state[key], name))
            if tuple(value.shape) != tuple(dst.shape):
                raise ValueError(f"'{key}.{name}': JAX shape {value.shape} != "
                                 f"port shape {tuple(dst.shape)}")
            if key == "param_steps" and value.size and value.max() >= 2 ** 31:
                raise ValueError(f"'{key}.{name}': step counts of 2^31 or more")
            pairs.append((dst, value))
        n_leaves = _count_leaves(opt_state[key])
        if n_leaves != len(state[key]):
            raise KeyError(f"JAX '{key}' has {n_leaves} entries, the port "
                           f"{len(state[key])}")
    pairs.append((state["step"], np.asarray(opt_state["step"])))
    with torch.no_grad():
        for dst, value in pairs:
            dst.copy_(torch.from_numpy(np.array(value).astype(
                np.float32 if dst.is_floating_point() else np.int64)).to(dst.dtype))

"""Trainer (de)serialization.

PyTorch counterpart of ``tcnn_tpu/utils/serialization.py:29-126`` (the
reference's Trainer::serialize, trainer.h:275-315): the same
JSON-compatible dict, so that a file written by either package loads in
the other.

    {"otype": "Trainer", "n_params": N, "params_type": "float",
     "params": {"treedef": str, "leaves": [{"__ndarray__": base64 .npy}]},
     "optimizer": {"treedef": str, "leaves": [...]},
     "step": s, "hyperparams": {"model", "loss", "optimizer"}}

The leaves are in ``jax.tree_util``'s flatten order of the JAX parameter
and optimizer-state trees (``optimizers.base.named_leaves``); integer
leaves (step counters) are written as uint32, JAX's type.  Like the JAX
reader, the port's reads only the leaves, checks their count and
shapes, and casts them to its own types; ``treedef`` here lists the
leaves' paths.
"""

from __future__ import annotations

import base64
import io
import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..optimizers.base import jax_order, named_leaves


def _encode_array(x) -> Dict[str, Any]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = x.numpy().astype(np.uint32) if not x.is_floating_point() else x.numpy()
    buf = io.BytesIO()
    np.save(buf, np.asarray(x), allow_pickle=False)
    return {"__ndarray__": base64.b64encode(buf.getvalue()).decode("ascii")}


def _decode_array(d: Dict[str, Any]) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(d["__ndarray__"])), allow_pickle=False)


def tree_to_json(named: Sequence[Tuple[str, torch.Tensor]]) -> Dict[str, Any]:
    """(path, tensor) leaves in JAX's order → {"treedef", "leaves"}."""
    return {"treedef": "leaves: " + ", ".join(p for p, _ in named),
            "leaves": [_encode_array(t) for _, t in named]}


def tree_from_json(data: Dict[str, Any], like: Sequence[Tuple[str, torch.Tensor]]
                   ) -> List[np.ndarray]:
    """The leaves of ``data`` as numpy arrays, checked against ``like``'s
    count and shapes."""
    leaves = [_decode_array(d) for d in data["leaves"]]
    if len(leaves) != len(like):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, model expects {len(like)}")
    for got, (path, want) in zip(leaves, like):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint leaf {path} shape {got.shape} != model "
                             f"{tuple(want.shape)}")
    return leaves


def copy_leaves(dst: Sequence[Tuple[str, torch.Tensor]], src: Sequence[np.ndarray]) -> None:
    """Copies numpy leaves into tensors in place, to each tensor's type;
    int32 counters take uint32 values below 2^31 only."""
    for (path, t), v in zip(dst, src):
        v = np.asarray(v)
        if not t.is_floating_point() and v.size and int(v.max()) >= 2 ** 31:
            raise ValueError(f"'{path}': step counts of 2^31 or more")
    with torch.no_grad():
        for (_, t), v in zip(dst, src):
            v = np.array(v, dtype=np.float32 if t.is_floating_point() else np.int64)
            t.copy_(torch.from_numpy(v).to(t.dtype))


def param_leaves(trainer) -> List[Tuple[str, torch.Tensor]]:
    params = trainer.params()
    return [(n, params[n]) for n in jax_order(params)]


def check_replicated(trainer, what: str = "trainer") -> None:
    """Refuses a trainer whose grid tables hold one rank's block-cyclic
    shard (``HybridParallel.shard_state``): its leaves are in the device
    layout, not the canonical one (``tcnn_tpu/utils/serialization.py:67-78``).
    Gather first: ``HybridParallel.gather_state(trainer)``."""
    info = getattr(trainer, "shard_info", None)
    if info is not None:
        raise ValueError(
            f"{what}: the grid tables hold rank {info['rank']}'s shard of "
            f"{info['n_model']} (block-cyclic); serialize the canonical layout via "
            f"HybridParallel.gather_state(trainer) first")


def serialize_trainer(trainer, serialize_optimizer: bool = True,
                      state: Dict[str, Any] = None) -> Dict[str, Any]:
    """≈ Trainer::serialize (trainer.h:275-288): the trainer's state, or
    ``state`` ({"params", "opt_state", "step"}, what
    ``HybridParallel.gather_state`` returns).  A sharded trainer's own state
    is refused (``check_replicated``)."""
    if state is None:
        check_replicated(trainer, "serialize_trainer")
        params, opt_state, step = trainer.params(), trainer.opt_state, trainer.step
    else:
        params, opt_state, step = state["params"], state["opt_state"], state["step"]
    data: Dict[str, Any] = {
        "otype": "Trainer",
        "n_params": sum(p.numel() for p in params.values()),
        "params_type": "float",
        "params": tree_to_json([(n, params[n]) for n in jax_order(params)]),
        "step": int(step),
        "hyperparams": {
            "model": trainer.model.hyperparams(),
            "loss": trainer.loss.hyperparams(),
            "optimizer": trainer.optimizer.hyperparams(),
        },
    }
    if serialize_optimizer:
        data["optimizer"] = tree_to_json(list(named_leaves(opt_state)))
    return data


def deserialize_trainer(trainer, data: Dict[str, Any]) -> None:
    """≈ Trainer::deserialize (trainer.h:290-315), into ``trainer`` in
    place; nothing is copied unless every leaf matches."""
    like = param_leaves(trainer)
    leaves = tree_from_json(data["params"], like)
    if "optimizer" in data:
        opt_like = list(named_leaves(trainer.opt_state))
        leaves += tree_from_json(data["optimizer"], opt_like)
        like += opt_like
    copy_leaves(like, leaves)
    trainer.step = int(data.get("step", 0))


def save(path: str, data: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(data, f)


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)

"""Optimizer protocol.

PyTorch counterpart of ``tcnn_tpu/optimizers/base.py`` (the reference's
optimizer.h:39-63).  The JAX package's optimizers are pure functions
over parameter pytrees; here, in PyTorch's idiom, they update in place:

    state = opt.init(params, layout)     # dicts keyed by parameter name
    opt.step(state, grads, params)       # updates params and state in place
    opt.custom_weights(state, params)    # inference weights, or None

``params`` and ``grads`` map a parameter's dotted name to its tensor;
``layout`` maps it to ``"matrix"`` or ``"other"`` (``Module.param_layout``):
the reference treats weight matrices and everything else (hash tables)
differently in L2 regularisation, learning rate and lazy stepping
(adam.h:76-118).

A state has the JAX state's keys.  Where JAX keeps a tree shaped like
the parameters, the port keeps a ``ParamTree``: a dict by dotted name.
``tree_leaves`` lists a state's tensors in the order ``jax.tree_util``
flattens the JAX state (dict keys sorted, parameters in the JAX tree's
order), which is what the trainer files of both packages hold
(``utils/serialization.py``) and what ``utils/jax_params`` copies.

Every branch of a step that depends on the step count is a select or an
indexed write on device tensors, and ``step`` reads nothing back, so a
training step can be captured in a CUDA graph and replayed; an optimizer
that cannot be says so through ``capturable``.  ``lr_scale`` is a float
or a 0-d tensor on the parameters' device (ExponentialDecay's factor).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]


class ParamTree(dict):
    """A state entry shaped like the parameters: {dotted name: value}.
    Its values flatten in the JAX parameter tree's leaf order."""


def jax_order(names) -> List[str]:
    """Dotted parameter names in the leaf order of the JAX parameter
    tree: dict keys sorted as strings, list and tuple entries (the
    numeric parts, "layers.10", "encoding.1") by index."""
    def key(name):
        return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split(".")]
    return sorted(names, key=key)


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of each leaf of a state, in JAX's flatten order."""
    if isinstance(tree, ParamTree):
        for name in jax_order(tree):
            yield from named_leaves(tree[name], f"{prefix}{name}.")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    return [t for _, t in named_leaves(tree)]


def weight_decay(relative, absolute, weight: torch.Tensor) -> torch.Tensor:
    """(1−rel)·w − copysign(abs, w) (common_device.h:870-873).  A float
    ``absolute`` is filled in on the weight's device, not copied from the
    host, so that a step can be captured in a CUDA graph."""
    if not torch.is_tensor(absolute):
        absolute = torch.full((), absolute, dtype=weight.dtype, device=weight.device)
    return (1.0 - relative) * weight - torch.copysign(absolute.to(weight.dtype), weight)


def state_device(params: Params, device=None) -> torch.device:
    """``device``, else the parameters' device (a Composite's nested
    optimizer may get no parameter, and then ``device``)."""
    return device if device is not None else next(iter(params.values())).device


def step_scalar(params: Params, device=None) -> torch.Tensor:
    """A 0-d int32 counter (JAX's uint32 ``step``) on the state's device."""
    return torch.zeros((), dtype=torch.int32, device=state_device(params, device))


def zeros_like_tree(params: Params) -> ParamTree:
    return ParamTree({n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()})


class Optimizer:
    #: False where a step cannot be captured in a CUDA graph
    #: (``Trainer.make_training_loop`` then raises ``capture_error``).
    capturable = True
    capture_error = ""

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        """The state for ``params`` (on ``device``, else theirs)."""
        raise NotImplementedError

    def step(self, state: State, grads: Params, params: Params,
             lr_scale=1.0) -> None:
        raise NotImplementedError

    def custom_weights(self, state: State, params: Params) -> Optional[Params]:
        """Weights to use for inference if different from the trained
        ones (≈ Optimizer::custom_weights, optimizer.h:52; Average, EMA)."""
        return None

    @property
    def learning_rate(self) -> float:
        return 0.0

    def n_nested(self) -> int:
        return 0

    def nested(self, idx: int) -> "Optimizer":
        raise IndexError

    def hyperparams(self) -> Dict[str, Any]:
        raise NotImplementedError

    #: json key -> attribute name; drives :meth:`update_hyperparams`.
    _HYPERPARAM_ATTRS: Dict[str, str] = {}

    def update_hyperparams(self, cfg: Dict[str, Any]) -> None:
        """Runtime hyperparameter update (≈ Object::update_hyperparams,
        object.h:56-61).  A captured training graph holds the old values:
        ``Trainer.update_hyperparams`` drops it."""
        for k, v in cfg.items():
            if k.lower() == "otype":
                continue
            attr = self._HYPERPARAM_ATTRS.get(k)
            if attr is None:
                raise NotImplementedError(
                    f"{type(self).__name__} does not support updating {k!r}")
            cur = getattr(self, attr)
            setattr(self, attr, type(cur)(v))

    @property
    def name(self) -> str:
        return str(self.hyperparams().get("otype", type(self).__name__))

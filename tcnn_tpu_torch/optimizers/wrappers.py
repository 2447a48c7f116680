"""Wrapper optimizers: EMA, Average, Batched, Lookahead, ExponentialDecay,
Composite.

PyTorch counterpart of ``tcnn_tpu/optimizers/wrappers.py:21-466`` (the
reference's optimizers/{ema,average,batched,lookahead,exponential_decay,
composite}.h).  Each wraps nested optimizers and transforms their
schedule, gradients or weights.

Where JAX branches on the step count (``lax.cond`` in Batched and
Lookahead, ``jnp.where`` in ExponentialDecay, Average's ring slot), the
count is a device tensor and the branch a select (``torch.where``) or an
indexed write, so that one captured CUDA graph is right at every step.
Batched runs its nested step every call and keeps the result only on the
steps JAX takes it: the nested state and the parameters are copied before
and selected after, which holds every nested optimizer's state (Adam's
lazy step counters too) at what it was on the other steps.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .base import (Optimizer, Params, ParamTree, State, jax_order, state_device,
                   step_scalar, tree_leaves, zeros_like_tree)


class _Nesting(Optimizer):
    def __init__(self, nested: Optimizer):
        self._nested = nested

    def n_nested(self) -> int:
        return 1

    def nested(self, idx: int) -> Optimizer:
        if idx != 0:
            raise IndexError
        return self._nested

    @property
    def capturable(self):
        return self._nested.capturable

    @property
    def capture_error(self):
        return self._nested.capture_error

    @property
    def learning_rate(self):
        return self._nested.learning_rate

    def custom_weights(self, state: State, params: Params) -> Optional[Params]:
        return self._nested.custom_weights(state["nested"], params)

    def _tracked(self, state: State, params: Params) -> Params:
        """The weights an averaging wrapper follows: the nested custom
        weights where there are any (ema.h:110-114)."""
        return self._nested.custom_weights(state["nested"], params) or params

    def update_hyperparams(self, cfg):
        # "nested" is forwarded, as in the reference's wrappers
        # (e.g. exponential_decay.h update_hyperparams).
        cfg = dict(cfg)
        nested_cfg = cfg.pop("nested", None)
        if nested_cfg:
            self._nested.update_hyperparams(nested_cfg)
        super().update_hyperparams(cfg)


class EMA(_Nesting):
    """EMA of the optimized weights, for inference only (ema.h:44-135).
    Stores the raw accumulator and debiases at read time, in fp32."""

    _HYPERPARAM_ATTRS = {"decay": "decay", "full_precision": "full_precision"}

    def __init__(self, nested: Optimizer, decay: float = 0.99,
                 full_precision: bool = False):
        super().__init__(nested)
        self.decay = float(decay)
        # The reference's flag keeps the EMA in fp32; it always is here.
        self.full_precision = bool(full_precision)
        self._scratch: Dict[str, torch.Tensor] = {}

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        self._scratch = {n: torch.empty_like(p, dtype=torch.float32)
                         for n, p in params.items()}
        return {"nested": self._nested.init(params, layout, device),
                "ema": zeros_like_tree(params), "step": step_scalar(params, device)}

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        self._nested.step(state["nested"], grads, params, lr_scale)
        for name, w in self._tracked(state, params).items():
            s = self._scratch[name]
            torch.mul(w, 1 - self.decay, out=s)
            state["ema"][name].mul_(self.decay).add_(s)
        state["step"].add_(1)

    def custom_weights(self, state: State, params: Params) -> Params:
        t = state["step"].float().clamp_min(1.0)
        debias = 1.0 / (1.0 - torch.pow(self.decay, t))
        return {n: (state["ema"][n] * debias).to(p.dtype) for n, p in params.items()}

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "EMA", "decay": self.decay,
                "full_precision": self.full_precision,
                "nested": self._nested.hyperparams()}


class Average(_Nesting):
    """Mean of the last ``n_samples`` weight snapshots for inference
    (average.h:44-110): a ring buffer and a running sum (sum += new −
    evicted).  The ring slot is the device step count modulo the ring."""

    _HYPERPARAM_ATTRS = {"n_samples": "n_samples"}

    def __init__(self, nested: Optimizer, n_samples: int = 128):
        super().__init__(nested)
        self.n_samples = int(n_samples)

    @staticmethod
    def _window(state: State) -> int:
        """The ring size of this state: an updated ``n_samples`` applies
        to states made after it (average.h:112-120)."""
        leaves = tree_leaves(state["buffer"])
        return leaves[0].shape[0] if leaves else 1

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        return {
            "nested": self._nested.init(params, layout, device),
            "buffer": ParamTree({n: torch.zeros((self.n_samples,) + tuple(p.shape),
                                                dtype=torch.float32, device=p.device)
                                 for n, p in params.items()}),
            "sum": zeros_like_tree(params),
            "step": step_scalar(params, device),
        }

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        self._nested.step(state["nested"], grads, params, lr_scale)
        slot = torch.remainder(state["step"], self._window(state)).long().view(1)
        for name, w in self._tracked(state, params).items():
            buf, s = state["buffer"][name], state["sum"][name]
            evicted = buf.index_select(0, slot)[0]
            w32 = w.float()
            s.add_(w32).sub_(evicted)
            buf.index_copy_(0, slot, w32.unsqueeze(0))
        state["step"].add_(1)

    def custom_weights(self, state: State, params: Params) -> Params:
        n = state["step"].clamp(1, self._window(state)).float()
        return {name: (state["sum"][name] / n).to(p.dtype) for name, p in params.items()}

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "Average", "n_samples": self.n_samples,
                "nested": self._nested.hyperparams()}


class Batched(_Nesting):
    """Gradient accumulation: the nested optimizer steps once every
    ``batch_size_multiplier`` calls, with the mean gradient
    (batched.h:44-90)."""

    _HYPERPARAM_ATTRS = {"batch_size_multiplier": "multiplier"}

    def __init__(self, nested: Optimizer, batch_size_multiplier: int = 16):
        super().__init__(nested)
        self.multiplier = int(batch_size_multiplier)
        self._saved: List[torch.Tensor] = []

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        state = {"nested": self._nested.init(params, layout, device),
                 "accum": zeros_like_tree(params), "count": step_scalar(params, device)}
        self._saved = [torch.empty_like(t) for t in self._kept(state, params)]
        return state

    @staticmethod
    def _kept(state: State, params: Params) -> List[torch.Tensor]:
        """What the nested step changes: its state and the parameters."""
        return tree_leaves(state["nested"]) + [params[n] for n in jax_order(params)]

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        accum = state["accum"]
        for name, g in grads.items():
            accum[name].add_(g)
        state["count"].add_(1)
        do_step = state["count"] >= self.multiplier
        kept = self._kept(state, params)
        for saved, t in zip(self._saved, kept):
            saved.copy_(t)
        mean = {n: a / self.multiplier for n, a in accum.items()}
        self._nested.step(state["nested"], mean, params, lr_scale)
        for saved, t in zip(self._saved, kept):
            torch.where(do_step, t, saved, out=t)
        for a in accum.values():
            a.masked_fill_(do_step, 0.0)
        state["count"].masked_fill_(do_step, 0)

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "Batched", "batch_size_multiplier": self.multiplier,
                "nested": self._nested.hyperparams()}


class Lookahead(_Nesting):
    """Lookahead (lookahead.h:43-100): every ``n_steps``, slow ← slow +
    α(fast − slow), and the fast weights take the slow ones."""

    _HYPERPARAM_ATTRS = {"alpha": "alpha", "n_steps": "n_steps"}

    def __init__(self, nested: Optimizer, alpha: float = 0.5, n_steps: int = 16):
        super().__init__(nested)
        self.alpha = float(alpha)
        self.n_steps = int(n_steps)
        self._scratch: Dict[str, torch.Tensor] = {}

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        self._scratch = {n: torch.empty_like(p, dtype=torch.float32)
                         for n, p in params.items()}
        return {"nested": self._nested.init(params, layout, device),
                "slow": ParamTree({n: p.detach().float().clone() for n, p in params.items()}),
                "step": step_scalar(params, device)}

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        self._nested.step(state["nested"], grads, params, lr_scale)
        state["step"].add_(1)
        sync = torch.remainder(state["step"], self.n_steps) == 0
        for name, fast in params.items():
            slow, s = state["slow"][name], self._scratch[name]
            torch.sub(fast, slow, out=s)
            s.mul_(self.alpha).add_(slow)          # slow + α(fast − slow)
            torch.where(sync, s, slow, out=slow)
            torch.where(sync, s.to(fast.dtype), fast, out=fast)

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "Lookahead", "alpha": self.alpha, "n_steps": self.n_steps,
                "nested": self._nested.hyperparams()}


class ExponentialDecay(_Nesting):
    """Piecewise-constant exponential learning-rate decay of the nested
    optimizer (exponential_decay.h:44-90): where decay_start ≤ step ≤
    decay_end and (step − decay_start) % decay_interval == 0, the factor
    is multiplied by decay_base; ``step`` counts the steps before this
    one.  The factor reaches the nested step as a device tensor."""

    _HYPERPARAM_ATTRS = {
        "decay_base": "decay_base", "decay_start": "decay_start",
        "decay_end": "decay_end", "decay_interval": "decay_interval",
    }  # exponential_decay.h:92-110

    def __init__(self, nested: Optimizer, decay_base: float = 0.1,
                 decay_start: int = 10000, decay_end: int = 10000000,
                 decay_interval: int = 10000):
        super().__init__(nested)
        self.decay_base = float(decay_base)
        self.decay_start = int(decay_start)
        self.decay_end = int(decay_end)
        self.decay_interval = int(decay_interval)

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        return {"nested": self._nested.init(params, layout, device),
                "factor": torch.ones((), dtype=torch.float32,
                                     device=state_device(params, device)),
                "step": step_scalar(params, device)}

    @torch.no_grad()
    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        step, factor = state["step"], state["factor"]
        hit = ((step >= self.decay_start) & (step <= self.decay_end)
               & (torch.remainder(step - self.decay_start, self.decay_interval) == 0))
        torch.where(hit, factor * self.decay_base, factor, out=factor)
        self._nested.step(state["nested"], grads, params, lr_scale * factor)
        step.add_(1)

    def hyperparams(self) -> Dict[str, Any]:
        return {
            "otype": "ExponentialDecay",
            "decay_base": self.decay_base,
            "decay_start": self.decay_start,
            "decay_end": self.decay_end,
            "decay_interval": self.decay_interval,
            "nested": self._nested.hyperparams(),
        }


class Composite(Optimizer):
    """Splits the parameters between nested optimizers
    (composite.h:44-130; ``tcnn_tpu/optimizers/wrappers.py:326-466``).

    Either by kind (``kinds_each``: "matrix" or "other" per nested
    optimizer), or by ``n_params_each``: each nested optimizer takes
    parameters, in the JAX parameter tree's leaf order, until its count
    is used up, and a boundary must fall between two parameters.
    """

    def __init__(self, nested: List[Optimizer],
                 n_params_each: Optional[List[int]] = None,
                 kinds_each: Optional[List[str]] = None,
                 learning_rate_factor: float = 1.0):
        self._nested_list = nested
        self.n_params_each = n_params_each
        self.kinds_each = kinds_each
        # A multiplier on every nested learning rate (composite.h:93-99).
        self.learning_rate_factor = float(learning_rate_factor)
        if (n_params_each is None) == (kinds_each is None):
            raise ValueError(
                "Composite: specify exactly one of n_params_to_optimize "
                "(per nested config) or params ('matrix'/'other')")
        self._assignment: Dict[str, int] = {}

    def n_nested(self):
        return len(self._nested_list)

    def nested(self, idx):
        return self._nested_list[idx]

    @property
    def capturable(self):
        return all(o.capturable for o in self._nested_list)

    @property
    def capture_error(self):
        return next((o.capture_error for o in self._nested_list if not o.capturable), "")

    def _assign(self, params: Params, layout: Dict[str, str]) -> Dict[str, int]:
        """Parameter name -> nested optimizer index."""
        assign = {}
        if self.kinds_each is not None:
            kind_to_opt = {k: i for i, k in enumerate(self.kinds_each)}
            for name in jax_order(params):
                if layout[name] not in kind_to_opt:
                    raise ValueError(f"Composite: no nested optimizer for '{layout[name]}'")
                assign[name] = kind_to_opt[layout[name]]
            return assign
        counts = list(self.n_params_each)
        opt_idx = 0
        for name in jax_order(params):
            size = params[name].numel()
            while opt_idx < len(counts) and counts[opt_idx] == 0:
                opt_idx += 1
            if opt_idx >= len(counts):
                raise ValueError("Composite: more params than covered by "
                                 "n_params_to_optimize")
            if counts[opt_idx] < size:
                raise ValueError(
                    "Composite: n_params_to_optimize boundary does not "
                    f"align with a parameter-leaf boundary (leaf size "
                    f"{size}, remaining {counts[opt_idx]})")
            counts[opt_idx] -= size
            assign[name] = opt_idx
        return assign

    def _split(self, tree: Dict[str, Any]) -> List[Dict[str, Any]]:
        groups: List[Dict[str, Any]] = [{} for _ in self._nested_list]
        for name, i in self._assignment.items():
            groups[i][name] = tree[name]
        return groups

    def init(self, params: Params, layout: Dict[str, str], device=None) -> State:
        self._assignment = self._assign(params, layout)
        device = state_device(params, device)
        return {"nested": tuple(opt.init(pg, lg, device) for opt, pg, lg in zip(
            self._nested_list, self._split(params), self._split(layout)))}

    def step(self, state: State, grads: Params, params: Params, lr_scale=1.0) -> None:
        for opt, st, pg, gg in zip(self._nested_list, state["nested"],
                                   self._split(params), self._split(grads)):
            opt.step(st, gg, pg, lr_scale * self.learning_rate_factor)

    def custom_weights(self, state: State, params: Params) -> Optional[Params]:
        out, any_custom = {}, False
        for opt, st, pg in zip(self._nested_list, state["nested"], self._split(params)):
            cw = opt.custom_weights(st, pg)
            any_custom |= cw is not None
            out.update(cw if cw is not None else pg)
        return out if any_custom else None

    @property
    def learning_rate(self):
        # The composite's "learning rate" is the factor (composite.h:92-94).
        return self.learning_rate_factor

    def update_hyperparams(self, cfg):
        # composite.h:156-163: a "nested" array goes entry by entry to the
        # nested optimizers.
        cfg = dict(cfg)
        nested_cfg = cfg.pop("nested", None)
        if nested_cfg:
            if not isinstance(nested_cfg, (list, tuple)):
                raise ValueError(
                    "Composite.update_hyperparams: 'nested' must be an "
                    "array with one entry per nested optimizer")
            for opt, sub in zip(self._nested_list, nested_cfg):
                opt.update_hyperparams(sub)
        if "learning_rate_factor" in cfg:
            self.learning_rate_factor = float(cfg.pop("learning_rate_factor"))
        super().update_hyperparams(cfg)

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "Composite",
                "learning_rate_factor": self.learning_rate_factor,
                "nested": [o.hyperparams() for o in self._nested_list]}

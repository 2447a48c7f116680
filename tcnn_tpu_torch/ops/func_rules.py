"""What the port's autograd functions share for ``torch.func``.

``GridEncodeFunction``, ``GridEncodeBackwardFunction``, ``GridBwdBwdFunction``
(``ops/grid_ops.py``), ``FusedMLPFunction`` and ``FusedMLPBackwardFunction``
(``ops/cuda/fused_mlp.py``) call the kernels on raw pointers, so
``torch.func.vmap`` cannot trace through them: each has a ``vmap`` rule.
The grid and the MLP are per-sample functions, so a vmapped dim on the
per-sample inputs (x, and the output gradients dcols, g, ddx) folds into
the batch and the same kernel runs once over V·B samples
(``fold``/``unfold``).  Where the vmapped dim is on the table or the
weights, or where an output sums over the samples (a table or weight
gradient), folding would mix the V entries, so the rule runs one call per
entry (``loop``).  ``torch.func.jacrev`` vmaps the VJP, so the backward
functions' rules are the ones it meets.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def loop(fn, info, in_dims: Sequence[Optional[int]], args: Sequence):
    """vmap of ``fn.apply`` by one call per batch entry, outputs stacked on dim 0."""
    outs = [fn.apply(*[a.select(d, v) if isinstance(a, torch.Tensor) and d is not None
                       else a for a, d in zip(args, in_dims)])
            for v in range(info.batch_size)]
    if not isinstance(outs[0], tuple):
        return torch.stack(outs), 0
    stacked = tuple(None if o is None else torch.stack([out[i] for out in outs])
                    for i, o in enumerate(outs[0]))
    return stacked, tuple(None if s is None else 0 for s in stacked)


def fold(t: Optional[torch.Tensor], d: Optional[int], size: int, axis: int) -> Optional[torch.Tensor]:
    """A per-sample tensor with its batch on ``axis`` (of the unbatched
    shape) and the vmapped dim at ``d`` (None: not vmapped, repeated) as
    the same tensor over size·B samples, entry v's sample b at v·B + b."""
    if t is None:
        return None
    if d is None:
        t = t.unsqueeze(axis).expand(*t.shape[:axis], size, *t.shape[axis:])
    else:
        t = t.movedim(d, axis)
    return t.reshape(*t.shape[:axis], -1, *t.shape[axis + 2:])


def unfold(t: Optional[torch.Tensor], size: int, axis: int) -> Optional[torch.Tensor]:
    """``fold``'s inverse on an output: (.., size·B, ..) on ``axis`` into
    (.., size, B, ..), the vmapped dim at ``axis``."""
    if t is None:
        return None
    return t.reshape(*t.shape[:axis], size, -1, *t.shape[axis + 1:])

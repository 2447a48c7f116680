"""Sort and segment-sum scatter-add: the deterministic table gradient.

PyTorch counterpart of ``tcnn_tpu/ops/sort_scatter.py``.  There it is the
JAX package's design candidate (b) for the grid's table gradient, selected
with ``TCNN_TPU_SCATTER=sortseg`` and taken on every GPU backend
(``tcnn_tpu/ops/grid_ops.py:962-977``, ``:459-468``): the updates sorted
by table row, each row's run summed, one scatter of at most ``n_rows``
totals.  A fixed sort order fixes the fp32 sum order, so the gradient has
the same bits in every run, which the port's kernel GB, summing with
atomics, does not give.

``sort_segment_scatter`` keeps the JAX function's signature.  On CPU
tensors it is the plain version, JAX's arithmetic: a stable sort of the
keys, a cumulative sum of the sorted values, differences at the run ends,
one ``index_add_`` (``ops/cuda/sort_scatter.py::segment_sum_plain``).  On
CUDA tensors it is ``torch.sort(idx, stable=True)`` (the counterpart of
``jnp.argsort``, an XLA op outside any kernel) and kernel SS, which sums
each run in an order fixed by the sorted positions, without atomics;
there is no fallback.

``grid_table_gradient`` is the route of the grid's first-order table
gradient under ``TCNN_TPU_SCATTER=sortseg``: kernel SK forms the updates
as keys and values in JAX's order, then ``sort_segment_scatter``.
``ops/grid_ops.py`` reads the variable where JAX reads it, at each
backward; a training loop captured in a CUDA graph keeps the route it was
captured with.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from . import grid_ops
from .cuda.sort_scatter import n_table_rows, segment_sum, segment_sum_plain, sort_keys

SCATTER_ENV = "TCNN_TPU_SCATTER"


def sortseg_selected() -> bool:
    """Whether ``TCNN_TPU_SCATTER=sortseg`` selects the route (read at each
    call, as the JAX package reads it in each backward)."""
    return os.environ.get(SCATTER_ENV) == "sortseg"


def sort_segment_scatter(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Scatter-add ``vals`` (M, F) into rows ``idx`` (M,) of a zero
    (n_rows, F) table, deterministically, by a stable sort and segment
    sums, in fp32, cast once to ``out_dtype``.  Rows outside [0, n_rows)
    are dropped."""
    if vals.device.type == "cuda" and idx.dtype != torch.int32:   # kernel SS's keys
        idx = idx.clamp(-1, n_rows).to(torch.int32)
    order = torch.sort(idx, stable=True)
    if vals.device.type == "cpu":
        return segment_sum_plain(order.values, order.indices, vals, n_rows, out_dtype)
    return segment_sum(order.values, order.indices, vals, n_rows, out_dtype)


def grid_table_gradient(spec: grid_ops.GridSpec, flat: torch.Tensor, x: torch.Tensor,
                        dcols: torch.Tensor, live: Sequence[int],
                        level_frac: Optional[torch.Tensor] = None,
                        shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The grid's first-order table gradient by the ``sortseg`` route: the
    (n_entries·F,) gradient (the shard's rows with ``shard``) in ``flat``'s
    dtype, the same function as kernel GB's (``grid_encode_bwd``, whose
    arguments it takes) with its fp32 sums in a fixed order.  Kernel SK on
    the card, ``sort_keys_plain`` on the CPU, then ``sort_segment_scatter``
    (``tcnn_tpu/ops/grid_ops.py:972-977``)."""
    keys, vals = sort_keys(spec, x, dcols, live, level_frac, shard)
    return sort_segment_scatter(keys, vals, n_table_rows(spec, shard), flat.dtype).reshape(-1)

"""Wrappers of kernels SK and SS (``csrc/sort_scatter.cu``): the grid's
first-order table gradient by sort and segment sum.

Neither replaces a TPU kernel.  The JAX package forms this route in XLA
ops (``tcnn_tpu/ops/sort_scatter.py``; the ``TCNN_TPU_SCATTER=sortseg``
branch of ``tcnn_tpu/ops/grid_ops.py:962-977``): its updates are
``ws3 · dc3`` in (live level, corner, sample) order, sorted by row with
``jnp.argsort`` and summed per row.  ``ops/sort_scatter.py`` strings the
two kernels together around ``torch.sort``.

  * SK (``sort_keys``): the updates as (M,) int32 row keys and (M, F) fp32
    values w·dy, M = L_live·C·B, JAX's order.  An update that adds nothing
    (a (sample, level) the per-sample mask drops, or in shard mode a corner
    another rank's shard holds) gets the key ``n_rows``, past the last row,
    and the value 0·dy.
  * SS (``segment_sum``): given the stably sorted keys and the sort's
    permutation, each row's run of values summed in fp32 in an order fixed
    by the sorted positions (a segmented sum over tiles of 2048 positions,
    then the tiles a run covers in order), each touched row written once,
    rounded once to the table's dtype; keys outside [0, n_rows) are
    skipped.  No atomics: the same inputs give the same bits.

A CUDA tensor launches the kernel; a CPU tensor takes ``sort_keys_plain``
or ``segment_sum_plain``, the same functions in plain PyTorch, which the
CPU tests and ``chip_smoke.py`` hold the kernels against.  SK's plain
version is ``build_indices_weights(scatter=True)`` and the products, so SK
equals it bit for bit.  SS's plain version is JAX's arithmetic (a
cumulative sum over the sorted values, differences at the run ends, one
``index_add_`` of the totals), so the two agree within the cumulative
sum's rounding: per row, 2^-23·(P + n·A), P the largest |prefix sum| of
the row's column, n the row's run length and A the sum of its values'
magnitudes (each prefix rounded once to fp32 costs at most half an ulp of
P, the difference of two of them P; SS's own sum of n values, in any
order, at most (n − 1)/2 ulps of A).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import grid_ops
from . import kernels, require_cuda_tensors
from .grid_encode import (_INTERP_CODE, _check_dcols, _check_frac, _check_shard, _consts,
                          _hash_args, _x_row_stride)

# Kernel SS's tile: the sorted positions one CTA sums (csrc/sort_scatter.cu,
# kSsTile = kSsThreads x kSsItems); runs that cross tiles go through its
# second pass.
SS_TILE = 256 * 8


def n_table_rows(spec: grid_ops.GridSpec, shard: Optional[Tuple[int, int]] = None) -> int:
    """The rows of the table (or of the shard) that the route sums into;
    also SK's key of an update that adds nothing."""
    return spec.n_entries // (shard[1] if shard else 1)


def sort_keys_plain(spec: grid_ops.GridSpec, x: torch.Tensor, dcols: torch.Tensor,
                    live: Sequence[int], level_frac: Optional[torch.Tensor] = None,
                    shard: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel SK: ``(keys, vals)``, (M,) int32 and (M, F)
    float32, M = len(live)·2^D·B in (live level, corner, sample) order, as
    the JAX package forms them (``idx3.reshape(-1)`` and the ``vals``
    transpose, ``tcnn_tpu/ops/grid_ops.py:974-977``): the corner's row and
    its scatter weight times the output gradient,
    ``build_indices_weights(scatter=True)`` (stochastic interpolation's
    one-hot corner where the spec asks for it).  A masked (sample, level)
    and another shard's corner get the key ``n_table_rows`` (their weight
    is 0)."""
    F, C, B = spec.n_features_per_level, 1 << spec.n_dims, x.shape[0]
    L = len(live)
    if not L or not B:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros((0, F), dtype=torch.float32, device=x.device))
    idx, ws = grid_ops.build_indices_weights(spec, x, live, level_frac=level_frac,
                                             scatter=True, shard=shard)
    rows = torch.tensor([l * F + f for l in live for f in range(F)], device=x.device)
    dy = dcols.index_select(0, rows).float().reshape(L, F, B)
    vals = ws.reshape(L, C, B, 1) * dy.permute(0, 2, 1).reshape(L, 1, B, F)
    keys = idx.reshape(L, C, B)
    off = keys < 0   # another shard's corner
    if level_frac is not None:
        off = off | (grid_ops.level_mask(spec, live, level_frac)[:, None, :] == 0)
    keys = torch.where(off, n_table_rows(spec, shard), keys)
    return keys.reshape(-1).to(torch.int32), vals.reshape(L * C * B, F)


def sort_keys(spec: grid_ops.GridSpec, x: torch.Tensor, dcols: torch.Tensor,
              live: Sequence[int], level_frac: Optional[torch.Tensor] = None,
              shard: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel SK: see ``sort_keys_plain``.  ``x`` (B, D) float32 with unit
    stride across D, any row stride; ``dcols`` the (L·F, B) output gradient,
    float32 or bfloat16, any strides; ``level_frac`` and ``shard`` as for
    ``grid_encode_bwd``.  M must fit int32."""
    if x.device.type == "cpu":
        return sort_keys_plain(spec, x, dcols, live, level_frac, shard)
    if x.device.type != "cuda":
        raise ValueError(f"sort_keys: unsupported device {x.device}")
    name = "sort_keys"
    D, F, B = spec.n_dims, spec.n_features_per_level, x.shape[0]
    if not 1 <= D <= grid_ops.MAX_DIMS:
        raise ValueError(f"{name}: the kernel covers 1 <= D <= {grid_ops.MAX_DIMS}, got {D}")
    if x.dtype != torch.float32 or x.shape != (B, D) or (D > 1 and x.stride(1) != 1):
        raise ValueError(f"{name}: x must be float32 (B, {D}) with unit stride across its "
                         f"coordinates, got {x.dtype} {tuple(x.shape)} strides {x.stride()}")
    _check_shard(name, spec, shard)
    _check_dcols(name, spec, x, dcols)
    _check_frac(name, x, level_frac)
    n_rows = n_table_rows(spec, shard)
    m = len(set(live)) * (1 << D) * B
    if m >= 2 ** 31 or n_rows >= 2 ** 31:
        raise ValueError(f"{name}: {m} updates on {n_rows} rows exceed the int32 keys")
    keys = torch.empty(m, dtype=torch.int32, device=x.device)
    vals = torch.empty((m, F), dtype=torch.float32, device=x.device)
    if m == 0:
        return keys, vals
    factors, hash_kind = _hash_args(spec)
    u = (grid_ops.stochastic_uniforms(spec.n_levels, B, x.device)
         if spec.stochastic_interpolation else None)
    kernels().sort_keys(x, _x_row_stride(x), level_frac, dcols, dcols.stride(1),
                        dcols.stride(0), _consts(spec, live, x.device, shard), D, F, factors,
                        hash_kind, _INTERP_CODE[spec.interpolation], shard is not None, u,
                        n_rows, keys, vals)
    sort_keys.launches += 1
    return keys, vals


sort_keys.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (kernel SS loads 16-byte
    vectors), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def segment_sum_plain(sorted_keys: torch.Tensor, order: torch.Tensor, vals: torch.Tensor,
                      n_rows: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of kernel SS: JAX's segment sums
    (``tcnn_tpu/ops/sort_scatter.py:34-49``).  The sorted values
    ``vals[order]``, their cumulative sum per column in fp32 (each prefix
    rounded once from a float64 sum, as PyTorch's CPU ``cumsum`` of fp32
    accumulates; on CUDA a 1-D scan per column), differences at the ends
    of the runs of equal keys, and one ``index_add_`` of the totals into an
    (n_rows, F) fp32 zero table, keys outside [0, n_rows) dropped (jnp's
    ``.at[].add`` drops rows past the table).  ``jnp.nonzero(...,
    size=n_rows)``'s padding is not needed: ``torch.nonzero`` returns every
    run end.  Cast once to ``out_dtype``."""
    F = vals.shape[1]
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=vals.device)
    m = sorted_keys.shape[0]
    if m:
        sv = vals.float()[order]
        cs = torch.stack([sv[:, k].contiguous().cumsum(0, dtype=torch.float64)
                          for k in range(F)], 1).float()
        is_last = torch.ones(m, dtype=torch.bool, device=vals.device)
        is_last[:-1] = sorted_keys[1:] != sorted_keys[:-1]
        end_pos = torch.nonzero(is_last)[:, 0]
        ends = cs[end_pos]
        totals = torch.cat([ends[:1], ends[1:] - ends[:-1]])
        rows = sorted_keys[end_pos].long()
        keep = (rows >= 0) & (rows < n_rows)
        out.index_add_(0, rows[keep], totals[keep])
    return out.to(out_dtype)


def segment_sum(sorted_keys: torch.Tensor, order: torch.Tensor, vals: torch.Tensor,
                n_rows: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel SS: the (n_rows, F) table, row r the fp32 sum of the values of
    the run of key r, in an order fixed by the sorted positions, rounded
    once to ``out_dtype`` (float32 or bfloat16); a row no key names is 0.
    ``sorted_keys`` (M,) int32, sorted (``torch.sort``); ``order`` (M,)
    int64, the sort's indices, sorted position i holding update
    ``order[i]``; ``vals`` (M, F) float32 in update order."""
    if vals.device.type == "cpu":
        return segment_sum_plain(sorted_keys, order, vals, n_rows, out_dtype)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {vals.device}")
    name = "segment_sum"
    m = sorted_keys.shape[0]
    if sorted_keys.dtype != torch.int32 or order.dtype != torch.int64 or \
            vals.dtype != torch.float32 or vals.ndim != 2 or sorted_keys.shape != (m,) or \
            order.shape != (m,) or vals.shape[0] != m:
        raise ValueError(f"{name}: needs (M,) int32 keys, (M,) int64 order and (M, F) float32 "
                         f"values, got {sorted_keys.dtype} {tuple(sorted_keys.shape)}, "
                         f"{order.dtype} {tuple(order.shape)}, {vals.dtype} {tuple(vals.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16) or not 1 <= n_rows < 2 ** 31:
        raise ValueError(f"{name}: output {out_dtype} of {n_rows} rows not supported")
    sorted_keys, order, vals = (_aligned(t) for t in (sorted_keys, order, vals))
    require_cuda_tensors(name, sorted_keys, order, vals)
    out = torch.empty((n_rows, vals.shape[1]), dtype=out_dtype, device=vals.device)
    kernels().segment_sum(sorted_keys, order, vals, n_rows, out)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0

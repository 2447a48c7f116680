"""Wrapper of kernel RS, the row scatter-add (``csrc/row_scatter.cu``).

PyTorch counterpart of the row-scatter half of
``tcnn_tpu/ops/pallas/scatter.py``: RS replaces ``::_scatter_kernel``
(``scatter_add_rows``, ``scatter_add_rows_flat``) and
``::_scatter_cols_kernel`` (``scatter_add_cols``), which all compute
``zeros((n_rows, F)).at[idx].add(g)``.  Those names are kept here.  The
grid's second order (``ops/grid_ops.py``) calls ``row_scatter_add``
directly, with the table's dtype as ``out_dtype``.

A CUDA tensor launches the kernel; a CPU tensor takes
``row_scatter_add_plain`` (``index_add_`` in fp32), which the CPU tests and
``chip_smoke.py`` hold the kernel against.  The kernel's fp32 atomics sum
each row in a varying order, so the two agree to the fp32 sum-order bound,
not bit for bit; the JAX kernels are deterministic.  Indices outside
[0, n_rows) are dropped, as jnp's ``.at[].add`` drops those beyond the
table.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from . import kernels, require_cuda_tensors


def row_scatter_add_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of kernel RS: the flat (n_rows·F,) sum of g's rows at
    idx, in fp32 (``index_add_``), cast once to ``out_dtype``."""
    F = g.shape[1]
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=g.device)
    keep = (idx >= 0) & (idx < n_rows)
    out.index_add_(0, idx[keep].long(), g[keep].float())
    return out.reshape(-1).to(out_dtype)


def row_scatter_add(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flat (n_rows·F,) ``out_dtype`` table: out[idx[i]·F + k] += g[i, k].

    ``idx`` (M,) integer rows; ``g`` (M, F) float32, any strides (an
    (F, M) tensor's transpose is read in place); ``out_dtype`` float32 or
    bfloat16 (the fp32 sum cast once).
    """
    if g.device.type == "cpu":
        return row_scatter_add_plain(idx, g, n_rows, out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"row_scatter_add: unsupported device {g.device}")
    name = "row_scatter_add"
    if g.ndim != 2 or idx.shape != (g.shape[0],) or g.dtype != torch.float32:
        raise ValueError(f"{name}: needs (M,) indices and (M, F) float32 rows, got "
                         f"{tuple(idx.shape)} and {g.dtype} {tuple(g.shape)}")
    if idx.dtype not in (torch.int32, torch.int64) or out_dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: indices {idx.dtype}, output {out_dtype} not supported")
    if n_rows >= 2 ** 31:
        raise ValueError(f"{name}: {n_rows} rows exceed int32 indices")
    idx = idx.to(torch.int32).contiguous()   # int32, as the JAX kernel takes it
    require_cuda_tensors(name, idx, g)
    F = g.shape[1]
    acc = torch.empty(n_rows * F, dtype=torch.float32, device=g.device)
    out = acc if out_dtype == torch.float32 else torch.empty(
        n_rows * F, dtype=out_dtype, device=g.device)
    kernels().row_scatter(idx, g, g.stride(0), g.stride(1), F, acc, out, n_rows)
    row_scatter_add.launches += 1
    return out


row_scatter_add.launches = 0


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``zeros((n_rows, F)).at[idx].add(g)``, (n_rows, F) float32
    (``tcnn_tpu/ops/pallas/scatter.py:290``)."""
    return row_scatter_add(idx, g.float(), n_rows).reshape(n_rows, g.shape[1])


def scatter_add_rows_flat(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                          f: int) -> torch.Tensor:
    """Like ``scatter_add_rows`` but the FLAT (n_rows·f,) table
    (``scatter.py:358``)."""
    if g.shape[1] != f:
        raise ValueError(f"scatter_add_rows_flat: g has {g.shape[1]} features, not {f}")
    return row_scatter_add(idx, g.float(), n_rows)


def scatter_add_cols(idx: torch.Tensor,
                     gs: Union[Sequence[torch.Tensor], torch.Tensor],
                     n_rows: int) -> torch.Tensor:
    """Scatter-add with per-feature gradient streams (``scatter.py:227``):
    ``gs`` holds F (M,) streams, as a sequence or as the rows of an (F, M)
    tensor; returns the FLAT (n_rows·F,) float32 table.  The streams are
    read in place through strides (1, M)."""
    g = gs if isinstance(gs, torch.Tensor) else torch.stack(list(gs))
    return row_scatter_add(idx, g.float().t(), n_rows)

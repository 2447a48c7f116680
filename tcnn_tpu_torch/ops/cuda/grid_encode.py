"""Wrappers of kernels G and GB: grid-encode forward
(``csrc/grid_encode.cu``) and backward (``csrc/grid_encode_bwd.cu``).

G replaces ``tcnn_tpu/ops/pallas/grid_matmul.py::_gather_kernel`` and
``::_gather_kernel_xor`` (and the index build in front of them); GB
replaces ``::_scatter_kernel`` and ``::_scatter_kernel_xor``, the table
gradient.  A CUDA tensor launches the kernel; a CPU tensor takes
``grid_encode_plain`` / ``grid_encode_bwd_plain``, the same functions in
plain PyTorch, which the CPU tests and ``chip_smoke.py`` hold the
kernels against.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ...common import HashType, InterpolationType
from .. import grid_ops
from . import kernels, require_cuda_tensors

_INTERP_CODE = {InterpolationType.NEAREST: 0, InterpolationType.LINEAR: 1,
                InterpolationType.SMOOTHSTEP: 2}


def grid_encode_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                      x: torch.Tensor, live: Sequence[int],
                      soa: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (grid_ops.py:1198-1297 of the
    JAX package): corner indices and weights, weighted gather, zero rows
    for dead levels, cast to the table's dtype."""
    F = spec.n_features_per_level
    B = x.shape[0]
    cols = torch.zeros((spec.n_levels * F, B), dtype=torch.float32,
                       device=x.device)
    if live:
        idx, ws = grid_ops.build_indices_weights(spec, x, live)
        live_cols = grid_ops.interpolate_ref(flat, idx, ws, F)
        rows = torch.tensor([l * F + f for l in live for f in range(F)],
                            device=x.device)
        cols = cols.index_copy(0, rows, live_cols)
    out = cols.to(flat.dtype)
    return out if soa else out.t()


def _hash_args(spec: grid_ops.GridSpec):
    if spec.hash_type == HashType.RNG:
        raise NotImplementedError(
            "the Rng (pcg32) grid hash is ported with the grid options of "
            "slice 3")
    coherent_add = spec.hash_type == HashType.COHERENT_ADD
    factors = grid_ops.hash_factors(
        HashType.COHERENT_PRIME if coherent_add else spec.hash_type,
        spec.n_dims)
    return list(factors) + [0] * (4 - len(factors)), coherent_add


_level_consts: Dict[Tuple, torch.Tensor] = {}


def _consts(spec: grid_ops.GridSpec, live: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """The kernel's (L, LEVEL_FIELDS) int32 level constants on ``device``,
    cached so that a request copies nothing to the card."""
    key = (spec, tuple(live), device)
    if key not in _level_consts:
        _level_consts[key] = torch.from_numpy(
            grid_ops.level_params(spec, live)).to(device)
    return _level_consts[key]


def _check_args(name: str, spec: grid_ops.GridSpec, flat: torch.Tensor,
                x: torch.Tensor) -> None:
    """What the kernels G and GB take; raises on anything else."""
    if spec.stochastic_interpolation:
        raise NotImplementedError(
            "stochastic interpolation is ported with the grid options of "
            "slice 3")
    D, F = spec.n_dims, spec.n_features_per_level
    if not 1 <= D <= 4 or not 1 <= F <= 8:
        raise ValueError(f"{name}: the kernel covers D <= 4 and F <= 8, "
                         f"got D={D}, F={F}")
    if x.dtype != torch.float32 or x.shape != (x.shape[0], D) or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous float32 (B, {D}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if flat.dtype not in (torch.float32, torch.bfloat16) or flat.ndim != 1 \
            or not flat.is_contiguous() or flat.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be a contiguous, 16-byte "
                         "aligned flat float32 or bfloat16 tensor")
    grid_ops.check_table_size(spec, flat)
    require_cuda_tensors(name, x, flat)


def grid_encode_fwd(spec: grid_ops.GridSpec, flat: torch.Tensor,
                    x: torch.Tensor, live: Sequence[int],
                    soa: bool = False) -> torch.Tensor:
    """(B, L·F) features, or (L·F, B) with ``soa``, in ``flat``'s dtype.

    ``flat`` is the (n_entries·F,) table, float32 or bfloat16; ``x`` is
    (B, D) float32.
    """
    if x.device.type == "cpu":
        return grid_encode_plain(spec, flat, x, live, soa)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_fwd: unsupported device {x.device}")
    name = "grid_encode_fwd"
    _check_args(name, spec, flat, x)
    level_consts = _consts(spec, live, x.device)
    factors, coherent_add = _hash_args(spec)
    F, L = spec.n_features_per_level, spec.n_levels

    B = x.shape[0]
    out = torch.empty((L * F, B) if soa else (B, L * F), dtype=flat.dtype,
                      device=x.device)
    if B == 0:
        return out
    stride_b, stride_f = (1, B) if soa else (L * F, 1)
    kernels().grid_encode_fwd(x, flat, level_consts, out, spec.n_dims, F, stride_b,
                              stride_f, factors, coherent_add,
                              _INTERP_CODE[spec.interpolation])
    grid_encode_fwd.launches += 1
    return out


grid_encode_fwd.launches = 0


def grid_encode_bwd_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                          x: torch.Tensor, dcols: torch.Tensor,
                          live: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of kernel GB: the table gradient
    dflat[idx_c(b, l)·F + f] += w_c(b, l) · dcols[l·F+f, b] over every
    sample, live level and corner, each product and the sum in fp32
    (``index_add_``), cast once to ``flat``'s dtype
    (grid_ops.py:1099-1102 of the JAX package).  ``dcols`` is the
    (L·F, B) SoA output gradient; dead levels get zero gradient."""
    F = spec.n_features_per_level
    B = x.shape[0]
    dflat = torch.zeros((spec.n_entries, F), dtype=torch.float32,
                        device=x.device)
    if live and B:
        idx, ws = grid_ops.build_indices_weights(spec, x, live)
        L = len(live)
        C = ws.shape[0] // L
        rows = torch.tensor([l * F + f for l in live for f in range(F)],
                            device=x.device)
        dy = dcols.index_select(0, rows).float().reshape(L, F, B)
        vals = ws.reshape(L, C, B, 1) * dy.permute(0, 2, 1).reshape(L, 1, B, F)
        dflat.index_add_(0, idx.reshape(-1), vals.reshape(-1, F))
    return dflat.reshape(-1).to(flat.dtype)


def grid_encode_bwd(spec: grid_ops.GridSpec, flat: torch.Tensor,
                    x: torch.Tensor, dcols: torch.Tensor,
                    live: Sequence[int]) -> torch.Tensor:
    """(n_entries·F,) table gradient in ``flat``'s dtype.

    ``dcols`` is the output gradient in the SoA layout (L·F, B), float32 or
    bfloat16, any strides (the transpose of an AoS gradient is taken as
    it is); ``flat`` and ``x`` as for ``grid_encode_fwd``.
    """
    if x.device.type == "cpu":
        return grid_encode_bwd_plain(spec, flat, x, dcols, live)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd: unsupported device {x.device}")
    name = "grid_encode_bwd"
    _check_args(name, spec, flat, x)
    F, L = spec.n_features_per_level, spec.n_levels
    B = x.shape[0]
    if dcols.shape != (L * F, B) or dcols.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dcols must be float32 or bfloat16 ({L * F}, {B}), "
                         f"got {dcols.dtype} {tuple(dcols.shape)}")
    require_cuda_tensors(name, x, dcols)
    level_consts = _consts(spec, live, x.device)
    factors, coherent_add = _hash_args(spec)
    grad = torch.empty(flat.numel(), dtype=torch.float32, device=x.device)
    if B == 0:
        return grad.zero_().to(flat.dtype)
    out = grad if flat.dtype == torch.float32 else torch.empty_like(flat)
    kernels().grid_encode_bwd(x, dcols, level_consts, grad, out, spec.n_dims, F,
                              dcols.stride(1), dcols.stride(0), factors,
                              coherent_add, _INTERP_CODE[spec.interpolation])
    grid_encode_bwd.launches += 1
    return out


grid_encode_bwd.launches = 0

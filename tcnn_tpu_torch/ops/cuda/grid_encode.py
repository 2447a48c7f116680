"""Wrappers of kernels G and GB: grid-encode forward
(``csrc/grid_encode.cu``) and backward (``csrc/grid_encode_bwd.cu``), and
of kernels GI, the input gradient (``csrc/grid_encode_bwd_input.cu``), and
GG, second order (``csrc/grid_encode_bwd_bwd.cu``).

G replaces ``tcnn_tpu/ops/pallas/grid_matmul.py::_gather_kernel`` and
``::_gather_kernel_xor`` (and the index build in front of them); GB
replaces ``::_scatter_kernel`` and ``::_scatter_kernel_xor``, the table
gradient of the levels the JAX package routes to its matmul kernels, and
``tcnn_tpu/ops/pallas/scatter.py::_weighted_kernel`` and ``::_pair_kernel``,
the same gradient of the levels it routes to its serial kernels.  Every
level of every grid goes to G and GB: the JAX package's per-level routing
(``grid_ops.py::_route_levels``, ``_serial_level_groups``) weighed TPU
costs and is not carried over.  GI and GG have no TPU kernel: the JAX
package forms both in jnp (``_finish_interp_bwd`` and autodiff of
``_build_indices_weights``).  A CUDA tensor launches the kernel; a CPU
tensor takes ``grid_encode_plain``, ``grid_encode_bwd_plain``,
``grid_encode_bwd_input_plain`` or ``grid_encode_bwd_bwd_plain``, the same
functions in plain PyTorch, which the CPU tests and ``chip_smoke.py`` hold
the kernels against.  G, GB and GI take optional per-sample level fractions
(``level_frac``, the coarse-to-fine mask of ``grid_ops.level_mask``); GG
takes none.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...common import HashType, InterpolationType
from .. import grid_ops
from . import kernels, require_cuda_tensors

_INTERP_CODE = {InterpolationType.NEAREST: 0, InterpolationType.LINEAR: 1,
                InterpolationType.SMOOTHSTEP: 2}


def grid_encode_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                      x: torch.Tensor, live: Sequence[int],
                      soa: bool = False,
                      level_frac: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (grid_ops.py:1198-1297 of the
    JAX package): corner indices and weights (times the per-sample level
    mask of ``level_frac``, as JAX multiplies them), weighted gather, zero
    rows for dead levels, cast to the table's dtype."""
    F = spec.n_features_per_level
    B = x.shape[0]
    cols = torch.zeros((spec.n_levels * F, B), dtype=torch.float32,
                       device=x.device)
    if live:
        idx, ws = grid_ops.build_indices_weights(spec, x, live, level_frac=level_frac)
        live_cols = grid_ops.interpolate_ref(flat, idx, ws, F)
        rows = torch.tensor([l * F + f for l in live for f in range(F)],
                            device=x.device)
        cols = cols.index_copy(0, rows, live_cols)
    out = cols.to(flat.dtype)
    return out if soa else out.t()


def _hash_args(spec: grid_ops.GridSpec):
    if spec.hash_type == HashType.RNG:
        raise NotImplementedError(
            "the Rng (pcg32) grid hash is ported with the grid options "
            "(ROADMAP.md Queue 1 item 7)")
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
    """What the grid kernels take; raises on anything else."""
    if spec.stochastic_interpolation:
        raise NotImplementedError(
            "stochastic interpolation is ported with the grid options "
            "(ROADMAP.md Queue 1 item 7)")
    D, F = spec.n_dims, spec.n_features_per_level
    if not 1 <= D <= 4 or not 1 <= F <= 8:
        raise ValueError(f"{name}: the kernel covers D <= 4 and F <= 8, "
                         f"got D={D}, F={F}")
    if x.dtype != torch.float32 or x.shape != (x.shape[0], D) or (
            D > 1 and x.stride(1) != 1):
        raise ValueError(f"{name}: x must be float32 (B, {D}) with unit stride "
                         f"across its coordinates, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if flat.dtype not in (torch.float32, torch.bfloat16) or flat.ndim != 1 \
            or not flat.is_contiguous() or flat.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be a contiguous, 16-byte "
                         "aligned flat float32 or bfloat16 tensor")
    grid_ops.check_table_size(spec, flat)
    require_cuda_tensors(name, x, flat)


def _check_frac(name: str, x: torch.Tensor, level_frac: Optional[torch.Tensor]) -> None:
    """The per-sample level fractions the kernels take: None, or float32
    (B,), contiguous, on x's device."""
    if level_frac is None:
        return
    if level_frac.dtype != torch.float32 or level_frac.shape != (x.shape[0],) \
            or not level_frac.is_contiguous():
        raise ValueError(f"{name}: level_frac must be contiguous float32 ({x.shape[0]},), "
                         f"got {level_frac.dtype} {tuple(level_frac.shape)}")
    require_cuda_tensors(name, x, level_frac)


def _x_row_stride(x: torch.Tensor) -> int:
    """The kernels' row stride of x: a column slice of a wider input (a
    Composite encoding's part) is read in place, without a copy."""
    return x.stride(0) if x.shape[0] > 1 else x.shape[1]


def grid_encode_fwd(spec: grid_ops.GridSpec, flat: torch.Tensor,
                    x: torch.Tensor, live: Sequence[int],
                    soa: bool = False,
                    level_frac: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L·F) features, or (L·F, B) with ``soa``, in ``flat``'s dtype.

    ``flat`` is the (n_entries·F,) table, float32 or bfloat16; ``x`` is
    (B, D) float32 with unit stride across D, any row stride;
    ``level_frac`` None or the (B,) float32 per-sample level fractions
    (``grid_ops.level_mask``): a masked (sample, level) is written as 0.
    """
    if x.device.type == "cpu":
        return grid_encode_plain(spec, flat, x, live, soa, level_frac)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_fwd: unsupported device {x.device}")
    name = "grid_encode_fwd"
    _check_args(name, spec, flat, x)
    _check_frac(name, x, level_frac)
    level_consts = _consts(spec, live, x.device)
    factors, coherent_add = _hash_args(spec)
    F, L = spec.n_features_per_level, spec.n_levels

    B = x.shape[0]
    out = torch.empty((L * F, B) if soa else (B, L * F), dtype=flat.dtype,
                      device=x.device)
    if B == 0:
        return out
    stride_b, stride_f = (1, B) if soa else (L * F, 1)
    kernels().grid_encode_fwd(x, _x_row_stride(x), level_frac, flat, level_consts, out,
                              spec.n_dims, F, stride_b, stride_f, factors,
                              coherent_add, _INTERP_CODE[spec.interpolation])
    grid_encode_fwd.launches += 1
    return out


grid_encode_fwd.launches = 0


def grid_encode_bwd_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                          x: torch.Tensor, dcols: torch.Tensor,
                          live: Sequence[int],
                          level_frac: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel GB: the table gradient
    dflat[idx_c(b, l)·F + f] += w_c(b, l) · dcols[l·F+f, b] over every
    sample, live level and corner, each product and the sum in fp32
    (``index_add_``), cast once to ``flat``'s dtype
    (grid_ops.py:1099-1102 of the JAX package).  ``dcols`` is the
    (L·F, B) SoA output gradient; dead levels, and the (sample, level)
    pairs ``level_frac`` masks, add nothing."""
    F = spec.n_features_per_level
    B = x.shape[0]
    dflat = torch.zeros((spec.n_entries, F), dtype=torch.float32,
                        device=x.device)
    if live and B:
        idx, ws = grid_ops.build_indices_weights(spec, x, live, level_frac=level_frac)
        L = len(live)
        C = ws.shape[0] // L
        rows = torch.tensor([l * F + f for l in live for f in range(F)],
                            device=x.device)
        dy = dcols.index_select(0, rows).float().reshape(L, F, B)
        vals = ws.reshape(L, C, B, 1) * dy.permute(0, 2, 1).reshape(L, 1, B, F)
        dflat.index_add_(0, idx.reshape(-1), vals.reshape(-1, F))
    return dflat.reshape(-1).to(flat.dtype)


# Kernel GB's plan (csrc/grid_encode_bwd.cu).  A CTA may hold a window of
# GB_WINDOW_BYTES of one level's fp32 gradient rows in shared memory (the
# 232,448 bytes of an sm_90 CTA, less what the kernel declares itself); a
# level of up to GB_MAX_PARTS windows whose rows take GB_MIN_HITS updates
# or more over the batch (B·C / rows, C corners per sample) is cut into that
# many parts, the others go to direct atomics.  A window item takes a chunk
# of samples such that each of its rows takes about GB_REUSE updates,
# GB_MIN_CHUNK samples at least; a direct item GB_DIRECT_CHUNK samples.
# All items run in one launch, the longest first, so that an SM sums
# windows in shared memory while the L2 takes other CTAs' direct atomics;
# with GB_CLUSTER_PARTS (and kClusterParts in the kernel) a two-part
# level's halves run as 2-CTA clusters, in a launch of their own.  Each
# value was chosen by measurement on an H100 (PERF.md, the ablations of
# tools/kernel_ablation.py): at config_hash every level windowed took
# 0.2981 ms, windows from 64, 128, 256, 512 and 1024 updates per row
# 0.2123, 0.1888, 0.1593, 0.1633 and 0.1934 ms, every level direct 0.2892.
GB_WINDOW_BYTES = 232448 - 1024
GB_MAX_PARTS = 2
GB_MIN_HITS = 256
GB_REUSE = 8
GB_MIN_CHUNK = 4096
GB_DIRECT_CHUNK = 2048
GB_CLUSTER_PARTS = False


class GbPlan(NamedTuple):
    """Kernel GB's work: ``items`` (n, 5) int32, per item (level, row_lo,
    n_rows, b0, b1), a window of rows [row_lo, row_lo + n_rows) of the
    level (n_rows 0: direct atomics) over samples [b0, b1); ``groups``, per
    launch (first item, items, window bytes, parts), parts 2 where
    consecutive item pairs are the two halves of one level and chunk, run
    as 2-CTA clusters."""
    items: np.ndarray
    groups: Tuple[Tuple[int, int, int, int], ...]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def gb_plan(spec: grid_ops.GridSpec, live: Sequence[int], batch: int) -> GbPlan:
    """Kernel GB's work items and launches for ``batch`` samples (see the
    GB_ constants): every (live level, sample) is in one item per part of
    its level, every row of a windowed level in one part."""
    F, C = spec.n_features_per_level, 1 << spec.n_dims
    cap = GB_WINDOW_BYTES // (4 * F)            # rows one window holds
    singles, pairs, direct = [], [], []
    for l in live:
        size = spec.levels[l].size
        parts = -(-size // cap)
        if parts > GB_MAX_PARTS or batch * C < GB_MIN_HITS * size:
            direct += [(l, 0, 0, b0, min(batch, b0 + GB_DIRECT_CHUNK))
                       for b0 in range(0, batch, GB_DIRECT_CHUNK)]
            continue
        rows = -(-size // parts)
        chunk = max(GB_MIN_CHUNK, _pow2_at_least(-(-GB_REUSE * size // C)))
        for b0 in range(0, batch, chunk):
            b1 = min(batch, b0 + chunk)
            its = [(l, p * rows, min(rows, size - p * rows), b0, b1) for p in range(parts)]
            if parts == 2 and GB_CLUSTER_PARTS:
                pairs.append(its)
            else:
                singles += its
    # the longest items first (samples, then window), so that the short
    # ones fill in behind them
    singles = sorted(singles + direct, key=lambda it: (it[4] - it[3], it[2]), reverse=True)
    items, groups = [], []
    for its, parts in (([it for pair in pairs for it in pair], 2), (singles, 1)):
        if not its:
            continue
        window = max(-(-n * F * 4 // 16) * 16 for _, _, n, _, _ in its)
        groups.append((len(items), len(its), window, parts))
        items.extend(its)
    return GbPlan(np.asarray(items, np.int32).reshape(-1, 5), tuple(groups))


_gb_plans: Dict[Tuple, Tuple[torch.Tensor, List[int]]] = {}


def _gb_plan_on(spec: grid_ops.GridSpec, live: Sequence[int], batch: int,
                device: torch.device) -> Tuple[torch.Tensor, List[int]]:
    """``gb_plan``'s items on ``device`` and its groups as a flat list,
    cached so that a training step copies nothing to the card."""
    key = (spec, tuple(live), batch, device)
    if key not in _gb_plans:
        plan = gb_plan(spec, live, batch)
        items = torch.from_numpy(plan.items.reshape(-1)).to(device)
        if items.numel() == 0:   # a valid pointer for a launch with no items
            items = torch.zeros(5, dtype=torch.int32, device=device)
        _gb_plans[key] = (items, [v for g in plan.groups for v in g])
    return _gb_plans[key]


def grid_encode_bwd(spec: grid_ops.GridSpec, flat: torch.Tensor,
                    x: torch.Tensor, dcols: torch.Tensor,
                    live: Sequence[int],
                    level_frac: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_entries·F,) table gradient in ``flat``'s dtype.

    ``dcols`` is the output gradient in the SoA layout (L·F, B), float32 or
    bfloat16, any strides (the transpose of an AoS gradient is taken as
    it is); ``flat``, ``x`` and ``level_frac`` as for ``grid_encode_fwd``:
    a masked (sample, level) issues no update.  Levels whose
    rows fit in one or two CTAs' shared memory are summed there
    (``gb_plan``), the others by direct atomics: by design, not as a
    fallback.
    """
    if x.device.type == "cpu":
        return grid_encode_bwd_plain(spec, flat, x, dcols, live, level_frac)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd: unsupported device {x.device}")
    name = "grid_encode_bwd"
    _check_args(name, spec, flat, x)
    _check_frac(name, x, level_frac)
    F, L = spec.n_features_per_level, spec.n_levels
    B = x.shape[0]
    if dcols.shape != (L * F, B) or dcols.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dcols must be float32 or bfloat16 ({L * F}, {B}), "
                         f"got {dcols.dtype} {tuple(dcols.shape)}")
    require_cuda_tensors(name, x, dcols)
    if B >= 2 ** 31:
        raise ValueError(f"{name}: {B} samples exceed the plan's int32 sample indices")
    level_consts = _consts(spec, live, x.device)
    items, groups = _gb_plan_on(spec, live, B, x.device)
    factors, coherent_add = _hash_args(spec)
    grad = torch.empty(flat.numel(), dtype=torch.float32, device=x.device)
    if B == 0:
        return grad.zero_().to(flat.dtype)
    out = grad if flat.dtype == torch.float32 else torch.empty_like(flat)
    kernels().grid_encode_bwd(x, _x_row_stride(x), level_frac, dcols, level_consts, items,
                              groups, grad,
                              out, spec.n_dims, F, dcols.stride(1), dcols.stride(0),
                              factors, coherent_add,
                              _INTERP_CODE[spec.interpolation])
    grid_encode_bwd.launches += 1
    return out


grid_encode_bwd.launches = 0


def _check_dcols(name: str, spec: grid_ops.GridSpec, x: torch.Tensor,
                 dcols: torch.Tensor) -> None:
    L, F, B = spec.n_levels, spec.n_features_per_level, x.shape[0]
    if dcols.shape != (L * F, B) or dcols.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dcols must be float32 or bfloat16 ({L * F}, {B}), "
                         f"got {dcols.dtype} {tuple(dcols.shape)}")
    require_cuda_tensors(name, x, dcols)


def _live_dcols(spec: grid_ops.GridSpec, dcols: torch.Tensor,
                live: Sequence[int]) -> torch.Tensor:
    """The live levels' rows of the (L·F, B) dcols, in fp32, as (L_live, F, B)."""
    F = spec.n_features_per_level
    rows = torch.tensor([l * F + f for l in live for f in range(F)], device=dcols.device)
    return dcols.index_select(0, rows).float().reshape(len(live), F, -1)


def _corner_features(spec: grid_ops.GridSpec, flat: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """(L, C, B, F) fp32 table rows at the corners ``idx`` (L, C·B)."""
    F = spec.n_features_per_level
    L = idx.shape[0]
    return flat.reshape(-1, F)[idx.reshape(-1)].float().reshape(L, 1 << spec.n_dims, -1, F)


def grid_encode_bwd_input_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                                x: torch.Tensor, dcols: torch.Tensor,
                                live: Sequence[int],
                                level_frac: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel GI: dx[b, d] = Σ_l Σ_c ∂w_c/∂x_d ·
    Σ_k table[row_c, k] · dcols[l·F+k, b], in fp32 (the JAX package's
    ``dws`` of ``_finish_interp_bwd``, grid_ops.py:1104-1119, carried
    through ``_build_indices_weights``' derivative).  Returns (B, D)
    float32; dead levels, and masked (sample, level) pairs, add nothing."""
    B, D = x.shape
    dx = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    if live and B:
        idx, _, dws = grid_ops.build_indices_weights(spec, x, live, order=1,
                                                     level_frac=level_frac)
        feats = _corner_features(spec, flat, idx)                     # (L, C, B, F)
        dy = _live_dcols(spec, dcols, live).permute(0, 2, 1)[:, None]  # (L, 1, B, F)
        val = (feats * dy).sum(-1)                                    # (L, C, B)
        dx = (dws.reshape(*val.shape, D) * val[..., None]).sum((0, 1))
    return dx


def grid_encode_bwd_input(spec: grid_ops.GridSpec, flat: torch.Tensor,
                          x: torch.Tensor, dcols: torch.Tensor,
                          live: Sequence[int],
                          level_frac: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, D) float32 input gradient of the grid encoding (kernel GI).

    ``flat`` is the (n_entries·F,) table, float32 or bfloat16, ``x`` the
    (B, D) float32 input (unit stride across D, any row stride), ``dcols``
    the (L·F, B) SoA output gradient, float32 or bfloat16, any strides,
    ``level_frac`` as for ``grid_encode_fwd``.
    """
    if x.device.type == "cpu":
        return grid_encode_bwd_input_plain(spec, flat, x, dcols, live, level_frac)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd_input: unsupported device {x.device}")
    name = "grid_encode_bwd_input"
    _check_args(name, spec, flat, x)
    _check_dcols(name, spec, x, dcols)
    _check_frac(name, x, level_frac)
    level_consts = _consts(spec, live, x.device)
    factors, coherent_add = _hash_args(spec)
    B, D = x.shape
    dx = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if B == 0:
        return dx
    kernels().grid_encode_bwd_input(x, _x_row_stride(x), level_frac, flat, dcols,
                                    level_consts, dx,
                                    D, spec.n_features_per_level, dcols.stride(1),
                                    dcols.stride(0), factors, coherent_add,
                                    _INTERP_CODE[spec.interpolation])
    grid_encode_bwd_input.launches += 1
    return dx


grid_encode_bwd_input.launches = 0


class BwdBwd(NamedTuple):
    """The outputs of kernel GG (or its plain version); None where not asked for."""
    d_dcols: Optional[torch.Tensor]   # (L·F, B) float32 SoA, zero rows for dead levels
    d_x: Optional[torch.Tensor]       # (B, D) float32
    rows: Optional[torch.Tensor]      # (L_live·C·B,) int32 table rows
    g: Optional[torch.Tensor]         # (L_live·C·B, F) float32 updates of those rows


def grid_encode_bwd_bwd_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                              x: torch.Tensor, dcols: torch.Tensor, ddx: torch.Tensor,
                              live: Sequence[int], need_dcols: bool = True,
                              need_x: bool = True, need_rows: bool = True) -> BwdBwd:
    """Plain PyTorch version of kernel GG, the backward of the input
    gradient given its cotangent ``ddx`` (B, D).  With w'_c = Σ_d
    ∂w_c/∂x_d · ddx_d per (level, corner, sample):
      d_dcols[l·F+k, b] = Σ_c w'_c · table[row_c, k];
      d_x[b, e] = Σ_{l,c,k} Σ_d ∂²w_c/∂x_d∂x_e · ddx_d · table[row_c, k] · dcols[l·F+k, b];
      rows, g: the corner rows and g = w'_c · dcols[l·F:(l+1)·F, b], whose
      scatter-add (kernel RS) is the table gradient.
    All in fp32; (rows, g) in (live level, corner, sample) order."""
    B, D = x.shape
    F, C, L = spec.n_features_per_level, 1 << spec.n_dims, len(live)
    dev = x.device
    d_dcols = (torch.zeros((spec.n_levels * F, B), dtype=torch.float32, device=dev)
               if need_dcols else None)
    d_x = torch.zeros((B, D), dtype=torch.float32, device=dev) if need_x else None
    rows = torch.zeros(L * C * B, dtype=torch.int32, device=dev) if need_rows else None
    g = torch.zeros((L * C * B, F), dtype=torch.float32, device=dev) if need_rows else None
    if not (live and B):
        return BwdBwd(d_dcols, d_x, rows, g)
    idx, _, dws, d2ws = grid_ops.build_indices_weights(spec, x, live, order=2)
    v = ddx.float()
    wp = (dws * v[None]).sum(-1).reshape(L, C, B)               # w'_c
    feats = _corner_features(spec, flat, idx)                    # (L, C, B, F)
    dy = _live_dcols(spec, dcols, live).permute(0, 2, 1)[:, None]  # (L, 1, B, F)
    if need_dcols:
        live_rows = torch.tensor([l * F + f for l in live for f in range(F)], device=dev)
        dd = (wp[..., None] * feats).sum(1)                      # (L, B, F)
        d_dcols.index_copy_(0, live_rows, dd.permute(0, 2, 1).reshape(L * F, B))
    if need_x:
        val = (feats * dy).sum(-1)                               # (L, C, B)
        hv = (d2ws * v[None, :, :, None]).sum(-2).reshape(L, C, B, D)
        d_x = (hv * val[..., None]).sum((0, 1))
    if need_rows:
        rows = idx.reshape(-1).to(torch.int32)
        g = (wp[..., None] * dy).reshape(L * C * B, F)
    return BwdBwd(d_dcols, d_x, rows, g)


def grid_encode_bwd_bwd(spec: grid_ops.GridSpec, flat: torch.Tensor, x: torch.Tensor,
                        dcols: torch.Tensor, ddx: torch.Tensor, live: Sequence[int],
                        need_dcols: bool = True, need_x: bool = True,
                        need_rows: bool = True) -> BwdBwd:
    """Kernel GG: see ``grid_encode_bwd_bwd_plain``.  ``flat``, ``x`` and
    ``dcols`` as for ``grid_encode_bwd_input``; ``ddx`` (B, D) float32."""
    if x.device.type == "cpu":
        return grid_encode_bwd_bwd_plain(spec, flat, x, dcols, ddx, live, need_dcols,
                                         need_x, need_rows)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd_bwd: unsupported device {x.device}")
    name = "grid_encode_bwd_bwd"
    _check_args(name, spec, flat, x)
    _check_dcols(name, spec, x, dcols)
    B, D = x.shape
    if ddx.shape != (B, D):
        raise ValueError(f"{name}: ddx must be ({B}, {D}), got {tuple(ddx.shape)}")
    ddx = ddx.float().contiguous()
    require_cuda_tensors(name, x, ddx)
    level_consts = _consts(spec, live, x.device)
    factors, coherent_add = _hash_args(spec)
    F, C, L = spec.n_features_per_level, 1 << D, len(live)
    dev = x.device
    out = BwdBwd(
        torch.empty((spec.n_levels * F, B), dtype=torch.float32, device=dev)
        if need_dcols else None,
        torch.empty((B, D), dtype=torch.float32, device=dev) if need_x else None,
        torch.empty(L * C * B, dtype=torch.int32, device=dev) if need_rows else None,
        torch.empty((L * C * B, F), dtype=torch.float32, device=dev) if need_rows else None)
    if B == 0:
        return out
    kernels().grid_encode_bwd_bwd(x, _x_row_stride(x), flat, dcols, ddx, level_consts,
                                  *out, D, F, dcols.stride(1), dcols.stride(0), factors,
                                  coherent_add, _INTERP_CODE[spec.interpolation])
    grid_encode_bwd_bwd.launches += 1
    return out


grid_encode_bwd_bwd.launches = 0

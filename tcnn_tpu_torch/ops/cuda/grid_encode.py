"""Wrappers of kernels G and GB: grid-encode forward
(``csrc/grid_encode.cu``) and backward (``csrc/grid_encode_bwd.cu``), and
of kernels GI, the input gradient (``csrc/grid_encode_bwd_input.cu``), GG,
second order (``csrc/grid_encode_bwd_bwd.cu``), and GT, third order
(``csrc/grid_encode_third.cu``).

G replaces ``tcnn_tpu/ops/pallas/grid_matmul.py::_gather_kernel`` and
``::_gather_kernel_xor`` (and the index build in front of them); GB
replaces ``::_scatter_kernel`` and ``::_scatter_kernel_xor``, the table
gradient of the levels the JAX package routes to its matmul kernels, and
``tcnn_tpu/ops/pallas/scatter.py::_weighted_kernel`` and ``::_pair_kernel``,
the same gradient of the levels it routes to its serial kernels.  Every
level of every grid goes to G and GB: the JAX package's per-level routing
(``grid_ops.py::_route_levels``, ``_serial_level_groups``) weighed TPU
costs and is not carried over.  GI, GG and GT have no TPU kernel: the JAX
package forms them in jnp (``_finish_interp_bwd`` and autodiff of
``_build_indices_weights``, and of the backward of ``_grid_interpolate``);
GG and GT add their table gradients themselves, on GB's work plan
(``gb_plan``).  A CUDA tensor launches the kernel; a CPU tensor takes
``grid_encode_plain``, ``grid_encode_bwd_plain``, ``grid_encode_bwd_input_plain``,
``grid_encode_bwd_bwd_plain`` or ``grid_encode_third_plain``, the same
functions in plain PyTorch, which the CPU tests and ``chip_smoke.py`` hold
the kernels against.  All five take optional per-sample level fractions
(``level_frac``, the coarse-to-fine mask of ``grid_ops.level_mask``), every
hash type, 1 to 7 dims and any number of features per level.  Rng grids
(the pcg32 hash, each corner's in full), 5 to 7 dims and more than 8
features per level run one instance of each kernel with D at run time
(csrc/grid_common.cuh: WideCorners; F > 8 in groups of 8 features, each
group over every corner again, so that GI's, GG's and GT's sums over the
features stay in one thread, in one order); the 1- to 4-D instances
template F over 1 to 8.  Under stochastic interpolation GB scatters with
JAX's ``ws_bwd`` (``grid_ops.build_indices_weights(scatter=True)``), from
the uniforms of ``grid_ops.stochastic_uniforms``, in that instance too; G,
GI, GG and GT use the ordinary weights, as JAX's forward and input
gradient do, but for G's stochastic gather (``stochastic=True``), the
transpose of GB's scatter there.

Shard mode (``shard`` = (sid, n), ``grid_ops.sharded_tables``): the table
is rank sid's block-cyclic shard of n, rows [sid·size/n, (sid+1)·size/n)
of every level; each kernel computes every corner's row as before and
takes only the corners whose rows the shard holds (``grid_ops.level_params``
carries the shard's rows).  G adds no feature for another rank's corner,
GB issues no atomic, GI adds no term to dx, GG and GT add nothing to any
of their outputs, whose table gradients have the shard's rows.  Unsharded
(None) every kernel runs as it did.  GB tests ``sharded`` at run time in
its instances (only its direct atomics need the test: the plan's windows
lie in the shard's block); G runs its run-time-D instance with the test,
and GI, GG and GT a shard copy of theirs, so that the 1- to 4-D instances
of G, GI, GG and GT carry no code of it.
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
                      level_frac: Optional[torch.Tensor] = None,
                      shard: Optional[Tuple[int, int]] = None,
                      stochastic: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (grid_ops.py:1198-1297 of the
    JAX package): corner indices and weights (times the per-sample level
    mask of ``level_frac``, as JAX multiplies them), weighted gather, zero
    rows for dead levels, cast to the table's dtype; with ``shard``, the
    shard's fp32 partial features (cast after the sum over shards).
    ``stochastic``: gather with the scatter weights of stochastic
    interpolation (``build_indices_weights(scatter=True)``), each (level,
    sample)'s one-hot corner: the transpose of GB's stochastic scatter."""
    F = spec.n_features_per_level
    B = x.shape[0]
    cols = torch.zeros((spec.n_levels * F, B), dtype=torch.float32,
                       device=x.device)
    if live:
        idx, ws = grid_ops.build_indices_weights(spec, x, live, level_frac=level_frac,
                                                 shard=shard, scatter=stochastic)
        live_cols = grid_ops.interpolate_ref(flat, idx, ws, F)
        rows = torch.tensor([l * F + f for l in live for f in range(F)],
                            device=x.device)
        cols = cols.index_copy(0, rows, live_cols)
    out = cols if shard else cols.to(flat.dtype)
    return out if soa else out.t()


_HASH_KIND = {HashType.COHERENT_ADD: 1, HashType.RNG: 2}   # others 0: the factors' XOR


def _hash_args(spec: grid_ops.GridSpec):
    """The kernels' hash arguments: seven uint32 factors (zero past D; none
    for Rng) and the kind (csrc/grid_common.cuh::make_hash_consts)."""
    kind = _HASH_KIND.get(spec.hash_type, 0)
    factors = [] if kind == 2 else list(grid_ops.hash_factors(
        HashType.COHERENT_PRIME if kind == 1 else spec.hash_type, spec.n_dims))
    return factors + [0] * (grid_ops.MAX_DIMS - len(factors)), kind


_level_consts: Dict[Tuple, torch.Tensor] = {}


def _consts(spec: grid_ops.GridSpec, live: Sequence[int],
            device: torch.device, shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The kernel's (L, LEVEL_FIELDS) int32 level constants on ``device``,
    cached so that a request copies nothing to the card."""
    key = (spec, tuple(live), device, shard)
    if key not in _level_consts:
        _level_consts[key] = torch.from_numpy(
            grid_ops.level_params(spec, live, shard)).to(device)
    return _level_consts[key]


def _check_shard(name: str, spec: grid_ops.GridSpec,
                 shard: Optional[Tuple[int, int]]) -> int:
    """The shard count of ``shard`` (1: none); raises where the grid does
    not shard so."""
    if shard is None:
        return 1
    sid, n = shard
    if not (0 <= sid < n and grid_ops.shardable_levels(spec, n)):
        raise ValueError(f"{name}: shard {shard} of a grid with level sizes "
                         f"{[lv.size for lv in spec.levels]}")
    if spec.stochastic_interpolation:
        raise NotImplementedError(f"{name}: stochastic interpolation on a sharded table")
    return n


def _check_args(name: str, spec: grid_ops.GridSpec, flat: torch.Tensor,
                x: torch.Tensor, shard: Optional[Tuple[int, int]] = None) -> None:
    """What the grid kernels take; raises on anything else."""
    D, F = spec.n_dims, spec.n_features_per_level
    if not 1 <= D <= grid_ops.MAX_DIMS or F < 1:
        raise ValueError(f"{name}: the kernel covers 1 <= D <= {grid_ops.MAX_DIMS} and "
                         f"F >= 1 (F > 8 in its run-time-D instance), got D={D}, F={F}")
    if x.dtype != torch.float32 or x.shape != (x.shape[0], D) or (
            D > 1 and x.stride(1) != 1):
        raise ValueError(f"{name}: x must be float32 (B, {D}) with unit stride "
                         f"across its coordinates, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if flat.dtype not in (torch.float32, torch.bfloat16) or flat.ndim != 1 \
            or not flat.is_contiguous() or flat.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be a contiguous, 16-byte "
                         "aligned flat float32 or bfloat16 tensor")
    grid_ops.check_table_size(spec, flat, _check_shard(name, spec, shard))
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
                    level_frac: Optional[torch.Tensor] = None,
                    shard: Optional[Tuple[int, int]] = None,
                    stochastic: bool = False) -> torch.Tensor:
    """(B, L·F) features, or (L·F, B) with ``soa``, in ``flat``'s dtype
    (with ``shard``, float32 partial features: their sum over the shards is
    rounded once, after the reduce-scatter).

    ``flat`` is the (n_entries·F,) table, float32 or bfloat16; ``x`` is
    (B, D) float32 with unit stride across D, any row stride;
    ``level_frac`` None or the (B,) float32 per-sample level fractions
    (``grid_ops.level_mask``): a masked (sample, level) is written as 0;
    ``shard`` (sid, n) or None: see the module docstring.  ``stochastic``
    (a spec with stochastic interpolation): each (level, sample) reads its
    one-hot corner alone, picked by the uniforms of
    ``grid_ops.stochastic_uniforms`` as GB picks it (the derivative of a
    loss on GB's table gradient in its cotangent); the run-time-D instance
    takes the uniforms.
    """
    if stochastic and not spec.stochastic_interpolation:
        raise ValueError("grid_encode_fwd: stochastic gather of a grid without "
                         "stochastic interpolation")
    if x.device.type == "cpu":
        return grid_encode_plain(spec, flat, x, live, soa, level_frac, shard, stochastic)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_fwd: unsupported device {x.device}")
    name = "grid_encode_fwd"
    _check_args(name, spec, flat, x, shard)
    _check_frac(name, x, level_frac)
    level_consts = _consts(spec, live, x.device, shard)
    factors, hash_kind = _hash_args(spec)
    F, L = spec.n_features_per_level, spec.n_levels

    B = x.shape[0]
    out = torch.empty((L * F, B) if soa else (B, L * F),
                      dtype=torch.float32 if shard else flat.dtype, device=x.device)
    if B == 0:
        return out
    stride_b, stride_f = (1, B) if soa else (L * F, 1)
    u = grid_ops.stochastic_uniforms(L, B, x.device) if stochastic else None
    kernels().grid_encode_fwd(x, _x_row_stride(x), level_frac, flat, level_consts, out,
                              spec.n_dims, F, stride_b, stride_f, factors,
                              hash_kind, _INTERP_CODE[spec.interpolation], shard is not None,
                              u)
    grid_encode_fwd.launches += 1
    return out


grid_encode_fwd.launches = 0


def grid_encode_bwd_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                          x: torch.Tensor, dcols: torch.Tensor,
                          live: Sequence[int],
                          level_frac: Optional[torch.Tensor] = None,
                          shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel GB: the table gradient
    dflat[idx_c(b, l)·F + f] += w_c(b, l) · dcols[l·F+f, b] over every
    sample, live level and corner, each product and the sum in fp32
    (``index_add_``), cast once to ``flat``'s dtype
    (grid_ops.py:1099-1102 of the JAX package).  ``dcols`` is the
    (L·F, B) SoA output gradient; dead levels, and the (sample, level)
    pairs ``level_frac`` masks, add nothing.  w are the scatter weights,
    stochastic interpolation's one-hot corner where the spec asks for it
    (``build_indices_weights(scatter=True)``).  With ``shard``, the shard's
    rows only."""
    F = spec.n_features_per_level
    B = x.shape[0]
    n_rows = spec.n_entries // (shard[1] if shard else 1)
    dflat = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    if live and B:
        idx, ws = grid_ops.build_indices_weights(spec, x, live, level_frac=level_frac,
                                                 scatter=True, shard=shard)
        L = len(live)
        C = ws.shape[0] // L
        rows = torch.tensor([l * F + f for l in live for f in range(F)],
                            device=x.device)
        dy = dcols.index_select(0, rows).float().reshape(L, F, B)
        vals = ws.reshape(L, C, B, 1) * dy.permute(0, 2, 1).reshape(L, 1, B, F)
        dflat.index_add_(0, idx.reshape(-1).clamp_min(0), vals.reshape(-1, F))
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
# Kernel GG (csrc/grid_encode_bwd_bwd.cu) runs on gb_plan's items with
# chunks of its own (gg_chunks): a level's samples cut into about GG_ITEMS
# items, at least GG_THREADS samples (GG's CTA: one (sample, level) a
# thread).  A thread's samples run one after the other, and each window
# item flushes its rows once: measured on an H100 (PERF.md), GG at the SDF
# fit's 2^14 samples ran 5.6x faster with one sample a thread than with 16
# (GB's chunks), and at 2^18 16% slower, where a coarse level's 1024
# windows each flushed the same 64 rows.  Kernel GT
# (csrc/grid_encode_third.cu) runs on the same chunks: its CTA has GG's
# shape and its work per corner is GG's with a few more products, so what
# sized GG's items sizes its own (PERF.md records GT's times on them).
GG_THREADS = 256
GG_ITEMS = 64


def gg_chunks(batch: int) -> Tuple[int, int]:
    """Kernel GG's ``chunks`` of ``gb_plan`` for ``batch`` samples."""
    chunk = max(GG_THREADS, _pow2_at_least(-(-batch // GG_ITEMS)))
    return chunk, chunk


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


def gb_plan(spec: grid_ops.GridSpec, live: Sequence[int], batch: int,
            shard: Optional[Tuple[int, int]] = None,
            chunks: Optional[Tuple[int, int]] = None) -> GbPlan:
    """Kernel GB's work items and launches for ``batch`` samples (see the
    GB_ constants): every (live level, sample) is in one item per part of
    its level, every row of a windowed level in one part.  With ``shard``
    (sid, n) the windows cover the shard's block of each level, level-local
    rows [sid·size/n, (sid+1)·size/n) (the kernel skips a corner outside
    its window, so another rank's corners add nothing there), planned over
    the block's size/n rows; a row's updates over the batch, which decide
    windows and chunks, are the whole level's B·C / size.  ``chunks``
    (a direct item's samples, a window item's least samples; None:
    GB_DIRECT_CHUNK, GB_MIN_CHUNK) size the items: kernel GG runs on the
    same plan with ``gg_chunks``."""
    direct_chunk, min_chunk = chunks or (GB_DIRECT_CHUNK, GB_MIN_CHUNK)
    F, C = spec.n_features_per_level, 1 << spec.n_dims
    cap = GB_WINDOW_BYTES // (4 * F)            # rows one window holds
    sid, n = shard or (0, 1)
    singles, pairs, direct = [], [], []
    for l in live:
        size = spec.levels[l].size
        block, lo = size // n, sid * (size // n)
        parts = -(-block // cap)
        if parts > GB_MAX_PARTS or batch * C < GB_MIN_HITS * size:
            direct += [(l, 0, 0, b0, min(batch, b0 + direct_chunk))
                       for b0 in range(0, batch, direct_chunk)]
            continue
        rows = -(-block // parts)
        chunk = max(min_chunk, _pow2_at_least(-(-GB_REUSE * size // C)))
        for b0 in range(0, batch, chunk):
            b1 = min(batch, b0 + chunk)
            its = [(l, lo + p * rows, min(rows, block - p * rows), b0, b1)
                   for p in range(parts)]
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
                device: torch.device, shard: Optional[Tuple[int, int]] = None,
                chunks: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, List[int]]:
    """``gb_plan``'s items on ``device`` and its groups as a flat list,
    cached so that a training step copies nothing to the card."""
    key = (spec, tuple(live), batch, device, shard, chunks)
    if key not in _gb_plans:
        plan = gb_plan(spec, live, batch, shard, chunks)
        items = torch.from_numpy(plan.items.reshape(-1)).to(device)
        if items.numel() == 0:   # a valid pointer for a launch with no items
            items = torch.zeros(5, dtype=torch.int32, device=device)
        _gb_plans[key] = (items, [v for g in plan.groups for v in g])
    return _gb_plans[key]


def grid_encode_bwd(spec: grid_ops.GridSpec, flat: torch.Tensor,
                    x: torch.Tensor, dcols: torch.Tensor,
                    live: Sequence[int],
                    level_frac: Optional[torch.Tensor] = None,
                    shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(n_entries·F,) table gradient in ``flat``'s dtype (the shard's
    rows with ``shard``).

    ``dcols`` is the output gradient in the SoA layout (L·F, B), float32 or
    bfloat16, any strides (the transpose of an AoS gradient is taken as
    it is); ``flat``, ``x`` and ``level_frac`` as for ``grid_encode_fwd``:
    a masked (sample, level) issues no update.  Levels whose
    rows fit in one or two CTAs' shared memory are summed there
    (``gb_plan``), the others by direct atomics: by design, not as a
    fallback.  Under stochastic interpolation the kernel takes the
    (n_levels, B) uniforms of ``grid_ops.stochastic_uniforms``.
    """
    if x.device.type == "cpu":
        return grid_encode_bwd_plain(spec, flat, x, dcols, live, level_frac, shard)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd: unsupported device {x.device}")
    name = "grid_encode_bwd"
    _check_args(name, spec, flat, x, shard)
    _check_frac(name, x, level_frac)
    F, L = spec.n_features_per_level, spec.n_levels
    B = x.shape[0]
    if dcols.shape != (L * F, B) or dcols.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dcols must be float32 or bfloat16 ({L * F}, {B}), "
                         f"got {dcols.dtype} {tuple(dcols.shape)}")
    require_cuda_tensors(name, x, dcols)
    if B >= 2 ** 31:
        raise ValueError(f"{name}: {B} samples exceed the plan's int32 sample indices")
    level_consts = _consts(spec, live, x.device, shard)
    items, groups = _gb_plan_on(spec, live, B, x.device, shard)
    factors, hash_kind = _hash_args(spec)
    grad = torch.empty(flat.numel(), dtype=torch.float32, device=x.device)
    if B == 0:
        return grad.zero_().to(flat.dtype)
    out = grad if flat.dtype == torch.float32 else torch.empty_like(flat)
    u = (grid_ops.stochastic_uniforms(L, B, x.device) if spec.stochastic_interpolation
         else None)
    kernels().grid_encode_bwd(x, _x_row_stride(x), level_frac, dcols, level_consts, items,
                              groups, grad,
                              out, spec.n_dims, F, dcols.stride(1), dcols.stride(0),
                              factors, hash_kind,
                              _INTERP_CODE[spec.interpolation], u, shard is not None)
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
    """(L, C, B, F) fp32 table rows at the corners ``idx`` (L, C·B); row −1
    (another shard's corner) reads row 0."""
    F = spec.n_features_per_level
    L = idx.shape[0]
    return flat.reshape(-1, F)[idx.reshape(-1).clamp_min(0)].float().reshape(
        L, 1 << spec.n_dims, -1, F)


def grid_encode_bwd_input_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                                x: torch.Tensor, dcols: torch.Tensor,
                                live: Sequence[int],
                                level_frac: Optional[torch.Tensor] = None,
                                shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel GI: dx[b, d] = Σ_l Σ_c ∂w_c/∂x_d ·
    Σ_k table[row_c, k] · dcols[l·F+k, b], in fp32 (the JAX package's
    ``dws`` of ``_finish_interp_bwd``, grid_ops.py:1104-1119, carried
    through ``_build_indices_weights``' derivative).  Returns (B, D)
    float32; dead levels, masked (sample, level) pairs and, with ``shard``,
    other ranks' corners add nothing."""
    B, D = x.shape
    dx = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    if live and B:
        idx, _, dws = grid_ops.build_indices_weights(spec, x, live, order=1,
                                                     level_frac=level_frac, shard=shard)
        feats = _corner_features(spec, flat, idx)                     # (L, C, B, F)
        dy = _live_dcols(spec, dcols, live).permute(0, 2, 1)[:, None]  # (L, 1, B, F)
        val = (feats * dy).sum(-1)                                    # (L, C, B)
        dx = (dws.reshape(*val.shape, D) * val[..., None]).sum((0, 1))
    return dx


def grid_encode_bwd_input(spec: grid_ops.GridSpec, flat: torch.Tensor,
                          x: torch.Tensor, dcols: torch.Tensor,
                          live: Sequence[int],
                          level_frac: Optional[torch.Tensor] = None,
                          shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(B, D) float32 input gradient of the grid encoding (kernel GI).

    ``flat`` is the (n_entries·F,) table, float32 or bfloat16, ``x`` the
    (B, D) float32 input (unit stride across D, any row stride), ``dcols``
    the (L·F, B) SoA output gradient, float32 or bfloat16, any strides,
    ``level_frac`` as for ``grid_encode_fwd``.
    """
    if x.device.type == "cpu":
        return grid_encode_bwd_input_plain(spec, flat, x, dcols, live, level_frac, shard)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd_input: unsupported device {x.device}")
    name = "grid_encode_bwd_input"
    _check_args(name, spec, flat, x, shard)
    _check_dcols(name, spec, x, dcols)
    _check_frac(name, x, level_frac)
    level_consts = _consts(spec, live, x.device, shard)
    factors, hash_kind = _hash_args(spec)
    B, D = x.shape
    dx = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if B == 0:
        return dx
    kernels().grid_encode_bwd_input(x, _x_row_stride(x), level_frac, flat, dcols,
                                    level_consts, dx,
                                    D, spec.n_features_per_level, dcols.stride(1),
                                    dcols.stride(0), factors, hash_kind,
                                    _INTERP_CODE[spec.interpolation], shard is not None)
    grid_encode_bwd_input.launches += 1
    return dx


grid_encode_bwd_input.launches = 0


class BwdBwd(NamedTuple):
    """The outputs of kernel GG (or its plain version); None where not asked for."""
    d_dcols: Optional[torch.Tensor]   # (L·F, B) float32 SoA, zero rows for dead levels
    d_x: Optional[torch.Tensor]       # (B, D) float32
    d_flat: Optional[torch.Tensor]    # (n_entries·F,) table gradient, the table's dtype


def grid_encode_bwd_bwd_plain(spec: grid_ops.GridSpec, flat: torch.Tensor,
                              x: torch.Tensor, dcols: torch.Tensor, ddx: torch.Tensor,
                              live: Sequence[int], need_dcols: bool = True,
                              need_x: bool = True, need_table: bool = True,
                              level_frac: Optional[torch.Tensor] = None,
                              shard: Optional[Tuple[int, int]] = None) -> BwdBwd:
    """Plain PyTorch version of kernel GG, the backward of the input
    gradient given its cotangent ``ddx`` (B, D).  With w'_c = Σ_d
    ∂w_c/∂x_d · ddx_d per (level, corner, sample):
      d_dcols[l·F+k, b] = Σ_c w'_c · table[row_c, k];
      d_x[b, e] = Σ_{l,c,k} Σ_d ∂²w_c/∂x_d∂x_e · ddx_d · table[row_c, k] · dcols[l·F+k, b];
      d_flat[row_c·F + k] += w'_c · dcols[l·F+k, b], the ``index_add_`` of
      the updates (rows, g) (``gg_rows_and_g``) in fp32, cast once to
      ``flat``'s dtype.
    A (sample, level) that ``level_frac`` masks has zero weight derivatives
    (``build_indices_weights``), so it contributes nothing: zero d_dcols,
    nothing to d_x or d_flat.  With ``shard``, another rank's corner has
    zero weight derivatives, and d_flat has the shard's rows."""
    B, D = x.shape
    F, C, L = spec.n_features_per_level, 1 << spec.n_dims, len(live)
    dev = x.device
    n_rows = spec.n_entries // (shard[1] if shard else 1)
    d_dcols = (torch.zeros((spec.n_levels * F, B), dtype=torch.float32, device=dev)
               if need_dcols else None)
    d_x = torch.zeros((B, D), dtype=torch.float32, device=dev) if need_x else None
    acc = torch.zeros((n_rows, F), dtype=torch.float32, device=dev) if need_table else None
    if live and B:
        idx, _, dws, d2ws = grid_ops.build_indices_weights(spec, x, live, order=2,
                                                           level_frac=level_frac, shard=shard)
        v = ddx.float()
        wp = (dws * v[None]).sum(-1).reshape(L, C, B)               # w'_c
        dy = _live_dcols(spec, dcols, live).permute(0, 2, 1)[:, None]  # (L, 1, B, F)
        if need_dcols or need_x:
            feats = _corner_features(spec, flat, idx)                # (L, C, B, F)
        if need_dcols:
            live_rows = torch.tensor([l * F + f for l in live for f in range(F)], device=dev)
            dd = (wp[..., None] * feats).sum(1)                      # (L, B, F)
            d_dcols.index_copy_(0, live_rows, dd.permute(0, 2, 1).reshape(L * F, B))
        if need_x:
            val = (feats * dy).sum(-1)                               # (L, C, B)
            hv = (d2ws * v[None, :, :, None]).sum(-2).reshape(L, C, B, D)
            d_x = (hv * val[..., None]).sum((0, 1))
        if need_table:   # rows −1 (masked, another shard's) add their g = 0 to row 0
            rows, g = gg_rows_and_g(spec, x, dcols, ddx, live, level_frac, shard, (idx, dws))
            acc.index_add_(0, rows.clamp_min(0), g)
    return BwdBwd(d_dcols, d_x, acc.reshape(-1).to(flat.dtype) if need_table else None)


def gg_rows_and_g(spec: grid_ops.GridSpec, x: torch.Tensor, dcols: torch.Tensor,
                  ddx: torch.Tensor, live: Sequence[int],
                  level_frac: Optional[torch.Tensor] = None,
                  shard: Optional[Tuple[int, int]] = None,
                  built: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel GG's table-gradient updates as (rows, g): (L·C·B,) int32
    table rows and (L·C·B, F) fp32 g = w'_c · dcols[l·F:(l+1)·F, b], in
    (live level, corner, sample) order, w'_c = Σ_d ∂w_c/∂x_d · ddx_d.  A
    (sample, level) that ``level_frac`` masks has rows −1 (which kernel RS
    and its plain version skip) and g = 0; with ``shard``, so has another
    rank's corner.  Their scatter-add is GG's d_flat
    (``grid_encode_bwd_bwd_plain`` forms it so); kernel RS is checked and
    timed on them.  ``built``: ``build_indices_weights``'s (idx, dws) at
    order ≥ 1, where the caller has them."""
    L, C, (B, _) = len(live), 1 << spec.n_dims, x.shape
    F = spec.n_features_per_level
    if built is None:
        idx, _, dws = grid_ops.build_indices_weights(spec, x, live, order=1,
                                                     level_frac=level_frac, shard=shard)
    else:
        idx, dws = built
    wp = (dws * ddx.float()[None]).sum(-1).reshape(L, C, B)
    dy = _live_dcols(spec, dcols, live).permute(0, 2, 1)[:, None]   # (L, 1, B, F)
    rows = idx.reshape(L, C, B).to(torch.int32)
    if level_frac is not None:
        keep = grid_ops.level_mask(spec, live, level_frac)[:, None, :] > 0
        rows = torch.where(keep, rows, -1)
    return rows.reshape(-1), (wp[..., None] * dy).reshape(L * C * B, F)


def grid_encode_bwd_bwd(spec: grid_ops.GridSpec, flat: torch.Tensor, x: torch.Tensor,
                        dcols: torch.Tensor, ddx: torch.Tensor, live: Sequence[int],
                        need_dcols: bool = True, need_x: bool = True,
                        need_table: bool = True,
                        level_frac: Optional[torch.Tensor] = None,
                        shard: Optional[Tuple[int, int]] = None) -> BwdBwd:
    """Kernel GG: see ``grid_encode_bwd_bwd_plain``.  ``flat``, ``x``,
    ``dcols``, ``level_frac`` and ``shard`` as for ``grid_encode_bwd_input``;
    ``ddx`` (B, D) float32.  The kernel runs on ``gb_plan``'s items (GG's
    chunks) and adds the table gradient itself, in fp32 with atomics (not
    bit-reproducible, like GB's); d_dcols and d_x have the same bits from
    launch to launch."""
    if x.device.type == "cpu":
        return grid_encode_bwd_bwd_plain(spec, flat, x, dcols, ddx, live, need_dcols,
                                         need_x, need_table, level_frac, shard)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd_bwd: unsupported device {x.device}")
    name = "grid_encode_bwd_bwd"
    _check_args(name, spec, flat, x, shard)
    _check_dcols(name, spec, x, dcols)
    _check_frac(name, x, level_frac)
    B, D = x.shape
    if ddx.shape != (B, D):
        raise ValueError(f"{name}: ddx must be ({B}, {D}), got {tuple(ddx.shape)}")
    if B >= 2 ** 31:
        raise ValueError(f"{name}: {B} samples exceed the plan's int32 sample indices")
    ddx = ddx.float().contiguous()
    require_cuda_tensors(name, x, ddx)
    level_consts = _consts(spec, live, x.device, shard)
    items, groups = _gb_plan_on(spec, live, B, x.device, shard, gg_chunks(B))
    factors, hash_kind = _hash_args(spec)
    F, L, dev = spec.n_features_per_level, spec.n_levels, x.device
    # the kernel writes the live levels' rows of d_dcols only
    d_dcols = ((torch.zeros if len(set(live)) < L else torch.empty)(
        (L * F, B), dtype=torch.float32, device=dev) if need_dcols else None)
    d_x = torch.empty((B, D), dtype=torch.float32, device=dev) if need_x else None
    dx_part = torch.empty((L, B, D), dtype=torch.float32, device=dev) if need_x else None
    grad = (torch.empty(flat.numel(), dtype=torch.float32, device=dev) if need_table
            else None)
    out = grad if grad is None or flat.dtype == torch.float32 else torch.empty_like(flat)
    if B == 0:
        return BwdBwd(d_dcols, d_x, None if grad is None else grad.zero_().to(flat.dtype))
    kernels().grid_encode_bwd_bwd(x, _x_row_stride(x), level_frac, flat, dcols, ddx,
                                  level_consts, items, groups, d_dcols, dx_part, d_x, grad,
                                  out, D, F, dcols.stride(1), dcols.stride(0), factors,
                                  hash_kind, _INTERP_CODE[spec.interpolation],
                                  shard is not None)
    grid_encode_bwd_bwd.launches += 1
    return BwdBwd(d_dcols, d_x, out)


grid_encode_bwd_bwd.launches = 0


class Third(NamedTuple):
    """The outputs of kernel GT (or its plain version); None where not asked for."""
    d_dcols: Optional[torch.Tensor]   # (L·F, B) float32 SoA, zero rows for dead levels
    d_x: Optional[torch.Tensor]       # (B, D) float32
    d_flat: Optional[torch.Tensor]    # (n_entries·F,) table gradient, the table's dtype


def grid_encode_third_plain(spec: grid_ops.GridSpec, flat: torch.Tensor, x: torch.Tensor,
                            dcols: torch.Tensor, ddx: torch.Tensor, ct_dx: torch.Tensor,
                            live: Sequence[int], need_dcols: bool = True,
                            need_x: bool = True, need_table: bool = True,
                            level_frac: Optional[torch.Tensor] = None,
                            shard: Optional[Tuple[int, int]] = None) -> Third:
    """Plain PyTorch version of kernel GT: the blocks of GG's backward that
    no other kernel computes, the terms through GG's d_x = Σ_c ∇²w_c v
    ⟨T_c, δ⟩ (T the table, δ = ``dcols``, v = ``ddx``) given its cotangent
    β = ``ct_dx`` (B, D).  With u_c = βᵀ ∇²w_c v per (level, corner, sample):
      d_dcols[l·F+k, b] = Σ_c u_c · table[row_c, k];
      d_x[b, e] = Σ_{l,c} ∇³w_c[β, v, e] · Σ_k table[row_c, k] · dcols[l·F+k, b];
      d_flat[row_c·F + k] += u_c · dcols[l·F+k, b], summed in fp32
      (``index_add_``) and cast once to ``flat``'s dtype.
    ∇²w_c is symmetric, so GG's d_x at ddx = β is the v block, and GT has
    none.  The weights' derivatives come from ``build_indices_weights``
    (order 3: the third derivative of Smoothstep's f²(3 − 2f) is −12·scale³
    per dim, Linear's 0).  A (sample, level) that ``level_frac`` masks, and
    with ``shard`` another rank's corner, has zero weight derivatives and
    contributes nothing."""
    B, D = x.shape
    F, C, L = spec.n_features_per_level, 1 << spec.n_dims, len(live)
    dev = x.device
    n_rows = spec.n_entries // (shard[1] if shard else 1)
    d_dcols = (torch.zeros((spec.n_levels * F, B), dtype=torch.float32, device=dev)
               if need_dcols else None)
    d_x = torch.zeros((B, D), dtype=torch.float32, device=dev) if need_x else None
    acc = torch.zeros((n_rows, F), dtype=torch.float32, device=dev) if need_table else None
    if live and B:
        idx, _, _, d2ws, *d3ws = grid_ops.build_indices_weights(
            spec, x, live, order=3 if need_x else 2, level_frac=level_frac, shard=shard)
        v, beta = ddx.float(), ct_dx.float()
        u = torch.einsum("nbde,bd,be->nb", d2ws, beta, v).reshape(L, C, B)
        dy = _live_dcols(spec, dcols, live).permute(0, 2, 1)[:, None]   # (L, 1, B, F)
        if need_dcols or need_x:
            feats = _corner_features(spec, flat, idx)                   # (L, C, B, F)
        if need_dcols:
            live_rows = torch.tensor([l * F + f for l in live for f in range(F)], device=dev)
            dd = (u[..., None] * feats).sum(1)                          # (L, B, F)
            d_dcols.index_copy_(0, live_rows, dd.permute(0, 2, 1).reshape(L * F, B))
        if need_x:
            val = (feats * dy).sum(-1)                                  # (L, C, B)
            t3 = torch.einsum("nbdef,bd,be->nbf", d3ws[0], beta, v).reshape(L, C, B, D)
            d_x = (t3 * val[..., None]).sum((0, 1))
        if need_table:   # rows −1 (another shard's) add their u = 0 to row 0
            acc.index_add_(0, idx.reshape(-1).clamp_min(0), (u[..., None] * dy).reshape(-1, F))
    return Third(d_dcols, d_x, acc.reshape(-1).to(flat.dtype) if need_table else None)


def grid_encode_third(spec: grid_ops.GridSpec, flat: torch.Tensor, x: torch.Tensor,
                      dcols: torch.Tensor, ddx: torch.Tensor, ct_dx: torch.Tensor,
                      live: Sequence[int], need_dcols: bool = True, need_x: bool = True,
                      need_table: bool = True, level_frac: Optional[torch.Tensor] = None,
                      shard: Optional[Tuple[int, int]] = None) -> Third:
    """Kernel GT (``csrc/grid_encode_third.cu``): see
    ``grid_encode_third_plain``.  ``flat``, ``x``, ``dcols``, ``level_frac``
    and ``shard`` as for ``grid_encode_bwd_bwd``; ``ddx`` and ``ct_dx``
    (B, D) float32.  The kernel runs on ``gb_plan``'s items with GG's
    chunks, one (sample, level) a thread, and adds the table gradient
    itself, in fp32 in shared-memory windows and with atomics (not
    bit-reproducible, like GB's and GG's); d_dcols and d_x have the same
    bits from launch to launch (d_x: per-level partials summed in level
    order)."""
    if x.device.type == "cpu":
        return grid_encode_third_plain(spec, flat, x, dcols, ddx, ct_dx, live, need_dcols,
                                       need_x, need_table, level_frac, shard)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_third: unsupported device {x.device}")
    name = "grid_encode_third"
    _check_args(name, spec, flat, x, shard)
    _check_dcols(name, spec, x, dcols)
    _check_frac(name, x, level_frac)
    B, D = x.shape
    for what, t in (("ddx", ddx), ("ct_dx", ct_dx)):
        if t.shape != (B, D):
            raise ValueError(f"{name}: {what} must be ({B}, {D}), got {tuple(t.shape)}")
    ddx, ct_dx = ddx.float().contiguous(), ct_dx.float().contiguous()
    require_cuda_tensors(name, x, ddx, ct_dx)
    if B >= 2 ** 31:
        raise ValueError(f"{name}: {B} samples exceed the plan's int32 sample indices")
    level_consts = _consts(spec, live, x.device, shard)
    items, groups = _gb_plan_on(spec, live, B, x.device, shard, gg_chunks(B))
    factors, hash_kind = _hash_args(spec)
    F, L, dev = spec.n_features_per_level, spec.n_levels, x.device
    # the kernel writes the live levels' rows of d_dcols only
    d_dcols = ((torch.zeros if len(set(live)) < L else torch.empty)(
        (L * F, B), dtype=torch.float32, device=dev) if need_dcols else None)
    d_x = torch.empty((B, D), dtype=torch.float32, device=dev) if need_x else None
    dx_part = torch.empty((L, B, D), dtype=torch.float32, device=dev) if need_x else None
    grad = (torch.empty(flat.numel(), dtype=torch.float32, device=dev) if need_table
            else None)
    out = grad if grad is None or flat.dtype == torch.float32 else torch.empty_like(flat)
    if B == 0:
        return Third(d_dcols, d_x, None if grad is None else grad.zero_().to(flat.dtype))
    kernels().grid_encode_third(x, _x_row_stride(x), level_frac, flat, dcols, ddx, ct_dx,
                                level_consts, items, groups, d_dcols, dx_part, d_x, grad,
                                out, D, F, dcols.stride(1), dcols.stride(0), factors,
                                hash_kind, _INTERP_CODE[spec.interpolation], shard is not None)
    grid_encode_third.launches += 1
    return Third(d_dcols, d_x, out)


grid_encode_third.launches = 0

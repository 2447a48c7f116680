"""Multiresolution grid encoding: level geometry, index math, plain path.

PyTorch counterpart of ``tcnn_tpu/ops/grid_ops.py``.  The geometry
(``make_grid_spec`` and its helpers) is a copy of the JAX package's,
float32 math included.  ``build_indices_weights`` and
``interpolate_ref`` are the plain PyTorch form of the per-corner math;
they make up the plain versions of the grid-encode kernels
(``ops/cuda/grid_encode.py``), forward and backward, which
``grid_encode`` launches for CUDA tensors through ``GridEncodeFunction``.

uint32 arithmetic: the hashes and dense strides wrap at 32 bits
(common_device.h:678-707).  PyTorch has no full uint32 arithmetic, so
the plain path holds every uint32 value in int64 and masks to 32 bits
after each step; a product of two uint32 values would overflow int64,
so it is split into two 16-bit halves (``_mul_u32``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import (
    COHERENT_PRIME_HASH_FACTORS,
    GridType,
    HashType,
    InterpolationType,
    MAX_N_GRID_LEVELS,
    PRIME_HASH_FACTORS,
    REVERSED_PRIME_HASH_FACTORS,
    next_multiple,
)

_MAX_PARAMS = 2 ** 31  # uint32_max/2 cap (grid.h:696)
_U32 = 0xFFFFFFFF


def hash_factors(hash_type: HashType, n_dims: int) -> Tuple[int, ...]:
    """LCG hash factors (common_device.h:648-661)."""
    if hash_type == HashType.PRIME:
        f = PRIME_HASH_FACTORS
    elif hash_type == HashType.COHERENT_PRIME:
        f = COHERENT_PRIME_HASH_FACTORS
    elif hash_type == HashType.REVERSED_PRIME:
        f = REVERSED_PRIME_HASH_FACTORS
    else:
        raise ValueError(f"hash type {hash_type} has no LCG factors")
    if n_dims > len(f):
        raise ValueError(f"grid hash supports at most {len(f)} dims")
    return f[:n_dims]


def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a · b) mod 2^32 for int64 ``a`` in [0, 2^32) and a uint32
    constant ``b``: two 16-bit partial products keep every
    intermediate below 2^49, inside int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_coords(hash_type: HashType,
                 coords: Sequence[torch.Tensor]) -> torch.Tensor:
    """Spatial hash of per-dim uint32 coordinates held in int64
    (grid_hash, common_device.h:678-691)."""
    if hash_type == HashType.RNG:
        raise NotImplementedError(
            "the Rng (pcg32) grid hash is ported with the grid options of "
            "slice 4")
    if hash_type == HashType.COHERENT_ADD:
        # dim 0 ADDED after the XOR: hash(c0+1, rest) == hash(c0, rest)+1
        # (mod 2^32), so dim-0 corner pairs are table-adjacent.
        factors = hash_factors(HashType.COHERENT_PRIME, len(coords))
        h = torch.zeros_like(coords[0])
        for d in range(1, len(coords)):
            h = h ^ _mul_u32(coords[d], factors[d])
        return (h + coords[0]) & _U32
    factors = hash_factors(hash_type, len(coords))
    h = _mul_u32(coords[0], factors[0])
    for d in range(1, len(coords)):
        h = h ^ _mul_u32(coords[d], factors[d])
    return h


def grid_scale(level: int, log2_per_level_scale: float,
               base_resolution: int) -> float:
    """float32 math exactly as the reference's grid_scale
    (common_device.h:709-714: ``exp2f(level·log2_pls)·base − 1.0f``).
    float64 would put level 3 of config_hash at resolution 55, not 54."""
    s = np.float32(np.float32(level) * np.float32(log2_per_level_scale))
    return float(np.exp2(s) * np.float32(base_resolution) - np.float32(1.0))


def grid_resolution(scale: float) -> int:
    return int(np.ceil(np.float32(scale))) + 1


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Constants of one grid level."""
    scale: float
    resolution: int
    offset: int          # offset into the table, in feature-vector entries
    size: int            # number of feature-vector entries in this level
    use_hash: bool
    strides: Tuple[int, ...]       # per-dim stride (uint32 wrapped)
    stride_mask: Tuple[bool, ...]  # dim participates in dense index accumulation


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Description of a full multiresolution grid."""
    n_dims: int
    n_levels: int
    n_features_per_level: int
    grid_type: GridType
    hash_type: HashType
    interpolation: InterpolationType
    levels: Tuple[LevelSpec, ...]
    n_entries: int   # total feature-vector entries (table rows)
    stochastic_interpolation: bool = False

    @property
    def n_params(self) -> int:
        return self.n_entries * self.n_features_per_level

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level


def make_grid_spec(
    n_dims: int,
    n_levels: int,
    n_features_per_level: int,
    log2_hashmap_size: int,
    base_resolution: int,
    per_level_scale: float,
    grid_type: GridType = GridType.HASH,
    hash_type: HashType = HashType.COHERENT_PRIME,
    interpolation: InterpolationType = InterpolationType.LINEAR,
    stochastic_interpolation: bool = False,
) -> GridSpec:
    """Build the level/offset table (grid.h:686-731)."""
    if n_levels > MAX_N_GRID_LEVELS:
        raise ValueError(f"n_levels={n_levels} exceeds {MAX_N_GRID_LEVELS}")
    # f32 like the reference's std::log2(float) (grid.h:694, :784).
    log2_pls = float(np.log2(np.float32(per_level_scale)))
    levels: List[LevelSpec] = []
    offset = 0
    for l in range(n_levels):
        scale = grid_scale(l, log2_pls, base_resolution)
        res = grid_resolution(scale)

        params_in_level = next_multiple(min(res ** n_dims, _MAX_PARAMS), 8)
        if grid_type == GridType.TILED:
            params_in_level = min(params_in_level, base_resolution ** n_dims)
        elif grid_type == GridType.HASH:
            params_in_level = min(params_in_level, 1 << log2_hashmap_size)

        # Dense stride accumulation with the reference's early exit
        # (common_device.h:692-697), uint32 wraparound kept.
        strides = []
        mask = []
        stride = 1
        for _ in range(n_dims):
            participates = stride <= params_in_level
            strides.append(stride % (2 ** 32))
            mask.append(participates)
            if participates:
                stride = (stride * res) % (2 ** 32)
        use_hash = grid_type == GridType.HASH and params_in_level < stride
        levels.append(LevelSpec(
            scale=scale, resolution=res, offset=offset, size=params_in_level,
            use_hash=use_hash, strides=tuple(strides), stride_mask=tuple(mask)))
        offset += params_in_level

    return GridSpec(
        n_dims=n_dims, n_levels=n_levels,
        n_features_per_level=n_features_per_level,
        grid_type=grid_type, hash_type=hash_type, interpolation=interpolation,
        levels=tuple(levels), n_entries=offset,
        stochastic_interpolation=stochastic_interpolation)


def _corner_offsets(n_dims: int) -> np.ndarray:
    """(2^D, D) 0/1 corner offsets, corner c has bit d of c on dim d
    (the reference's ``idx & (1<<dim)`` convention, grid.h:125)."""
    n = 1 << n_dims
    out = np.zeros((n, n_dims), dtype=np.int64)
    for c in range(n):
        for d in range(n_dims):
            out[c, d] = (c >> d) & 1
    return out


def _interp_weight(f: torch.Tensor, interp: InterpolationType) -> torch.Tensor:
    """Cell-relative fraction → interpolation weight (common_device.h:801-811)."""
    if interp == InterpolationType.LINEAR:
        return f
    if interp == InterpolationType.SMOOTHSTEP:
        return f * f * (3.0 - 2.0 * f)
    if interp == InterpolationType.NEAREST:
        return (f > 0.5).to(f.dtype)
    raise ValueError(f"bad interpolation {interp}")


def live_levels(spec: GridSpec, max_level: Optional[int]) -> List[int]:
    """Levels below the static ``max_level`` cutoff (grid.h:69-92)."""
    return [li for li in range(spec.n_levels)
            if max_level is None or li < max_level]


def build_indices_weights(spec: GridSpec, x: torch.Tensor,
                          live: Sequence[int]):
    """Corner row indices and interpolation weights of the live levels.

    Same layout as the JAX package's ``_build_indices_weights``:
      idx: (L, C·B) int64 whole-table rows (level offsets folded in),
           corner-major within a level.
      ws:  (L·C, B) float32 corner weights, row l·C + c.
    """
    if spec.stochastic_interpolation:
        raise NotImplementedError(
            "stochastic interpolation is ported with the grid options of "
            "slice 4")
    B = x.shape[0]
    D = spec.n_dims
    C = 1 << D
    levels = [spec.levels[li] for li in live]
    L = len(levels)
    bits = _corner_offsets(D)
    scales = torch.tensor([lv.scale for lv in levels], dtype=torch.float32,
                          device=x.device).reshape(L, 1)

    cells, w1s = [], []
    for d in range(D):
        # Two roundings, like JAX's separate multiply and add: a fused
        # multiply-add would move samples near a cell border.
        pos = x[:, d].to(torch.float32)[None, :] * scales + 0.5
        cf = torch.floor(pos)
        # (uint32)(int)floorf: negatives wrap exactly like CUDA.
        cells.append(cf.to(torch.int64) & _U32)
        w1s.append(_interp_weight(pos - cf, spec.interpolation))

    ws = []
    for c in range(C):
        w = w1s[0] if bits[c, 0] else 1.0 - w1s[0]
        for d in range(1, D):
            w = w * (w1s[d] if bits[c, d] else 1.0 - w1s[d])
        ws.append(w)
    ws = torch.stack(ws, dim=1).reshape(L * C, B)

    rows = []
    for p, lv in enumerate(levels):
        corner_idx = []
        for c in range(C):
            coords = [(cells[d][p] + int(bits[c, d])) & _U32
                      for d in range(D)]
            if lv.use_hash:
                h = _hash_coords(spec.hash_type, coords)
            else:
                h = torch.zeros_like(coords[0])
                for d in range(D):
                    if lv.stride_mask[d]:
                        h = (h + _mul_u32(coords[d], lv.strides[d])) & _U32
            corner_idx.append(h % lv.size + lv.offset)
        rows.append(torch.stack(corner_idx, dim=0))   # (C, B)
    idx = torch.stack(rows, dim=0).reshape(L, C * B)
    return idx, ws


def interpolate_ref(flat: torch.Tensor, idx: torch.Tensor, ws: torch.Tensor,
                    n_features: int) -> torch.Tensor:
    """(L·F, B) float32 columns: Σ_c ws[l·C+c, b] · table[idx[l, c·B+b], f]."""
    L = idx.shape[0]
    B = ws.shape[1]
    C = ws.shape[0] // L
    table2d = flat.reshape(-1, n_features)
    feats = table2d[idx.reshape(-1)].to(torch.float32)
    feats = feats.reshape(L, C, B, n_features)
    cols = (feats * ws.reshape(L, C, B, 1)).sum(dim=1)     # (L, B, F)
    return cols.permute(0, 2, 1).reshape(L * n_features, B)


LEVEL_FIELDS = 12


def level_params(spec: GridSpec, live: Sequence[int]) -> np.ndarray:
    """Per-level constants of the grid-encode kernel, (L, 12) int32:
    scale (float32 bits), size, offset, use_hash, live, stride-mask bits,
    four uint32 strides (bit patterns), and the 64-bit multiplier of
    ``h % size`` without a division, floor((2^64 − 1) / size) + 1
    (Lemire, Kaser & Kurz, 2019), as low and high words.  Dead levels (at
    or above ``max_level``) keep their row and are written as zeros."""
    if spec.n_dims > 4:
        raise ValueError(
            f"the grid-encode kernel covers at most 4 dims, got {spec.n_dims}")
    out = np.zeros((spec.n_levels, LEVEL_FIELDS), np.uint32)
    live = set(live)
    for l, lv in enumerate(spec.levels):
        magic = ((2 ** 64 - 1) // lv.size + 1) % 2 ** 64
        out[l, 0] = np.float32(lv.scale).view(np.uint32)
        out[l, 1] = lv.size
        out[l, 2] = lv.offset
        out[l, 3] = int(lv.use_hash)
        out[l, 4] = int(l in live)
        out[l, 5] = sum(1 << d for d, m in enumerate(lv.stride_mask) if m)
        out[l, 6:6 + spec.n_dims] = lv.strides
        out[l, 10] = magic & 0xFFFFFFFF
        out[l, 11] = magic >> 32
    return out.view(np.int32)


def check_table_size(spec: GridSpec, flat: torch.Tensor) -> None:
    if flat.numel() != spec.n_params:
        # A wrong-size table (a stale checkpoint after a spec change) would
        # read out of range in the kernel, where jnp.take clamps.
        raise ValueError(
            f"table has {flat.numel()} elements but the grid spec needs "
            f"{spec.n_params} ({spec.n_entries} rows × "
            f"{spec.n_features_per_level} features)")


class GridEncodeFunction(torch.autograd.Function):
    """The grid encoding with its table gradient, the counterpart of
    ``_grid_interpolate``'s custom VJP (``tcnn_tpu/ops/grid_ops.py:917-1122``).

    Forward: kernel G (CUDA) or its plain version (CPU).  It saves ``x``
    and the table, not the (L·C, B) corner indices: the backward
    recomputes them, as the forward kernel does.  Backward: kernel GB or
    its plain version, which accumulate in fp32 and return the gradient in
    the table's dtype, cast once (grid_ops.py:1099-1102).  Autograd's
    backward of ``GridEncoding``'s ``table.to(bfloat16)`` then brings a
    bf16 gradient to the fp32 master, as in JAX; autograd would instead
    scatter-add the bf16 gradient of ``table2d[idx]`` in bf16.  Dead
    levels (static ``max_level``) get zero gradient.  Input gradients
    (JAX's ``dws``) and second derivatives arrive with slice 4.
    """

    @staticmethod
    def forward(ctx, flat, x, spec, live, soa):
        from .cuda.grid_encode import grid_encode_fwd

        ctx.spec, ctx.live, ctx.soa = spec, live, soa
        ctx.save_for_backward(flat, x)
        return grid_encode_fwd(spec, flat, x, live, soa=soa)

    @staticmethod
    def backward(ctx, dout):
        from .cuda.grid_encode import grid_encode_bwd

        if torch.is_grad_enabled():
            raise NotImplementedError(
                "second derivatives of the grid encoding "
                "(backward_backward_input) are ported in slice 4")
        flat, x = ctx.saved_tensors
        dflat = None
        if ctx.needs_input_grad[0]:
            dcols = dout if ctx.soa else dout.t()
            dflat = grid_encode_bwd(ctx.spec, flat, x, dcols, ctx.live)
        return dflat, None, None, None, None


def grid_encode(spec: GridSpec, table: torch.Tensor, x: torch.Tensor,
                max_level: Optional[int] = None, soa: bool = False) -> torch.Tensor:
    """Forward grid encoding (``tcnn_tpu/ops/grid_ops.py:1125-1297``).

    table: flat (n_entries·F,) or (n_entries, F), float32 or bfloat16.
    x: (B, D) coordinates.  Levels at or above the static ``max_level``
    emit zeros.  Returns (B, L·F) features, or (L·F, B) with ``soa``,
    in the table's dtype (JAX casts the columns to ``table.dtype``).

    A CUDA tensor goes through the grid-encode kernels, forward and
    backward; a CPU tensor through their plain versions.  The table
    gradient is ported; an input gradient (``x.requires_grad``) raises.
    """
    if x.ndim != 2 or x.shape[1] != spec.n_dims:
        raise ValueError(f"expected (B, {spec.n_dims}) input, got {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "input gradients of the grid encoding (JAX's dws) are ported "
            "in slice 4")
    flat = table.reshape(-1)
    check_table_size(spec, flat)
    return GridEncodeFunction.apply(flat, x, spec,
                                    tuple(live_levels(spec, max_level)), soa)
